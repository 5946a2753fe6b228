"""PNG decode and encode on ``zlib`` and numpy: the port's stand-in for the
PIL calls of the JAX package's ``data/io.py`` (the card's machine has no
PIL).

Decode takes non-interlaced greyscale (colour type 0), RGB (2), palette
(3, 8-bit), grey + alpha (4) and RGBA (6) at 8 or 16 bits a sample, with
all five row filters, which :func:`.native.unfilter` undoes in C
(:func:`_unfilter` is its plain version: None, Sub and Up vectorised over
a row, Average and Paeth a loop over its bytes). Anything else (Adam7
interlacing, 1/2/4-bit samples, a broken chunk) raises. :meth:`PNG.array`
and :meth:`PNG.rgb` give what ``np.asarray(Image.open(path))`` and
``Image.open(path).convert("RGB")`` give with PIL; they are the plain
versions of :mod:`.native`'s sample conversions, which :mod:`.io` reads
with. Encode writes 8-bit RGB and 8- or 16-bit greyscale, every row with
filter 0.
"""
from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass

import numpy as np

from . import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_NAMES = {0: "greyscale", 2: "RGB", 3: "palette", 4: "grey+alpha", 6: "RGBA"}


@dataclass
class PNG:
    """A decoded image: ``samples`` (H, W) for one channel, else (H, W, C),
    uint8 or uint16 as stored (palette indices for colour type 3);
    ``palette`` (N, 3) uint8 for colour type 3, else None."""

    samples: np.ndarray
    color_type: int
    bit_depth: int
    palette: np.ndarray | None = None

    def array(self) -> np.ndarray:
        """PIL's array of the file: 16-bit greyscale as uint16, every other
        16-bit type cut to its samples' high bytes (PIL's 8-bit modes;
        16-bit grey + alpha opens as RGBA, the grey replicated)."""
        if self.bit_depth == 8 or self.color_type == 0:
            return self.samples
        s = (self.samples >> 8).astype(np.uint8)
        return s[:, :, [0, 0, 0, 1]] if self.color_type == 4 else s

    def rgb(self) -> np.ndarray:
        """(H, W, 3) uint8, PIL's ``convert("RGB")``: grey replicated
        (16-bit grey clipped to 255), alpha dropped, palette looked up."""
        s = self.array()
        if self.color_type == 3:
            lut = np.zeros((256, 3), np.uint8)
            lut[: len(self.palette)] = self.palette[:256]
            return lut[s]
        if self.color_type == 0:
            s = np.minimum(s, 255).astype(np.uint8)
            return np.repeat(s[:, :, None], 3, axis=2)
        if self.color_type == 4:
            return np.repeat(s[:, :, :1], 3, axis=2)
        return np.ascontiguousarray(s[:, :, :3])


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if len(body) != n or zlib.crc32(tag + body) != crc:
            raise ValueError(f"broken PNG chunk {tag!r} at byte {pos}")
        yield tag, body
        if tag == b"IEND":
            return
        pos += 12 + n
    raise ValueError("truncated PNG file (no IEND chunk)")


def _average(f: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    out, up = bytearray(f.tobytes()), prev.tobytes()
    for i in range(bpp):
        out[i] = (out[i] + (up[i] >> 1)) & 255
    for i in range(bpp, len(out)):
        out[i] = (out[i] + ((out[i - bpp] + up[i]) >> 1)) & 255
    return np.frombuffer(out, np.uint8)


def _paeth(f: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    out, up = bytearray(f.tobytes()), prev.tobytes()
    for i in range(bpp):  # a = c = 0: the predictor is b
        out[i] = (out[i] + up[i]) & 255
    for i in range(bpp, len(out)):
        a, b, c = out[i - bpp], up[i], up[i - bpp]
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - c - c)
        out[i] = (out[i] + (a if pa <= pb and pa <= pc else b if pb <= pc else c)) & 255
    return np.frombuffer(out, np.uint8)


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """(height, stride) uint8 rows from the decompressed stream (each row
    a filter byte, then ``stride`` filtered bytes)."""
    rows = raw.reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, f = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = f
        elif kind == 1:  # uint8 sums wrap modulo 256, as the filter does
            cur = np.cumsum(f.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = f + prev
        elif kind == 3:
            cur = _average(f, prev, bpp)
        elif kind == 4:
            cur = _paeth(f, prev, bpp)
        else:
            raise ValueError(f"PNG row {y} has filter type {kind} (0-4 exist)")
        out[y] = cur
        prev = out[y]
    return out


def parse(data: bytes):
    """``(width, height, bit depth, colour type, palette, rows)`` of a PNG
    file's bytes: ``rows`` the unfiltered (height, width * bytes a pixel)
    uint8 image data, 16-bit samples big-endian as stored."""
    header, palette, idat = None, None, []
    for tag, body in _chunks(data):
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, ctype, compression, filter_method, interlace = header
    if interlace:
        raise ValueError("interlaced (Adam7) PNG: only non-interlaced files are read")
    if ctype not in CHANNELS or depth not in (8, 16) or (ctype == 3 and depth != 8):
        raise ValueError(f"PNG colour type {ctype} ({_NAMES.get(ctype, 'unknown')}) at bit depth "
                         f"{depth}: only 8/16-bit grey, RGB, grey+alpha, RGBA and 8-bit palette are read")
    if compression or filter_method:
        raise ValueError(f"PNG compression method {compression} / filter method {filter_method}")
    if ctype == 3 and palette is None:
        raise ValueError("palette PNG without PLTE")
    channels = CHANNELS[ctype]
    bpp = channels * depth // 8
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return width, height, depth, ctype, palette, native.unfilter(raw, height, stride, bpp)


def decode(data: bytes) -> PNG:
    width, height, depth, ctype, palette, rows = parse(data)
    channels = CHANNELS[ctype]
    samples = rows.view(">u2").astype(np.uint16) if depth == 16 else rows
    shape = (height, width) if channels == 1 else (height, width, channels)
    return PNG(samples.reshape(shape), ctype, depth, palette)


def read(path: str | os.PathLike) -> PNG:
    with open(path, "rb") as f:
        return decode(f.read())


def chunk(tag: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))


def encode(array: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> 8-bit RGB; (H, W) uint8 / uint16 -> 8- / 16-bit
    greyscale."""
    a = np.asarray(array)
    if a.dtype == np.uint8 and a.ndim == 3 and a.shape[2] == 3:
        ctype, depth = 2, 8
    elif a.dtype in (np.uint8, np.uint16) and a.ndim == 2:
        ctype, depth = 0, 8 * a.dtype.itemsize
    else:
        raise ValueError(f"encode takes (H, W, 3) uint8 or (H, W) uint8/uint16, not {a.shape} {a.dtype}")
    h, w = a.shape[:2]
    rows = np.ascontiguousarray(a.astype(a.dtype.newbyteorder(">"))).view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    return (SIGNATURE + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + chunk(b"IEND", b""))


def write(path: str | os.PathLike, array: np.ndarray) -> None:
    data = encode(array)
    with open(path, "wb") as f:
        f.write(data)
