"""The port's host data path in C (``nconv_tpu_torch/data/native.py``,
``csrc/host/depthio.cpp``) on the CPU: the row unfilter bitwise the plain
numpy one of ``data/png.py`` for every filter, bit depth and channel count;
every reader bitwise the plain decode of ``data/png.py`` (``PNG.rgb``,
``PNG.array``) and the JAX package's ``nconv_tpu.data.native`` on the same
files, and the one that ``io``, the datasets' crop and the mask pool run;
the depth and COO encoders bitwise ``runtime/wires.py``, and so is the
two-stream dense frame encoder in row bands on the library's threads (its
thread count from the CPU affinity; a process exits after its pool ran);
the YUV encoders bitwise the JAX package's C encoders and within one step
of ``wires.py``; a failed build raises. No host timing is asserted."""
import fcntl
import zlib
from pathlib import Path

import numpy as np
import pytest

from nconv_tpu.data import native as jnative
from nconv_tpu_torch.data import io, native, png
from nconv_tpu_torch.runtime import wires
from test_torch_data import write_filtered


@pytest.fixture(scope="module", autouse=True)
def jax_native_library():
    """The JAX package's C library, built and loaded afresh in this process
    under an exclusive lock on ``build/libdepthio.lock``.

    ``nconv_tpu.data.native`` runs ``make`` straight into the library's path,
    and ``tests/test_native.py`` loads it while it is collected. Under
    pytest-xdist every worker collects at once, so a worker can load the file
    while another's linker is still writing it ("file too short"), and its
    loader then stays failed for the session and falls back to other
    readers. The loader's state is reset here, so this module compares with
    the C library whatever happened during collection."""
    lock = Path(__file__).resolve().parents[1] / "build" / "libdepthio.lock"
    lock.parent.mkdir(exist_ok=True)
    with pytest.MonkeyPatch.context() as mp, open(lock, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        mp.setattr(jnative, "_lib", None)
        mp.setattr(jnative, "_build_failed", False)
        jnative.available()
        fcntl.flock(f, fcntl.LOCK_UN)
        yield


def filtered_stream(rng, height, stride, kinds):
    """A decompressed PNG stream: each row a filter byte from ``kinds``,
    then ``stride`` random bytes (every byte string unfilters)."""
    rows = rng.integers(0, 256, (height, stride + 1), dtype=np.uint8)
    rows[:, 0] = [kinds[y % len(kinds)] for y in range(height)]
    return rows.reshape(-1)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_unfilter_is_bitwise_the_plain_one(kind, bits, channels):
    rng = np.random.default_rng(kind * 100 + bits + channels)
    bpp = channels * bits // 8
    height, width = 7, 9
    for kinds in ([kind], [kind, (kind + 1) % 5, (kind + 3) % 5]):  # the filter alone, then after others
        raw = filtered_stream(rng, height, width * bpp, kinds)
        got = native.unfilter(raw, height, width * bpp, bpp)
        np.testing.assert_array_equal(got, png._unfilter(raw, height, width * bpp, bpp))


def test_unfilter_raises_on_an_unknown_filter_as_the_plain_one():
    raw = filtered_stream(np.random.default_rng(0), 4, 6, [1, 4, 5])
    with pytest.raises(ValueError, match="PNG row 2 has filter type 5"):
        native.unfilter(raw, 4, 6, 3)
    with pytest.raises(ValueError, match="PNG row 2 has filter type 5"):
        png._unfilter(raw, 4, 6, 3)


def test_png_decode_runs_the_c_unfilter(monkeypatch):
    rng = np.random.default_rng(1)
    a = rng.integers(0, 256, (11, 13, 3)).astype(np.uint8)
    data = write_filtered(a, 2, 8)
    calls = []
    monkeypatch.setattr(native, "unfilter", lambda *args: calls.append(args) or png._unfilter(*args))
    np.testing.assert_array_equal(png.decode(data).samples, a)
    assert len(calls) == 1


IMAGES = [  # (colour type, bits): what the readers take
    (0, 8), (0, 16), (2, 8), (2, 16), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


def image_file(tmp_path, ctype, bits, h=13, w=17):
    rng = np.random.default_rng(ctype * 10 + bits)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    shape = (h, w) if ch == 1 else (h, w, ch)
    a = rng.integers(0, 1 << bits, shape).astype(np.uint8 if bits == 8 else np.uint16)
    palette = rng.integers(0, 256, (200, 3)).astype(np.uint8) if ctype == 3 else None
    path = tmp_path / f"c{ctype}_{bits}.png"
    path.write_bytes(write_filtered(a, ctype, bits, palette))
    return str(path), a


def plain_rgb(path, bgr):
    """The plain reader: ``png.decode``'s samples through ``PNG.rgb``."""
    arr = png.read(path).rgb().astype(np.float32)
    return np.ascontiguousarray(arr[:, :, ::-1] if bgr else arr)


def plain_depth(path, scale=256.0):
    """The plain depth reader: sample x (1 / scale) in float32, as the JAX
    package's C reader scales (at 256, the exact /256 of ``io``)."""
    return png.read(path).array().astype(np.float32) * (np.float32(1) / np.float32(scale))


@pytest.mark.parametrize("ctype,bits", IMAGES)
@pytest.mark.parametrize("bgr", [True, False])
def test_rgb_readers_are_bitwise_io_and_the_jax_readers(tmp_path, ctype, bits, bgr):
    """``io.load_rgb`` (the C reader) against the plain decode on every
    type (PIL's conversion: 16-bit grey clipped to 255); against the JAX
    package's reader (libpng, which cuts 16-bit grey to its high byte) on
    the rest."""
    path, _ = image_file(tmp_path, ctype, bits)
    got = io.load_rgb(path, bgr=bgr)
    assert got.dtype == np.float32 and got.shape == (13, 17, 3) and got.flags.c_contiguous
    np.testing.assert_array_equal(got, plain_rgb(path, bgr))
    if (ctype, bits) != (0, 16) and (ctype, bits) != (4, 16):
        np.testing.assert_array_equal(got, jnative.load_rgb(path, bgr=bgr))


@pytest.mark.parametrize("bits", [8, 16])
def test_depth_readers_are_bitwise_io_and_the_jax_readers(tmp_path, bits):
    path, a = image_file(tmp_path, 0, bits)
    got = io.load_depth_png16(path)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, plain_depth(path))
    np.testing.assert_array_equal(got, jnative.load_depth_png16(path))
    np.testing.assert_array_equal(native.load_depth_png16(path, 1000.0), plain_depth(path, 1000.0))
    np.testing.assert_array_equal(native.load_depth_png16(path, 1000.0), jnative.load_depth_png16(path, 1000.0))


def test_depth_readers_refuse_colour_files(tmp_path):
    path, _ = image_file(tmp_path, 2, 8)
    with pytest.raises(ValueError, match="greyscale"):
        native.load_depth_png16(path)


def test_readers_on_a_kitti_size_file_written_by_the_port(tmp_path):
    rng = np.random.default_rng(2)
    d = (rng.random((352, 1216)) * 80 * (rng.random((352, 1216)) < 0.06)).astype(np.float32)
    path = str(tmp_path / "d.png")
    io.save_depth_png16(path, d)
    got = io.load_depth_png16(path)
    np.testing.assert_array_equal(got, plain_depth(path))
    np.testing.assert_array_equal(got, jnative.load_depth_png16(path))
    np.testing.assert_array_equal(io.load_validity_map_png16(path), (plain_depth(path) > 0).astype(np.float32))


def test_io_the_crop_and_the_mask_pool_run_the_c_readers(tmp_path, monkeypatch):
    """The main path's readers are the C ones: each ``io`` reader, the
    datasets' crop and the mask pool call :mod:`native` once a use."""
    from nconv_tpu_torch.data import crop_top_center, sparsify

    calls = []
    for name in ("load_rgb", "load_depth_png16", "crop_top_center", "apply_mask"):
        fn = getattr(native, name)
        monkeypatch.setattr(native, name, lambda *a, _fn=fn, _n=name, **kw: calls.append(_n) or _fn(*a, **kw))
    rgb_path, _ = image_file(tmp_path, 2, 8)
    depth_path, _ = image_file(tmp_path, 0, 16)
    np.testing.assert_array_equal(io.load_rgb(rgb_path), plain_rgb(rgb_path, True))
    np.testing.assert_array_equal(io.load_depth_png16(depth_path), plain_depth(depth_path))
    io.load_validity_map_png16(depth_path)
    a = np.random.default_rng(7).random((13, 17)).astype(np.float32)
    (c,), _ = crop_top_center([a], np.eye(3, dtype=np.float32), 9, 12)
    np.testing.assert_array_equal(c, a[4:, 2:14])
    m = (np.random.default_rng(8).random((13, 17)) < 0.5).astype(np.uint8)
    np.testing.assert_array_equal(sparsify.apply_mask_pool(a, [m], np.random.default_rng(0)), a * m)
    assert calls == ["load_rgb", "load_depth_png16", "load_depth_png16", "crop_top_center", "apply_mask"]


@pytest.mark.parametrize("shape", [(20, 30), (20, 30, 3)])
def test_crop_and_mask_are_bitwise_the_jax_natives(shape):
    rng = np.random.default_rng(3)
    a = rng.random(shape).astype(np.float32)
    np.testing.assert_array_equal(native.crop_top_center(a, 12, 21), jnative.crop_top_center(a, 12, 21))
    np.testing.assert_array_equal(native.crop_top_center(a, 12, 21), a[8:, 4:25])
    with pytest.raises(ValueError, match="crop"):
        native.crop_top_center(a, 21, 30)
    d = rng.random(shape[:2]).astype(np.float32)
    m = (rng.random(shape[:2]) < 0.5).astype(np.float32)
    before = d.copy()
    got = native.apply_mask(d, m)
    np.testing.assert_array_equal(d, before)  # the caller's array is not written
    np.testing.assert_array_equal(got, jnative.apply_mask(before, m))
    np.testing.assert_array_equal(got, before * m)


EDGES = np.array([-1.0, 0.0, -0.0, 255.99, 256.0, 1e6, 1e-9], np.float32)


def depth_map(seed, h=32, w=48):
    rng = np.random.default_rng(seed)
    d = (rng.random((h, w)) * 300 * (rng.random((h, w)) < 0.3)).astype(np.float32)
    d.ravel()[: EDGES.size] = EDGES
    return d


@pytest.mark.parametrize("scale", [256.0, 100.0])
def test_depth_wire_encoder_is_bitwise_the_plain_one(scale):
    d = depth_map(4)[None, :, :, None]
    out = np.full(d.shape, 7, np.uint16)
    assert native.encode_depth_wire(d, scale, out=out) is out
    np.testing.assert_array_equal(out, wires.encode_depth_wire(d, scale))
    np.testing.assert_array_equal(out.reshape(d.shape[1:3]), jnative.encode_depth_wire(d[0, :, :, 0], scale))
    with pytest.raises(ValueError, match="out"):
        native.encode_depth_wire(d, scale, out=np.empty(d.shape, np.int32))


def dense_slot(h, w):
    """A staging slot's byte buffer of the engine's dense uint8 RGB and
    uint16 depth wires, its four arrays at the offsets ``_Layout`` gives
    them, in the order ``encode_frame_dense`` takes them."""
    from nconv_tpu_torch.runtime.streaming import _Layout

    layout = _Layout([("rgb", (1, h, w, 3), np.uint8), ("depth", (1, h, w, 1), np.uint16)])
    buf = np.full(layout.nbytes, 0xAB, np.uint8)
    views = layout.numpy_views(buf)
    return buf, tuple(views[(s, n)] for s in (0, 1) for n in ("rgb", "depth")), layout


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("bands", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("h,w", [(37, 53), (1, 7), (5, 1216)])
def test_frame_encoder_is_bitwise_the_per_stream_encoders(h, w, bands, threads):
    """``encode_frame_dense`` in row bands that do not divide the height
    (more bands than rows included), on one thread and on four, into a
    slot at the engine's offsets: bitwise ``encode_depth_wire`` plus the
    plain RGB copy, and ``wires.py``'s forms; nothing else of the slot
    written."""
    rng = np.random.default_rng(h * 100 + w + bands)
    rgb = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(2)]
    depth = []
    for s in range(2):  # below 0, zero, above 65535 / 256 and random, no NaN
        d = ((rng.random((h, w)) * 400 - 50) * (rng.random((h, w)) < 0.7)).astype(np.float32)
        d.ravel()[: min(d.size, EDGES.size)] = EDGES[: d.size]
        depth.append(d)
    buf, out, layout = dense_slot(h, w)
    assert native.encode_frame_dense(rgb[0], depth[0], rgb[1], depth[1], out, threads=threads, bands=bands) is out
    _, plain, _ = dense_slot(h, w)
    wires.encode_frame_dense(rgb[0], depth[0], rgb[1], depth[1], plain)
    for s in (0, 1):
        np.testing.assert_array_equal(out[2 * s][0], rgb[s])
        np.testing.assert_array_equal(out[2 * s + 1], native.encode_depth_wire(depth[s][None, :, :, None]))
        np.testing.assert_array_equal(out[2 * s + 1], wires.encode_depth_wire(depth[s][None, :, :, None]))
        np.testing.assert_array_equal(out[2 * s], plain[2 * s])
        np.testing.assert_array_equal(out[2 * s + 1], plain[2 * s + 1])
    written = np.zeros(layout.nbytes, bool)
    for off, shape, dt in layout.fields.values():
        written[off:off + int(np.prod(shape)) * dt.itemsize] = True
    assert (buf[~written] == 0xAB).all()  # the alignment padding is left alone


def test_frame_encoder_refuses_what_it_cannot_take():
    _, out, _ = dense_slot(4, 6)
    rgb, d = np.zeros((4, 6, 3), np.uint8), np.zeros((4, 6), np.float32)
    with pytest.raises(ValueError, match="bands"):
        native.encode_frame_dense(rgb, d, rgb, d, out, bands=0)
    with pytest.raises(ValueError, match="threads"):
        native.encode_frame_dense(rgb, d, rgb, d, out, threads=0)
    with pytest.raises(ValueError, match="depth"):
        native.encode_frame_dense(rgb, d[:3], rgb, d, out)
    with pytest.raises(ValueError, match="rgb"):
        native.encode_frame_dense(rgb.astype(np.float32), d, rgb, d, out)
    with pytest.raises(ValueError, match="out"):
        native.encode_frame_dense(rgb, d, rgb, d, out[:3] + (np.zeros((1, 4, 6, 1), np.int32),))


def test_the_interpreter_exits_after_the_pool_ran():
    """The pool's workers are parked, never joined: a process whose pool
    ran a frame exits at once."""
    import subprocess
    import sys

    code = ("import numpy as np; from nconv_tpu_torch.data import native; "
            "o = tuple(np.empty(s, t) for s, t in (((1, 4, 6, 3), np.uint8), ((1, 4, 6, 1), np.uint16)) * 2); "
            "r, d = np.ones((4, 6, 3), np.uint8), np.ones((4, 6), np.float32); "
            "native.encode_frame_dense(r, d, r, d, o, threads=4, bands=4); print(int(o[3].max()))")
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.split() == ["256"], proc.stderr


@pytest.mark.parametrize("cpus,threads", [(1, 1), (2, 1), (3, 2), (4, 3), (5, 4), (8, 4), (64, 4)])
def test_frame_encoder_threads_follow_the_cpu_affinity(monkeypatch, cpus, threads):
    monkeypatch.setattr(native.os, "sched_getaffinity", lambda pid: set(range(cpus)))
    assert native.encode_threads() == threads


@pytest.mark.parametrize("capacity", [1024, 100])  # roomy and overflowing
def test_coo_encoder_is_bitwise_the_plain_one(capacity):
    d = depth_map(5)
    out = (np.full((1, capacity), 7, np.int32), np.full((1, capacity), 7, np.uint16))
    idx, val, n = native.encode_depth_coo(d, capacity, out=out)
    assert idx is out[0] and val is out[1]
    widx, wval, wn = wires.encode_depth_coo(d, capacity)
    assert n == wn == int(np.count_nonzero(d))
    np.testing.assert_array_equal(idx, widx)
    np.testing.assert_array_equal(val, wval)


@pytest.mark.parametrize("name", ["yuv420", "yuv422"])
def test_yuv_encoders_are_the_jax_c_encoders_and_one_step_from_the_plain_ones(name):
    rng = np.random.default_rng(6)
    rgb = (rng.random((32, 48, 3)) * 256).astype(np.uint8)
    rgb[0, :6] = [[0, 0, 0], [255, 255, 255], [255, 0, 0], [0, 255, 0], [0, 0, 255], [1, 254, 128]]
    out = tuple(np.empty_like(p) for p in getattr(wires, "encode_" + name)(rgb))
    got = getattr(native, "encode_" + name)(rgb, out=out)
    assert all(a is b for a, b in zip(got, out))
    assert jnative.available()
    for a, b in zip(got, getattr(jnative, "encode_" + name)(rgb)):  # the JAX package's C encoder
        np.testing.assert_array_equal(a, b)
    plain = getattr(wires, "encode_" + name)(rgb)
    steps = [np.abs(a.astype(np.int32) - b).max() for a, b in zip(got, plain)]
    assert max(steps) <= 1 and any(np.any(a != b) for a, b in zip(got, plain))


def test_yuv_encoders_refuse_odd_sizes():
    with pytest.raises(ValueError, match="even"):
        native.encode_yuv420(np.zeros((5, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="even"):
        native.encode_yuv422(np.zeros((4, 7, 3), np.uint8))


def test_a_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="host compiler"):
        native.lib()
    data = write_filtered(np.zeros((4, 4), np.uint8), 0, 8)
    with pytest.raises(RuntimeError, match="host compiler"):
        png.decode(data)
    with pytest.raises(RuntimeError, match="host compiler"):
        native.encode_yuv420(np.zeros((4, 4, 3), np.uint8))
    monkeypatch.setenv("CXX", "false")  # a compiler that fails
    with pytest.raises(RuntimeError, match="failed"):
        native.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_the_library_is_named_by_its_source(tmp_path, monkeypatch):
    so = native.build()
    assert so.name == f"libnct_depthio_{native._digest()}.so" and so.parent == native.BUILD_DIR
    src = tmp_path / "depthio.cpp"
    src.write_bytes(native.SOURCE.read_bytes() + b"\n// edited\n")
    monkeypatch.setattr(native, "SOURCE", src)
    assert native._digest() not in so.name


def test_zlib_stays_in_python():
    """The library links no libpng and no zlib."""
    import subprocess

    out = subprocess.run(["ldd", str(native.build())], capture_output=True, text=True).stdout
    assert "libpng" not in out and "libz" not in out
    assert zlib.decompress(zlib.compress(b"x")) == b"x"
