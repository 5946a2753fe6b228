"""A minimal ONNX executor, numpy only, for the deployment artifact.

The reference's artifact is consumed by an ONNX Runtime session on the
robot; neither ``onnx`` nor ``onnxruntime`` need be installed here, so this
module runs the serialized ModelProto bytes itself: a protobuf wire-format
walker over the stable field numbers of ``onnx.proto``, and eager numpy
forms (NCHW) of every op that the port's exporter
(:mod:`.onnx_export`) and the JAX package's emit:

  Add, BatchNormalization, Cast, Concat, Constant, ConstantOfShape, Conv,
  ConvTranspose, Div, Equal, Expand, Floor, Gather, Greater, Identity, Less,
  Max, MaxPool, Min, Mul, Neg, Not, Pad, Range, Reciprocal, ReduceSum, Relu,
  Reshape, Resize, Shape, Slice, Split, Sqrt, Squeeze, Sub, Transpose,
  Unsqueeze, Where.

It is a validation interpreter (eager, unoptimized); deployment targets
ONNX Runtime.
"""
from __future__ import annotations

import functools
from collections import Counter

import numpy as np

__all__ = ["OnnxGraph", "load_onnx_graph", "run_onnx"]

# TensorProto.DataType -> numpy
_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 6: np.int32, 7: np.int64,
    9: np.bool_, 10: np.float16, 11: np.float64, 12: np.uint32, 13: np.uint64,
}


# ---------------------------------------------------------------------------
# Protobuf wire format
# ---------------------------------------------------------------------------

def _varint(buf: memoryview, i: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def _iter_fields(buf: memoryview):
    """Yield (field_number, wire_type, value) over one protobuf message:
    wire type 0 varint (an int), 2 length-delimited (a memoryview), 5 / 1
    fixed32 / fixed64 (raw bytes)."""
    i, n = 0, len(buf)
    while i < n:
        tag, i = _varint(buf, i)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, i = _varint(buf, i)
        elif wire == 2:
            ln, i = _varint(buf, i)
            val = buf[i:i + ln]
            i += ln
        elif wire == 5:
            val = bytes(buf[i:i + 4])
            i += 4
        elif wire == 1:
            val = bytes(buf[i:i + 8])
            i += 8
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, val


def _signed(v: int) -> int:
    # int64 varints arrive as 2^64 complements
    return v - (1 << 64) if v >= 1 << 63 else v


def _packed_varints(val) -> list[int]:
    out, i = [], 0
    while i < len(val):
        v, i = _varint(val, i)
        out.append(_signed(v))
    return out


def _parse_tensor(buf) -> np.ndarray:
    dims: list[int] = []
    data_type, raw = 1, None
    float_data: list[float] = []
    int_data: list[int] = []
    for field, wire, val in _iter_fields(buf):
        if field == 1:  # dims
            dims += [val] if wire == 0 else _packed_varints(val)
        elif field == 2 and wire == 0:
            data_type = val
        elif field == 4:  # float_data
            float_data.extend(np.frombuffer(val if wire == 5 else bytes(val), "<f4"))
        elif field in (5, 7):  # int32_data / int64_data
            int_data += [_signed(val)] if wire == 0 else _packed_varints(val)
        elif field == 9 and wire == 2:  # raw_data
            raw = bytes(val)
    dt, shape = _DTYPES[data_type], tuple(dims)
    if raw is not None:
        return np.frombuffer(raw, dt).reshape(shape).copy()
    if float_data:
        return np.asarray(float_data, dt).reshape(shape)
    if int_data:
        return np.asarray(int_data, np.int64).astype(dt).reshape(shape)
    return np.zeros(shape, dt)


def _parse_attr(buf) -> tuple[str, object]:
    name = ""
    f = i_ = s = t = None
    floats: list[float] = []
    ints: list[int] = []
    for field, wire, val in _iter_fields(buf):
        if field == 1 and wire == 2:
            name = bytes(val).decode()
        elif field == 2 and wire == 5:
            f = float(np.frombuffer(val, "<f4")[0])
        elif field == 3 and wire == 0:
            i_ = _signed(val)
        elif field == 4 and wire == 2:
            s = bytes(val)
        elif field == 5 and wire == 2:
            t = _parse_tensor(val)
        elif field == 7:
            floats += np.frombuffer(val if wire == 5 else bytes(val), "<f4").tolist()
        elif field == 8:
            ints += [_signed(val)] if wire == 0 else _packed_varints(val)
    for v in (t, f, i_, s):
        if v is not None:
            return name, v
    return name, floats if floats else ints


def _value_info(buf) -> tuple[str, list]:
    """ValueInfoProto -> (name, dims): each dim its value, its parameter's
    name (a dynamic axis), or None."""
    name, dims = "", []
    for field, wire, val in _iter_fields(buf):
        if field == 1 and wire == 2:
            name = bytes(val).decode()
        elif field == 2 and wire == 2:  # TypeProto
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1 and w2 == 2:  # tensor_type
                    for f3, w3, v3 in _iter_fields(v2):
                        if f3 == 2 and w3 == 2:  # shape
                            for f4, w4, v4 in _iter_fields(v3):
                                if f4 == 1 and w4 == 2:  # dim
                                    dim = None
                                    for f5, w5, v5 in _iter_fields(v4):
                                        dim = v5 if f5 == 1 else bytes(v5).decode() if f5 == 2 else dim
                                    dims.append(dim)
    return name, dims


class OnnxGraph:
    """A ModelProto's graph: nodes in order, initializers, graph inputs
    (less initializers) and outputs with their dims, and the model's
    ``ir_version`` and default-domain ``opset``."""

    def __init__(self):
        self.nodes: list[dict] = []
        self.initializers: dict[str, np.ndarray] = {}
        self.inputs: list[str] = []
        self.outputs: list[str] = []
        self.dims: dict[str, list] = {}
        self.ir_version = self.opset = None

    def op_counts(self) -> dict[str, int]:
        return dict(Counter(n["op"] for n in self.nodes))


def load_onnx_graph(path: str) -> OnnxGraph:
    with open(path, "rb") as fh:
        data = memoryview(fh.read())
    g, graph = OnnxGraph(), None
    for field, wire, val in _iter_fields(data):
        if field == 1 and wire == 0:  # ModelProto.ir_version
            g.ir_version = val
        elif field == 7 and wire == 2:  # ModelProto.graph
            graph = val
        elif field == 8 and wire == 2:  # opset_import
            domain, version = "", None
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1 and w2 == 2:
                    domain = bytes(v2).decode()
                elif f2 == 2 and w2 == 0:
                    version = v2
            if domain in ("", "ai.onnx"):
                g.opset = version
    if graph is None:
        raise ValueError(f"{path}: no GraphProto found, not an ONNX ModelProto")
    for field, wire, val in _iter_fields(graph):
        if field == 1 and wire == 2:  # node
            node = {"inputs": [], "outputs": [], "op": "", "attrs": {}}
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1 and w2 == 2:
                    node["inputs"].append(bytes(v2).decode())
                elif f2 == 2 and w2 == 2:
                    node["outputs"].append(bytes(v2).decode())
                elif f2 == 4 and w2 == 2:
                    node["op"] = bytes(v2).decode()
                elif f2 == 5 and w2 == 2:
                    k, v = _parse_attr(v2)
                    node["attrs"][k] = v
            g.nodes.append(node)
        elif field == 5 and wire == 2:  # initializer
            name = next((bytes(v2).decode() for f2, w2, v2 in _iter_fields(val) if f2 == 8 and w2 == 2), "")
            g.initializers[name] = _parse_tensor(val)
        elif field in (11, 12) and wire == 2:  # input / output
            name, dims = _value_info(val)
            (g.inputs if field == 11 else g.outputs).append(name)
            g.dims[name] = dims
    g.inputs = [n for n in g.inputs if n not in g.initializers]
    return g


# ---------------------------------------------------------------------------
# Eager op forms (NCHW)
# ---------------------------------------------------------------------------

def _conv(x, w, b, attrs):
    """Conv as a sum over taps of (O, C) x (N, C, Ho, Wo) products."""
    if int(attrs.get("group", 1)) != 1:
        raise NotImplementedError("grouped Conv")
    sh, sw = (int(s) for s in attrs.get("strides", [1, 1]))
    dh, dw = (int(d) for d in attrs.get("dilations", [1, 1]))
    pt, pl, pb, pr = (int(p) for p in attrs.get("pads", [0, 0, 0, 0]))
    kh, kw = w.shape[2:]
    x = np.pad(x, ((0, 0), (0, 0), (pt, pb), (pl, pr)))
    ho = (x.shape[2] - dh * (kh - 1) - 1) // sh + 1
    wo = (x.shape[3] - dw * (kw - 1) - 1) // sw + 1
    out = np.zeros((x.shape[0], w.shape[0], ho, wo), np.result_type(x, w))
    for i in range(kh):
        for j in range(kw):
            win = x[:, :, i * dh:i * dh + sh * (ho - 1) + 1:sh, j * dw:j * dw + sw * (wo - 1) + 1:sw]
            out += np.einsum("oc,nchw->nohw", w[:, :, i, j], win, optimize=True)
    if b is not None:
        out += b.reshape(1, -1, 1, 1)
    return out


def _conv_transpose(x, w, b, attrs):
    """ConvTranspose (W (Cin, Cout, kh, kw)) as each input pixel scattering
    its taps, then the pads cropped."""
    if int(attrs.get("group", 1)) != 1 or any(attrs.get("output_padding", [0, 0])):
        raise NotImplementedError("grouped ConvTranspose or output_padding")
    sh, sw = (int(s) for s in attrs.get("strides", [1, 1]))
    dh, dw = (int(d) for d in attrs.get("dilations", [1, 1]))
    pt, pl, pb, pr = (int(p) for p in attrs.get("pads", [0, 0, 0, 0]))
    n, _, h, wd = x.shape
    kh, kw = w.shape[2:]
    full = np.zeros((n, w.shape[1], (h - 1) * sh + dh * (kh - 1) + 1, (wd - 1) * sw + dw * (kw - 1) + 1),
                    np.result_type(x, w))
    for i in range(kh):
        for j in range(kw):
            full[:, :, i * dh:i * dh + sh * (h - 1) + 1:sh, j * dw:j * dw + sw * (wd - 1) + 1:sw] += np.einsum(
                "co,nchw->nohw", w[:, :, i, j], x, optimize=True)
    out = full[:, :, pt:full.shape[2] - pb, pl:full.shape[3] - pr]
    if b is not None:
        out = out + b.reshape(1, -1, 1, 1)
    return out


def _maxpool(x, attrs):
    kh, kw = (int(k) for k in attrs["kernel_shape"])
    sh, sw = (int(s) for s in attrs.get("strides", [kh, kw]))
    pt, pl, pb, pr = (int(p) for p in attrs.get("pads", [0, 0, 0, 0]))
    n, c, h, w = x.shape
    if attrs.get("ceil_mode", 0):  # extend the end padding to take the last partial window
        pb += -(h + pt + pb - kh) % sh
        pr += -(w + pl + pr - kw) % sw
    xp = np.pad(x, ((0, 0), (0, 0), (pt, pb), (pl, pr)), constant_values=-np.inf)
    ho, wo = (xp.shape[2] - kh) // sh + 1, (xp.shape[3] - kw) // sw + 1
    out = np.full((n, c, ho, wo), -np.inf, x.dtype)
    for i in range(kh):
        for j in range(kw):
            out = np.maximum(out, xp[:, :, i:i + sh * (ho - 1) + 1:sh, j:j + sw * (wo - 1) + 1:sw])
    return out


def _resize(x, sizes, scales, attrs):
    mode = attrs.get("mode", b"nearest").decode()
    coord = attrs.get("coordinate_transformation_mode", b"half_pixel").decode()
    n, c, h, w = x.shape
    if sizes is not None and sizes.size:
        oh, ow = int(sizes[-2]), int(sizes[-1])
    else:
        oh, ow = int(h * scales[-2]), int(w * scales[-1])
    if mode == "nearest":
        nearest_mode = attrs.get("nearest_mode", b"round_prefer_floor").decode()

        def src(i, size_in, size_out):
            if coord == "asymmetric":
                xs = i * (size_in / size_out)
            elif coord in ("half_pixel", "pytorch_half_pixel"):
                xs = (i + 0.5) * (size_in / size_out) - 0.5
            else:
                raise NotImplementedError(coord)
            idx = {"floor": np.floor, "ceil": np.ceil}.get(nearest_mode, lambda v: np.ceil(v - 0.5))(xs)
            return np.clip(idx.astype(np.int64), 0, size_in - 1)

        return x[:, :, src(np.arange(oh), h, oh)][:, :, :, src(np.arange(ow), w, ow)]
    if mode == "linear":
        def grid(i, size_in, size_out):
            if coord == "align_corners":
                return i * (size_in - 1) / max(size_out - 1, 1)
            xs = (i + 0.5) * (size_in / size_out) - 0.5
            if coord == "pytorch_half_pixel" and size_out <= 1:
                xs = np.zeros_like(xs)
            return xs

        ys = np.clip(grid(np.arange(oh, dtype=np.float64), h, oh), 0, h - 1)
        xs = np.clip(grid(np.arange(ow, dtype=np.float64), w, ow), 0, w - 1)
        y0, x0 = np.floor(ys).astype(np.int64), np.floor(xs).astype(np.int64)
        y1, x1 = np.minimum(y0 + 1, h - 1), np.minimum(x0 + 1, w - 1)
        wy = (ys - y0).astype(x.dtype)[None, None, :, None]
        wx = (xs - x0).astype(x.dtype)[None, None, None, :]
        rows0, rows1 = x[:, :, y0], x[:, :, y1]
        return (rows0[..., x0] * (1 - wy) * (1 - wx) + rows0[..., x1] * (1 - wy) * wx
                + rows1[..., x0] * wy * (1 - wx) + rows1[..., x1] * wy * wx)
    raise NotImplementedError(f"Resize mode {mode}")


def _reshape(x, shape, allowzero):
    shape = [int(v) for v in shape]
    if not allowzero:  # 0 copies the input's dim
        shape = [x.shape[i] if v == 0 else v for i, v in enumerate(shape)]
    return np.reshape(x, shape)


def _slice(x, starts, ends, axes, steps):
    axes = np.arange(len(starts)) if axes is None else axes
    steps = np.ones(len(starts), np.int64) if steps is None else steps
    sl = [slice(None)] * x.ndim
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        sl[int(ax)] = slice(int(st), int(en), int(sp))
    return x[tuple(sl)]


def _axes(ins, attrs, i=1):
    if len(ins) > i and ins[i] is not None:
        return tuple(int(v) for v in np.atleast_1d(ins[i]))
    return tuple(int(v) for v in attrs["axes"]) if "axes" in attrs else None


def _split(x, split, attrs, n_out):
    axis = int(attrs.get("axis", 0))
    if split is None:
        split = attrs.get("split") or [x.shape[axis] // n_out] * n_out
    return tuple(np.split(x, np.cumsum([int(s) for s in split])[:-1], axis=axis))


def _batchnorm(x, scale, b, mean, var, attrs):
    sh = (1, -1, 1, 1)
    eps = float(attrs.get("epsilon", 1e-5))
    return ((x - mean.reshape(sh)) / np.sqrt(var.reshape(sh) + eps) * scale.reshape(sh)
            + b.reshape(sh)).astype(x.dtype)


def _opt(ins, i):
    return ins[i] if len(ins) > i else None


_ELEMENTWISE = {
    "Add": np.add, "Sub": np.subtract, "Mul": np.multiply, "Div": np.divide, "Greater": np.greater,
    "Less": np.less, "Equal": np.equal, "And": np.logical_and,
}
_UNARY = {
    "Relu": lambda x: np.maximum(x, 0).astype(x.dtype), "Neg": np.negative, "Sqrt": np.sqrt,
    "Reciprocal": np.reciprocal, "Floor": np.floor, "Not": np.logical_not, "Identity": lambda x: x,
}
_OPS = {
    "Constant": lambda ins, a, n: a["value"],
    "Cast": lambda ins, a, n: np.asarray(ins[0]).astype(_DTYPES[int(a["to"])]),
    "Concat": lambda ins, a, n: np.concatenate(ins, axis=int(a["axis"])),
    "Shape": lambda ins, a, n: np.asarray(np.shape(ins[0]), np.int64)[a.get("start", 0):a.get("end")],
    "Gather": lambda ins, a, n: np.take(ins[0], ins[1], axis=int(a.get("axis", 0))),
    "Unsqueeze": lambda ins, a, n: np.expand_dims(ins[0], tuple(sorted(_axes(ins, a)))),
    "Squeeze": lambda ins, a, n: np.squeeze(ins[0], _axes(ins, a)),
    "Reshape": lambda ins, a, n: _reshape(ins[0], ins[1], int(a.get("allowzero", 0))),
    "Transpose": lambda ins, a, n: np.transpose(ins[0], a.get("perm")),
    "Slice": lambda ins, a, n: _slice(ins[0], ins[1], ins[2], _opt(ins, 3), _opt(ins, 4)),
    "Split": lambda ins, a, n: _split(ins[0], _opt(ins, 1), a, n),
    "Max": lambda ins, a, n: functools.reduce(np.maximum, ins),
    "Min": lambda ins, a, n: functools.reduce(np.minimum, ins),
    "Where": lambda ins, a, n: np.where(ins[0], ins[1], ins[2]),
    "Expand": lambda ins, a, n: ins[0] * np.ones([int(v) for v in ins[1]], ins[0].dtype),
    "ConstantOfShape": lambda ins, a, n: np.full([int(v) for v in ins[0]], a["value"].reshape(-1)[0]
                                                 if "value" in a else 0.0,
                                                 a["value"].dtype if "value" in a else np.float32),
    "Range": lambda ins, a, n: np.arange(ins[0], ins[1], ins[2]),
    "Pad": lambda ins, a, n: _pad(ins, a),
    "ReduceSum": lambda ins, a, n: np.sum(ins[0], axis=_axes(ins, a), keepdims=bool(a.get("keepdims", 1))),
    "BatchNormalization": lambda ins, a, n: _batchnorm(*ins[:5], a),
    "Conv": lambda ins, a, n: _conv(ins[0], ins[1], _opt(ins, 2), a),
    "ConvTranspose": lambda ins, a, n: _conv_transpose(ins[0], ins[1], _opt(ins, 2), a),
    "MaxPool": lambda ins, a, n: _maxpool(ins[0], a),
    "Resize": lambda ins, a, n: _resize(ins[0], _opt(ins, 3), _opt(ins, 2), a),
}


def _pad(ins, attrs):
    mode = attrs.get("mode", b"constant").decode()
    pads = [int(p) for p in ins[1]]
    k = len(pads) // 2
    value = ins[2].reshape(-1)[0] if len(ins) > 2 and ins[2] is not None and ins[2].size else 0
    width = list(zip(pads[:k], pads[k:]))
    if mode != "constant":
        raise NotImplementedError(f"Pad mode {mode}")
    return np.pad(ins[0], width, constant_values=value)


def run_onnx(graph_or_path, feeds: dict) -> list[np.ndarray]:
    """Execute the graph eagerly. ``feeds`` maps input names to numpy
    arrays (NCHW); returns the graph outputs in declaration order."""
    g = graph_or_path if isinstance(graph_or_path, OnnxGraph) else load_onnx_graph(graph_or_path)
    env: dict[str, np.ndarray] = dict(g.initializers)
    for name in g.inputs:
        env[name] = np.asarray(feeds[name])
    for node in g.nodes:
        op, a = node["op"], node["attrs"]
        ins = [env[n] if n else None for n in node["inputs"]]
        if op in _ELEMENTWISE:
            out = _ELEMENTWISE[op](ins[0], ins[1])
            if op in ("Add", "Sub", "Mul", "Div"):  # ONNX keeps the operands' type
                out = out.astype(np.result_type(ins[0], ins[1]))
        elif op in _UNARY:
            out = _UNARY[op](ins[0])
        elif op in _OPS:
            out = _OPS[op](ins, a, len(node["outputs"]))
        else:
            raise NotImplementedError(f"ONNX op {op}")
        for name, val in zip(node["outputs"], out if isinstance(out, tuple) else (out,)):
            env[name] = val
    return [env[n] for n in g.outputs]
