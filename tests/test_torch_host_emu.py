"""K6's f32 weight cotangent (``csrc/wgrad.cu``), K2's f32 output-stationary
kernel (``csrc/conv.cu``, ``convkxk_kernel``: the backward's K x K form and
the forward) and K3's f32 forms (``csrc/convt.cu``: the 4x4/s2 forward and
the 3x3/s2 input gradient) run on the CPU under the host emulation of the
CUDA launch model (``csrc/host_emu.h``).

The three sources (``convt.cu`` through the probe source of
``runtime/plan_probe.py``, which includes it unchanged and adds entries
that launch a given plan) are compiled with ``g++ -x c++ -std=c++20
-include host_emu.h`` into a shared library, which takes the kernel
library's place while the public wrappers run on CPU tensors as on the
card: each launch goes through the real C entry, plan and kernel, its
blocks one after another, each CUDA thread a fiber on one host thread,
``__syncthreads`` a barrier of the block's fibers, ``cp.async`` a
synchronous copy with a zero fill, and the dynamic shared memory poisoned
with NaN bytes before each block. Every plan branch is held to its plain
version at 1e-5 rel RMSE at shapes of a few blocks: K6's tile shapes (M =
1, N < 45 at M <= 32 and above, M <= 32, M > 32 in tiles of 64 and of 40),
its three forms, multi-part operands, a channel-offset view, rows read as
16-byte vectors and not; the K x K form's tile shapes (up to 8 and 16
channels, one to four slabs of 32 (tile P), more in balanced groups, a
small grid's narrower groups), K 1 / 3 / 5 at stride 1 with the forward
weight read flipped, and 4x4 at stride 2; the forward's (stride 1 and 2,
one to four parts, a uint8 NHWC part, the residual epilogue, cin 1 and 3,
the cout-1 tile, 33 / 64 / 128 outputs, the small-grid split); the 4x4/s2
forward's (UpCat's [1 | 32] and [1 | 64] parts with their cin 33 and 65
tails, one part, a chunk straddling parts, cout 20, 24, 32, 64 and 80 in
groups of at most 32, W a multiple of 4 and not, B 1 and 2, bias and ReLU on and
off; through the probe entry groups of 64 and half the rows a block);
the 3x3/s2 form's (32, 33, 64 and 128 outputs).
Skips only where g++ is absent. The forward's, the 4x4/s2 forward's and
the 3x3/s2 form's cases also run on the card (``cuda``-marked, skipped
without one):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_host_emu.py
"""
import contextlib
import ctypes
import shutil
import subprocess
from unittest import mock

import pytest
import torch

from nconv_tpu_torch import kernels, ops
from nconv_tpu_torch.ops import convops
from nconv_tpu_torch.runtime import plan_probe

BAR = 1e-5  # f32 sums in another order than the plain versions


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels under the host emulation")
    d = tmp_path_factory.mktemp("host_emu")
    for stub in ("cuda_runtime.h", "cuda_bf16.h"):  # host_emu.h defines what the sources use of them
        (d / stub).write_text("")
    so = d / "emu.so"
    (d / "probe_convt.cu").write_text(plan_probe._CONVT_PROBE)  # convt.cu and its probe entries
    srcs = [kernels.CSRC / "wgrad.cu", kernels.CSRC / "conv.cu", d / "probe_convt.cu"]
    objs = [d / f"{src.stem}.o" for src in srcs]
    builds = [subprocess.Popen([gxx, "-x", "c++", "-std=c++20", "-O1", "-fPIC", f"-I{d}", f"-I{kernels.CSRC}",
                                "-include", str(kernels.CSRC / "host_emu.h"), "-c", str(src), "-o", str(o)],
                               stderr=subprocess.PIPE, text=True) for src, o in zip(srcs, objs)]
    for b in builds:
        assert b.wait() == 0, b.stderr.read()
    subprocess.run([gxx, "-shared", *map(str, objs), "-o", str(so)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in {**kernels._SIGNATURES, **plan_probe._PROBE_SIGNATURES}.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    lib.nct_error_string.argtypes = [ctypes.c_int]
    lib.nct_error_string.restype = ctypes.c_char_p
    return lib


@contextlib.contextmanager
def emulated_card(lib):
    """The emulated library in the kernel library's place, and every CPU
    tensor taken as on the card."""
    with mock.patch.object(kernels, "_lib", lib), mock.patch.object(kernels, "lib", lambda: lib), \
            mock.patch.object(kernels, "on_card", lambda *t: True), \
            mock.patch.object(kernels, "device_guard", lambda t: contextlib.nullcontext()), \
            mock.patch.object(kernels, "stream_of", lambda t: 0):
        kernels.reset_launch_counts()
        yield


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def _r(g, *s):
    return torch.randn(*s, generator=g)


# (k, stride, x channels by part, g channels by part, h, w): the K6 plan's
# tile shapes and forms
_WGRAD = [
    (3, 1, (3, "view7"), (40,), 10, 40),   # M > 32: (8, 8); g rows as 16-byte vectors
    (3, 2, (10,), (128,), 10, 40),         # two m blocks of 64
    (3, 1, (10,), (1,), 9, 37),            # M = 1: (1, 1); ragged rows, element copies
    (3, 1, (5, 6), (1, 31), 9, 37),        # M <= 32: (4, 8), both sides in parts
    (3, 1, (3,), (64,), 9, 37),            # N < 45, M > 32: (16, 2), the RGB encoder's
    (3, 2, (1,), (32,), 12, 40),           # N < 45, M <= 32: (16, 2)
    (4, 2, (16,), (1, 8), 8, 18),          # the transpose conv's, roles swapped
    (4, 2, (8,), (1, 32), 8, 18),          # its M = 33
]


@pytest.mark.parametrize("k,stride,xc,gc,h,w", _WGRAD)
def test_wgrad_kernel_under_emulation_matches_plain_version(emu, k, stride, xc, gc, h, w):
    g = torch.Generator().manual_seed(100 * k + 10 * stride + sum(gc))
    b = 2
    xs = [_r(g, b, 9, h, w)[:, 2:] if c == "view7" else _r(g, b, c, h, w) for c in xc]
    if k == 4:  # x is the transpose conv's output cotangent, g its input
        ho, wo = h // 2, w // 2
    else:
        ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    gs = [_r(g, b, c, ho, wo) for c in gc]
    with emulated_card(emu):
        got = ops.conv2d_wgrad(xs, gs, k, stride=stride, padding=1)
        again = ops.conv2d_wgrad(xs, gs, k, stride=stride, padding=1)
        assert kernels.launch_counts()["wgrad"] == 2
    want = convops.conv2d_weight_grad_plain(xs, gs, k, 1, stride=stride)
    assert got.shape == want.shape and _rel(got, want) <= BAR
    assert torch.equal(got, again)  # a fixed summation order


# (k, stride, pad, cin, cout, b, h, w): the K x K plan's tile shapes; at
# stride 1 through conv2d_input_grad (the forward weight read flipped). At
# 130 rows of two 32-pixel column tiles and B = 2 a grid has 68 blocks a
# channel group, enough that the plan keeps its groups whole.
_KXK = [
    (3, 1, 1, 8, 8, 2, 130, 37),    # D
    (5, 1, 2, 8, 16, 2, 130, 20),   # C, one slab; step 1's 5x5
    (1, 1, 0, 16, 8, 2, 130, 33),   # D at 1x1
    (3, 1, 0, 16, 32, 2, 130, 37),  # P (two rows a thread); the forward conv had pad 0
    (3, 1, 1, 16, 40, 2, 130, 35),  # P, two slabs
    (3, 1, 1, 1, 64, 2, 130, 37),   # P, two slabs, from a 1-channel cotangent
    (3, 1, 1, 8, 128, 2, 130, 33),  # P, four slabs
    (3, 1, 1, 9, 131, 2, 130, 20),  # two balanced groups of 66, P in three slabs
    (3, 1, 1, 16, 64, 1, 9, 37),    # a small grid: four groups of 16
]


@pytest.mark.parametrize("k,stride,pad,cin,cout,b,h,w", _KXK)
def test_stride1_input_grad_under_emulation_matches_plain_version(emu, k, stride, pad, cin, cout, b, h, w):
    """``cin`` and ``cout`` are the K x K conv's: the forward conv maps
    ``cout`` channels to ``cin``, so its weight is (cin, cout, k, k)."""
    g = torch.Generator().manual_seed(100 + k + cin + cout)
    ho, wo = h + 2 * pad - k + 1, w + 2 * pad - k + 1
    cot = _r(g, b, cin, ho, wo)
    wf = _r(g, cin, cout, k, k)
    with emulated_card(emu):
        got = ops.conv2d_input_grad(cot, wf, pad)
        assert kernels.launch_counts()["conv_kxk"] == 1
    want = ops.conv2d_input_grad_plain(cot, wf, pad)
    assert got.shape == want.shape == (b, cout, h, w) and _rel(got, want) <= BAR


@pytest.mark.parametrize("cin,cout,h,w", [(8, 33, 130, 37), (8, 65, 130, 20), (8, 9, 130, 33), (16, 65, 4, 20)])
def test_4x4s2_input_grad_under_emulation_matches_plain_version(emu, cin, cout, h, w):
    """The transpose conv's weight (cout, cin, 4, 4) read as OIHW: 33 in one
    48-channel slab (E), 65 in two groups of 33, 9 in a 16-channel slab (C),
    and 65 on a small grid in five groups of 13."""
    g = torch.Generator().manual_seed(200 + cout)
    up = _r(g, 2, cin, 2 * h, 2 * w)[:, :, :, 1:]  # a strided view: odd width, ragged edge
    wt = _r(g, cout, cin, 4, 4)
    with emulated_card(emu):
        got = ops.conv_transpose4x4s2_input_grad(up, wt)
        assert kernels.launch_counts()["conv4x4s2"] == 1
    want = ops.conv_transpose4x4s2_input_grad_plain(up, wt)
    assert got.shape == want.shape and _rel(got, want) <= BAR


@pytest.fixture(params=["emu", pytest.param("card", marks=pytest.mark.cuda)])
def where(request):
    """(device, context): the emulated kernels on CPU tensors, or the real
    ones on the card."""
    if request.param == "card":
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        return torch.device("cuda"), contextlib.nullcontext
    lib = request.getfixturevalue("emu")
    return torch.device("cpu"), lambda: emulated_card(lib)


# (stride, part channels, cout, residual, bias, b, h, w): the forward's plan
# branches (tiles B, C, D, H at stride 1, F at stride 2, B for the residual form); "view3" is a channel-offset view, "u8" the (b, h, w, 3) uint8
# frame read through its NHWC strides. At B = 2 and 130 output rows of two
# 32-pixel column tiles a grid has 68 blocks a channel group, so the plan
# keeps its groups whole.
_FWD = [
    (1, (5, 3), 33, False, True, 2, 130, 37),             # B, two slabs, over two parts
    (1, (1, 2, "view3", 2), 64, True, True, 2, 130, 37),  # four parts, residual, B two slabs
    (1, (1,), 32, False, True, 2, 130, 36),               # cin 1 (depth_conv), rows as 16-byte vectors
    (1, ("u8",), 32, True, True, 2, 130, 37),             # the u8 frame (cin 3), residual
    (1, (16,), 1, False, True, 2, 40, 40),                # a cout-1 head: tile H
    (1, (8,), 128, False, True, 2, 130, 36),              # B, four slabs
    (1, (8,), 8, False, False, 2, 130, 37),               # D, no bias, no ReLU
    (1, (6,), 16, False, True, 2, 130, 33),               # C
    (2, (8,), 64, True, True, 2, 259, 73),                # stride 2, residual, B two slabs
    (2, (3, 3), 128, False, True, 2, 260, 72),            # stride 2, F two slabs (the stacked pair)
    (1, (16,), 64, False, True, 1, 9, 37),                # a small grid: four groups of 16
    (2, (8,), 128, False, True, 1, 17, 40),               # a small grid at stride 2: kept whole, B (not F)
]


@pytest.mark.parametrize("stride,pc,cout,res,bias,b,h,w", _FWD)
def test_forward_matches_plain_version(where, stride, pc, cout, res, bias, b, h, w):
    dev, ctx = where
    g = torch.Generator().manual_seed(300 + 10 * stride + cout + len(pc))
    parts = []
    for c in pc:
        if c == "u8":
            parts.append(torch.randint(0, 256, (b, h, w, 3), generator=g, dtype=torch.uint8).permute(0, 3, 1, 2))
        elif c == "view3":
            parts.append(_r(g, b, 6, h, w)[:, 3:])
        else:
            parts.append(_r(g, b, c, h, w))
    cin = sum(p.shape[1] for p in parts)
    wt = _r(g, cout, cin, 3, 3) * (9 * cin) ** -0.5
    bt = _r(g, cout) if bias else None
    sc = _r(g, cout, cin, 1, 1) * cin ** -0.5 if res else None
    parts = [p.to(dev) for p in parts]
    wt, bt, sc = (None if t is None else t.to(dev) for t in (wt, bt, sc))
    relu = res or bias
    with ctx():
        kernels.reset_launch_counts()
        got = ops.conv3x3(parts, wt, bt, stride=stride, relu=relu, shortcut=sc)
        assert kernels.launch_counts()["conv"] == 1
    want = convops.conv3x3_plain(parts, wt, bt, stride=stride, relu=relu, shortcut=sc)
    assert got.dtype == torch.float32 and got.shape == want.shape and _rel(got, want) <= BAR


# (cin, cout, b, h, w, view): the 3x3/s2 form's plan
_T3 = [
    (24, 32, 2, 130, 40, False),  # one group of 32: two slabs, 4 g rows a block; 16-byte rows
    (13, 64, 2, 66, 40, False),   # one group of 64: four slabs, 2 g rows; a partial channel chunk
    (12, 33, 2, 66, 37, True),    # three slabs (6 warps), ragged edges; element copies of a view
    (16, 128, 1, 10, 20, False),  # two groups of 64
]


@pytest.mark.parametrize("cin,cout,b,h,w,view", _T3)
def test_3x3s2_input_grad_matches_plain_version(where, cin, cout, b, h, w, view):
    dev, ctx = where
    g = torch.Generator().manual_seed(400 + cin + cout)
    cot = _r(g, b, cin + 3, h, w)[:, 3:] if view else _r(g, b, cin, h, w)
    wt = _r(g, cin, cout, 3, 3)
    cot, wt = cot.to(dev), wt.to(dev)
    with ctx():
        kernels.reset_launch_counts()
        got = ops.conv3x3s2_input_grad(cot, wt)
        assert kernels.launch_counts()["conv_transpose3x3s2"] == 1
    want = ops.conv3x3s2_input_grad_plain(cot, wt)
    assert got.shape == want.shape == (b, cout, 2 * h, 2 * w) and _rel(got, want) <= BAR


# (part channels, cout, bias, relu, b, h, w): K3's f32 4x4/s2 forward
# (nct::t4) through the public wrapper; "view7" is a channel-offset view
_T4 = [
    ((1, 32), 32, True, True, 2, 6, 36),     # UpCat's [1 | 32]: a cin 33 tail, two slabs, 4 rows a block; 16-byte rows
    ((1, 64), 64, True, True, 1, 5, 40),     # [1 | 64]: a cin 65 tail, two groups of 32; B 1
    ((1, 64), 64, False, False, 2, 3, 37),   # no bias, no ReLU; W not a multiple of 4: element copies and stores
    ((17,), 20, True, True, 2, 4, 33),       # one part; cout not a multiple of 8
    ((5, "view7"), 24, True, False, 1, 5, 24),  # a chunk straddling parts; a channel-offset view
    ((3, 3), 80, True, True, 1, 3, 20),      # three balanced groups of 27
]


@pytest.mark.parametrize("pc,cout,bias,relu,b,h,w", _T4)
def test_4x4s2_forward_matches_plain_version(where, pc, cout, bias, relu, b, h, w):
    dev, ctx = where
    g = torch.Generator().manual_seed(600 + cout + len(pc) + h)
    parts = [_r(g, b, 9, h, w)[:, 2:] if c == "view7" else _r(g, b, c, h, w) for c in pc]
    cin = sum(p.shape[1] for p in parts)
    wt = _r(g, cin, cout, 4, 4) * (4 * cin) ** -0.5
    bt = _r(g, cout) if bias else None
    parts = [p.to(dev) for p in parts]
    wt, bt = wt.to(dev), None if bt is None else bt.to(dev)
    with ctx():
        kernels.reset_launch_counts()
        got = ops.conv_transpose4x4s2(parts, wt, bt, relu=relu)
        assert kernels.launch_counts()["conv_transpose"] == 1
    want = convops.conv_transpose4x4s2_plain(parts, wt, bt, relu=relu)
    assert got.dtype == torch.float32 and got.shape == want.shape == (b, cout, 2 * h, 2 * w)
    assert _rel(got, want) <= BAR


@pytest.fixture(scope="module")
def card_probe(tmp_path_factory):
    """The convt.cu probe library, built with nvcc for the card."""
    d = tmp_path_factory.mktemp("probe_convt")
    (d / "probe_convt.cu").write_text(plan_probe._CONVT_PROBE)
    nvcc = kernels._nvcc()
    subprocess.run([nvcc, *kernels.NVCC_FLAGS, f"-I{kernels.CSRC}", "-shared", str(d / "probe_convt.cu"), "-o",
                    str(d / "probe.so")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(d / "probe.so"))
    for name, argtypes in plan_probe._PROBE_SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    return lib


# (part channels, cout, b, h, w, (groups, input rows a block)): the 4x4/s2
# forward's plan branches through the probe entry
_T4_BRANCHES = [
    ((1, 64), 64, 1, 5, 40, (1, 2)),   # one group of 64: four slabs, 2 rows a block
    ((1, 64), 64, 2, 3, 37, (1, 1)),   # ... 1 row; ragged edges, element copies
    ((1, 64), 64, 1, 5, 40, (2, 2)),   # groups of 32, half the rows
    ((1, 32), 32, 2, 6, 36, (1, 2)),   # half the rows a block
]


@pytest.mark.parametrize("pc,cout,b,h,w,plan", _T4_BRANCHES)
def test_4x4s2_forward_branches_match_plain_version(request, where, pc, cout, b, h, w, plan):
    dev, _ = where
    lib = request.getfixturevalue("card_probe" if dev.type == "cuda" else "emu")
    g = torch.Generator().manual_seed(650 + cout + h)
    parts = [_r(g, b, c, h, w).to(dev) for c in pc]
    cin = sum(pc)
    wt, bt = (_r(g, cin, cout, 4, 4) * (4 * cin) ** -0.5).to(dev), _r(g, cout).to(dev)
    out = torch.empty((b, cout, 2 * h, 2 * w), device=dev)
    ptrs, meta = kernels.part_args(parts, [False] * len(parts))
    code = lib.probe_t4(ptrs, meta, len(parts), b, h, w, cin, cout, wt.data_ptr(), bt.data_ptr(), out.data_ptr(), 1,
                        *plan, kernels.stream_of(out) if dev.type == "cuda" else 0)
    assert code == 0
    if dev.type == "cuda":
        torch.cuda.synchronize()
    want = convops.conv_transpose4x4s2_plain(parts, wt, bt, relu=True)
    assert _rel(out, want) <= BAR


def test_4x4s2_forward_plan(emu):
    """Balanced groups of at most 32 channels, 8 warps a block."""
    plan = lambda cout: divmod(emu.probe_t4_plan(cout), 256)
    assert plan(64) == (2, 4) and plan(32) == (1, 4) and plan(20) == (1, 4) and plan(80) == (3, 4)
    assert plan(16) == (1, 8)


def test_4x4s2_entry_refuses_what_it_cannot_take(emu):
    """An upsampled part, channels that do not sum to cin, bf16: the entry
    raises, nothing counted."""
    x, w = torch.randn(1, 4, 4, 4), torch.randn(4, 8, 4, 4)
    out = torch.empty(1, 8, 8, 8)
    for up2, cin, dtype in ((True, 4, 0), (False, 5, 0), (False, 4, 1)):
        ptrs, meta = kernels.part_args([x], [up2])
        with emulated_card(emu), pytest.raises(RuntimeError, match="CUDA error"):
            kernels.launch("conv_transpose", "nct_conv_transpose4x4s2", out, ptrs, meta, 1, dtype, 1, 4, 4, cin, 8,
                           w, None, out, 1)
        assert kernels.launch_counts()["conv_transpose"] == 0


def test_conv3x3_entry_refuses_an_upsampled_part(emu):
    """No caller reads an upsampled part through K2: its entry raises."""
    x, w = torch.randn(1, 4, 4, 4), torch.randn(8, 4, 3, 3)
    out = torch.empty(1, 8, 8, 8)
    ptrs, meta = kernels.part_args([x], [True])
    with emulated_card(emu), pytest.raises(RuntimeError, match="CUDA error"):
        kernels.launch("conv", "nct_conv3x3", out, ptrs, meta, 1, 0, 0, 1, 8, 8, 4, 8, 8, 8, 1, w, None, None,
                       out, 0)
    assert kernels.launch_counts()["conv"] == 0
