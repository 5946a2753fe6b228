"""K1 (``csrc/nconv.cu``) and K4's f32 form (``csrc/chain.cu``) on the CPU
under the host emulation of the CUDA launch model (``csrc/host_emu.h``),
and, ``cuda``-marked, the same cases on the card.

The two sources are compiled with ``g++ -x c++ -std=c++20 -include
host_emu.h`` through the probe sources of ``runtime/plan_probe.py`` (each
includes its kernel's source unchanged and adds an entry that launches a
given plan), into a shared library that takes the kernel library's place
while the public wrappers run on CPU tensors as on the card (see
``tests/test_torch_host_emu.py``). Every plan branch is held to its plain
version at 1e-5 rel RMSE (each output) at shapes of a few blocks:

* K1 through ``ops.nconv2d_fused`` (the plan: 2 of the output channels a
  thread in tiles of 8 rows at cout 8, all of it in tiles of 16 at cout 1,
  the direct 1x1 form): K 1 / 3 / 5; cin 1, 8 and 16 as one part, 8 and 16
  as two; an up2 part first and second; the crop; pool_out at even and odd
  sizes; rows copied as 16-byte, 8-byte and 4-byte pieces; cout 1 and 8;
  then every form through the probe entry, the tiled one also on the
  unpooled 1x1s, where the plan takes the direct form;
* K4 through ``ops.conv3x3_chain2`` (the plan: T on these small grids), then
  both tiles (S, T) at both widths through the probe entry: cmid / cout
  32 and 64 (and narrower, run as 32 or 64), cin 32 and 64, images smaller
  than one tile, ragged edges, rows staged as 16-byte vectors and not.

Skips only where g++ is absent. On the card (the probe library built with
nvcc, about a minute):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_host_emu_nconv_chain.py
"""
import contextlib
import ctypes
import shutil
import subprocess

import pytest
import torch
from test_torch_host_emu import emulated_card

from nconv_tpu_torch import kernels, ops
from nconv_tpu_torch.ops import convops
from nconv_tpu_torch.runtime import plan_probe

BAR = 1e-5  # f32 sums in another order than the plain versions
_ERRORS = '#include <cuda_runtime.h>\nextern "C" const char* nct_error_string(int code) {\n' \
          '  return cudaGetErrorString(static_cast<cudaError_t>(code));\n}\n'
_SOURCES = {"probe_nconv": plan_probe._NCONV_PROBE, "probe_chain": plan_probe._CHAIN_PROBE, "errors": _ERRORS}


def _build(d, compile_cmd, link_cmd, sources=_SOURCES):
    """The probe sources (and nct_error_string) compiled in parallel in d
    and linked; returns the loaded library with its entries typed."""
    objs, procs = [], []
    for name, text in sources.items():
        src, obj = d / f"{name}.cu", d / f"{name}.o"
        src.write_text(text)
        objs.append(obj)
        procs.append(subprocess.Popen([*compile_cmd, "-c", str(src), "-o", str(obj)], stderr=subprocess.PIPE,
                                      text=True))
    for p in procs:
        assert p.wait() == 0, p.stderr.read()
    so = d / "probe.so"
    subprocess.run([*link_cmd, *map(str, objs), "-o", str(so)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in {**kernels._SIGNATURES, **plan_probe._PROBE_SIGNATURES}.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    lib.nct_error_string.argtypes = [ctypes.c_int]
    lib.nct_error_string.restype = ctypes.c_char_p
    return lib


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels under the host emulation")
    d = tmp_path_factory.mktemp("host_emu_nconv_chain")
    for stub in ("cuda_runtime.h", "cuda_bf16.h"):  # host_emu.h defines what the sources use of them
        (d / stub).write_text("")
    return _build(d, [gxx, "-x", "c++", "-std=c++20", "-O1", "-fPIC", f"-I{d}", f"-I{kernels.CSRC}", "-include",
                      str(kernels.CSRC / "host_emu.h")], [gxx, "-shared"])


@pytest.fixture(scope="module")
def card_lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("probe_nconv_chain")
    nvcc = kernels._nvcc()
    return _build(d, [nvcc, *kernels.NVCC_FLAGS, f"-I{kernels.CSRC}"], [nvcc, *kernels.NVCC_FLAGS, "-shared"])


@pytest.fixture(params=["emu", pytest.param("card", marks=pytest.mark.cuda)])
def where(request):
    """(device, context, probe library): the emulated kernels on CPU
    tensors, or the real ones on the card."""
    if request.param == "card":
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        return torch.device("cuda"), contextlib.nullcontext, request.getfixturevalue("card_lib")
    lib = request.getfixturevalue("emu")
    return torch.device("cpu"), lambda: emulated_card(lib), lib


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------

# (part channels, up2, k, pad, crop, pool, cout, b, h, w): the full-resolution
# (h, w); an up2 part is stored at (h / 2, w / 2)
_NCONV = {
    "5x5 pool even": ((8,), None, 5, 2, 0, True, 8, 2, 36, 70),        # nconv2 / nconv_down*
    "5x5 pool odd": ((8,), None, 5, 2, 0, True, 8, 1, 35, 69),         # floor mode: 17 x 34 pooled
    "cin 1": ((1,), None, 5, 2, 0, False, 8, 2, 33, 64),               # nconv1
    "up2 second": ((8, 8), (False, True), 3, 1, 0, False, 8, 2, 34, 66),  # nconv4 / nconv5
    "up2 first": ((8, 8), (True, False), 3, 0, 0, False, 8, 2, 34, 66),   # nconv6: pad 0, 32 x 64 out
    "up2 first, 16-byte rows": ((8, 8), (True, False), 3, 0, 0, False, 8, 1, 20, 64),
    "1x1 crop": ((8,), None, 1, 2, 1, False, 1, 2, 32, 62),            # nconv7: the direct form
    "cin 16": ((16,), None, 3, 1, 0, False, 8, 1, 20, 40),
    "cin 16 two parts": ((8, 8), (False, False), 3, 1, 0, False, 8, 1, 20, 37),
    "cin 8 two parts pool": ((5, 3), (False, False), 5, 2, 0, True, 8, 1, 18, 40),
    "cout 1 3x3": ((8,), None, 3, 1, 0, False, 1, 1, 20, 37),
    "cout 1 5x5 pool": ((8,), None, 5, 2, 0, True, 1, 1, 18, 34),
    "1x1 cout 8": ((1,), None, 1, 0, 0, False, 8, 1, 9, 40),           # direct form, cin 1
    "1x1 pool": ((8,), None, 1, 1, 0, True, 8, 1, 10, 36),             # tiled: 12 x 38 out, 6 x 19 pooled
}


def _nconv_inputs(case, dev):
    pc, up2, k, pad, crop, pool, cout, b, h, w = case
    g = torch.Generator().manual_seed(500 + k + cout + sum(pc) + h)
    up2 = list(up2) if up2 else [False] * len(pc)
    shapes = [(b, c, h // 2, w // 2) if u else (b, c, h, w) for c, u in zip(pc, up2)]
    d = [(torch.rand(*s, generator=g) * 10).to(dev) for s in shapes]
    c = [(torch.rand(*s, generator=g) > 0.5).float().to(dev) for s in shapes]
    wt = torch.rand(cout, sum(pc), k, k, generator=g).to(dev)
    bias = torch.randn(cout, generator=g).to(dev)
    return d, c, wt, bias, dict(padding=pad, up2=up2, crop=crop, pool_out=pool)


@pytest.mark.parametrize("name", list(_NCONV))
def test_nconv_matches_plain_version(where, name):
    dev, ctx, _ = where
    d, c, wt, bias, kw = _nconv_inputs(_NCONV[name], dev)
    with ctx():
        kernels.reset_launch_counts()
        got = ops.nconv2d_fused(d, c, wt, bias, **kw)
        assert kernels.launch_counts()["nconv"] == 1
    want = ops.nconv2d_fused_plain(d, c, wt, bias, **kw)
    assert len(got) == len(want) == (4 if kw["pool_out"] else 2)
    for a, e in zip(got, want):
        assert a.shape == e.shape and _rel(a, e) <= BAR


def _probe_nconv(lib, d, c, wt, bias, form, padding, up2, crop, pool_out):
    b, h, w = ops.nconv._check_parts(d, c, up2)
    cout, cin, k, _ = wt.shape
    ho, wo = h + 2 * padding - k + 1 - 2 * crop, w + 2 * padding - k + 1 - 2 * crop
    outs = [torch.empty((b, cout, ho, wo), device=wt.device) for _ in range(2)]
    outs += [torch.empty((b, cout, ho // 2, wo // 2), device=wt.device) for _ in range(2 if pool_out else 0)]
    dptrs, meta = kernels.part_args(d, up2)
    cptrs, _ = kernels.part_args(c, up2)
    ksum = wt.sum(dim=(1, 2, 3)).contiguous()
    ptrs = [o.data_ptr() for o in outs] + [None] * (4 - len(outs))
    stream = kernels.stream_of(wt) if wt.is_cuda else 0
    code = lib.probe_nconv(dptrs, cptrs, meta, len(d), b, h, w, cin, ho, wo, cout, k, padding - crop, 1e-20,
                           wt.data_ptr(), bias.data_ptr(), ksum.data_ptr(), *ptrs, ord(form), stream)
    assert code == 0
    if wt.is_cuda:
        torch.cuda.synchronize()
    return outs


@pytest.mark.parametrize("name,form", [(n, f) for n, (_, _, k, _, _, pool, cout, *_) in _NCONV.items()
                                       for f in plan_probe.nconv_forms(k, cout, pool)])
def test_nconv_forms_match_plain_version(where, name, form):
    """Every form on every case it takes: the tiled form of the output
    channels (Q at 8, T at 1), also on the unpooled 1x1s, where the plan
    takes the direct form (D), and D there."""
    dev, _, lib = where
    case = _NCONV[name]
    d, c, wt, bias, kw = _nconv_inputs(case, dev)
    got = _probe_nconv(lib, d, c, wt, bias, form, **kw)
    want = ops.nconv2d_fused_plain(d, c, wt, bias, eps=1e-20, **kw)
    for a, e in zip(got, want):
        assert a.shape == e.shape and _rel(a, e) <= BAR


def test_nconv_plan(emu):
    """At 8 output channels 2 of them a thread in tiles of 8 rows, at one all
    of it in tiles of 16; the direct form for the unpooled 1x1 only."""
    plan = lambda *a: chr(emu.probe_nconv_plan(*a))
    assert plan(5, 8, 1) == plan(5, 8, 0) == plan(3, 8, 0) == plan(1, 8, 1) == "Q"
    assert plan(3, 1, 0) == plan(1, 1, 1) == "T"
    assert plan(1, 1, 0) == plan(1, 8, 0) == "D"


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------

# (cin, cmid, cout, b, h, w)
_CHAIN = {
    "64-64-64": (64, 64, 64, 1, 16, 64),   # 16-byte rows; fuse0 / fuse1's widths
    "64-32-32 ragged": (64, 32, 32, 1, 30, 61),  # fuse2's; element copies, ragged edges
    "32-32-32": (32, 32, 32, 2, 17, 40),   # fuse3's
    "32-32-16": (32, 32, 16, 1, 9, 31),    # cout run as 32
    "smaller than a tile": (8, 40, 24, 1, 5, 7),  # cmid 40 run as 64
    "32-64-32": (32, 64, 32, 1, 15, 33),   # cout 32 in a width-64 tile
}


def _chain_inputs(case, dev):
    cin, cmid, cout, b, h, w = case
    g = torch.Generator().manual_seed(600 + cin + cmid + cout + h)
    x = torch.randn(b, cin, h, w, generator=g)
    w1 = torch.randn(cmid, cin, 3, 3, generator=g) * (9 * cin) ** -0.5
    w2 = torch.randn(cout, cmid, 3, 3, generator=g) * (9 * cmid) ** -0.5
    b1, b2 = torch.randn(cmid, generator=g) * 0.1, torch.randn(cout, generator=g) * 0.1
    return [t.to(dev) for t in (x, w1, b1, w2, b2)]


@pytest.mark.parametrize("name", list(_CHAIN))
def test_chain_matches_plain_version(where, name):
    dev, ctx, _ = where
    x, w1, b1, w2, b2 = _chain_inputs(_CHAIN[name], dev)
    with ctx():
        kernels.reset_launch_counts()
        got = ops.conv3x3_chain2(x, w1, b1, w2, b2)
        assert kernels.launch_counts()["conv_chain"] == 1
    want = convops.conv3x3_chain2_plain(x, w1, b1, w2, b2)
    assert got.shape == want.shape and _rel(got, want) <= BAR


@pytest.mark.parametrize("tile", ["S", "T"])
@pytest.mark.parametrize("name", ["64-64-64", "64-32-32 ragged", "32-32-16", "smaller than a tile", "32-64-32"])
def test_chain_tiles_match_plain_version(where, name, tile):
    """Every tile at the width the call runs as."""
    dev, _, lib = where
    x, w1, b1, w2, b2 = _chain_inputs(_CHAIN[name], dev)
    b, cin, h, w = x.shape
    cmid, cout = w1.shape[0], w2.shape[0]
    width = 32 if cmid <= 32 and cout <= 32 else 64
    out = torch.empty((b, cout, h, w), device=dev)
    stream = kernels.stream_of(x) if x.is_cuda else 0
    code = lib.probe_chain(x.data_ptr(), b, h, w, cin, cmid, cout, *(t.data_ptr() for t in (w1, b1, w2, b2)),
                           out.data_ptr(), ord(tile), width, stream)
    assert code == 0
    if x.is_cuda:
        torch.cuda.synchronize()
    want = convops.conv3x3_chain2_plain(x, w1, b1, w2, b2)
    assert _rel(out, want) <= BAR


def test_chain_plan_keys_on_the_grid(emu):
    """T where S's grid (TH 8) has fewer blocks than the card's 132 SMs (the
    44x152 chain of an f32 frame at B = 2: 72 blocks), S elsewhere; the width
    follows cmid and cout."""
    plan = lambda *a: (chr(emu.probe_chain_plan(*a) % 256), emu.probe_chain_plan(*a) // 256)
    assert plan(2, 44, 152, 64, 64) == ("T", 64)
    assert plan(2, 88, 304, 64, 64) == ("S", 64)
    assert plan(2, 176, 608, 64, 32) == ("S", 64)
    assert plan(2, 352, 1216, 32, 32) == ("S", 32)
    assert plan(1, 9, 31, 32, 16) == ("T", 32)


def test_chain_entry_refuses_what_it_cannot_take(emu):
    """Over 64 intermediate or output channels, or bf16 (the tensor-core
    form's): the wrapper raises before launch, the entry refuses."""
    x, w1, b1, w2, b2 = _chain_inputs(_CHAIN["32-32-16"], torch.device("cpu"))
    with emulated_card(emu), pytest.raises(ValueError):
        convops._chain_kernel(x, w1.repeat(3, 1, 1, 1), b1.repeat(3), w2.repeat(1, 3, 1, 1), b2)
    out = torch.empty(1, 16, 9, 31)
    for dtype, cmid in ((0, 65), (1, 32)):
        assert emu.nct_conv_chain2(x.data_ptr(), dtype, 1, 9, 31, 32, cmid, 16, w1.data_ptr(), b1.data_ptr(),
                                   w2.data_ptr(), b2.data_ptr(), out.data_ptr(), 0) != 0
