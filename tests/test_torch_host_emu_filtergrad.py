"""K5, step 1's weight cotangent (``csrc/filtergrad.cu``), on the CPU under
the host emulation of the CUDA launch model (``csrc/host_emu.h``), and,
``cuda``-marked, the same cases on the card.

The source is compiled with ``g++ -x c++ -std=c++20 -include host_emu.h``
through the probe source of ``runtime/plan_probe.py`` (it includes
``filtergrad.cu`` unchanged and adds an entry that launches a given plan)
into a shared library that takes the kernel library's place while the
public wrapper runs on CPU tensors as on the card (see
``tests/test_torch_host_emu.py``). Each case is held to the plain version
at 1e-5 rel RMSE and to itself: two launches on the same operands are
bitwise equal. The cases are step 1's forms (cin 1, 8 and 16; cout 1 and
8; k 5 pad 2, k 3 pad 1, k 3 pad 0 and k 1 pad 2, whose implied bottom and
right pads are negative and positive), an asymmetric ``pad_top``, channels
that need two blocks, an odd channel count and rows copied as 16-byte
vectors and element by element; then every plan branch through the probe
entry (the tiled form at one and two channels a thread, g staged
pixel-major and as stored (16-byte copies and 4-byte ones), at one and two
waves of blocks; the dot form of the 1x1 cout-1 head, and the tiled form
there); and the entry's refusals. Skips only where g++ is absent. On the
card (the probe library built with nvcc, about a minute):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_host_emu_filtergrad.py
"""
import contextlib
import shutil

import pytest
import torch
from test_torch_host_emu import emulated_card
from test_torch_host_emu_nconv_chain import _ERRORS, _build

from nconv_tpu_torch import kernels, ops
from nconv_tpu_torch.ops import convops
from nconv_tpu_torch.runtime import plan_probe

BAR = 1e-5  # f32 sums in another order than the plain version
_SOURCES = {"probe_fg": plan_probe._FG_PROBE, "errors": _ERRORS}


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels under the host emulation")
    d = tmp_path_factory.mktemp("host_emu_filtergrad")
    for stub in ("cuda_runtime.h", "cuda_bf16.h"):  # host_emu.h defines what the sources use of them
        (d / stub).write_text("")
    return _build(d, [gxx, "-x", "c++", "-std=c++20", "-O1", "-fPIC", f"-I{d}", f"-I{kernels.CSRC}", "-include",
                      str(kernels.CSRC / "host_emu.h")], [gxx, "-shared"], _SOURCES)


@pytest.fixture(scope="module")
def card_lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("probe_filtergrad")
    nvcc = kernels._nvcc()
    return _build(d, [nvcc, *kernels.NVCC_FLAGS, f"-I{kernels.CSRC}"], [nvcc, *kernels.NVCC_FLAGS, "-shared"],
                  _SOURCES)


@pytest.fixture(params=["emu", pytest.param("card", marks=pytest.mark.cuda)])
def where(request):
    """(device, context, probe library): the emulated kernel on CPU tensors,
    or the real one on the card."""
    if request.param == "card":
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        return torch.device("cuda"), contextlib.nullcontext, request.getfixturevalue("card_lib")
    lib = request.getfixturevalue("emu")
    return torch.device("cpu"), lambda: emulated_card(lib), lib


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


# (cin, cout, k, padding, pad_top, b, h, w): x is (b, cin, h, w); g's size
# follows from the pads (pad_top None: padding)
_FG = {
    "nconv1: cin 1, k 5 p 2": (1, 8, 5, 2, None, 2, 18, 68),       # one channel a group, segments of 8
    "nconv2: cin 8, k 5 p 2": (8, 8, 5, 2, None, 2, 17, 70),       # two channels a group; element copies (w 70)
    "nconv4/5: cin 16, k 3 p 1": (16, 8, 3, 1, None, 2, 12, 40),   # 16-byte rows
    "nconv6: cin 16, k 3 p 0": (16, 8, 3, 0, None, 2, 12, 41),     # g 2 smaller than x
    "nconv7: cin 8, cout 1, k 1 p 2": (8, 1, 1, 2, None, 2, 10, 37),  # the dot form; g 4 larger than x
    "asymmetric pad_top": (4, 8, 3, 1, 2, 2, 9, 36),
    "cin 14: two blocks": (14, 8, 5, 2, None, 1, 9, 40),           # blocks of 8 and 6 channels
    "cin 3, cout 1, k 5": (3, 1, 5, 2, None, 2, 11, 36),           # odd cin: one channel a group
    "cin 1, cout 1, k 3 p 0": (1, 1, 3, 0, None, 1, 10, 44),
    "cin 8, k 1 p 0": (8, 8, 1, 0, None, 2, 9, 36),
}


def _inputs(case, dev):
    cin, cout, k, pad, pad_top, b, h, w = case
    pad_top = pad if pad_top is None else pad_top
    ho, wo = h + pad + pad_top - k + 1, w + 2 * pad - k + 1
    g = torch.Generator().manual_seed(700 + cin + cout + k + h)
    x = torch.randn(b, cin, h, w, generator=g).to(dev)
    cot = torch.randn(b, cout, ho, wo, generator=g).to(dev)
    return x, cot, k, pad, pad_top


@pytest.mark.parametrize("name", list(_FG))
def test_filtergrad_matches_plain_version_and_repeats_bitwise(where, name):
    dev, ctx, _ = where
    x, cot, k, pad, pad_top = _inputs(_FG[name], dev)
    with ctx():
        kernels.reset_launch_counts()
        got = ops.conv2d_weight_grad(x, cot, k, pad, pad_top)
        again = ops.conv2d_weight_grad(x, cot, k, pad, pad_top)
        assert kernels.launch_counts()["filtergrad"] == 2
    want = convops.conv2d_weight_grad_plain(x, cot, k, pad, pad_top)
    assert got.shape == want.shape == (cot.shape[1], x.shape[1], k, k) and _rel(got, want) <= BAR
    assert torch.equal(got, again)  # a fixed summation order


def _probe(lib, x, cot, k, pad, pad_top, form, p, pm, waves):
    b, cin, h, w = x.shape
    cout, ho, wo = cot.shape[1:]
    slices = lib.probe_fg_slices(b, cin, h, ho, wo, cout, k, ord(form), p, pm, waves)
    part = torch.empty((slices, cout * cin * k * k), device=x.device)
    out = torch.empty((cout, cin, k, k), device=x.device)
    stream = kernels.stream_of(x) if x.is_cuda else 0
    code = lib.probe_fg(x.data_ptr(), cot.data_ptr(), b, cin, h, w, cout, ho, wo, k, pad_top, pad, part.data_ptr(),
                        out.data_ptr(), ord(form), p, pm, waves, stream)
    assert code == 0
    if x.is_cuda:
        torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("name,form,p,pm,waves", [(n, *br) for n, (cin, cout, k, *_) in _FG.items()
                                             for br in plan_probe.fg_branches(k, cin, cout)
                                             if n.startswith(("nconv", "cin 3"))])
def test_filtergrad_branches_match_plain_version(where, name, form, p, pm, waves):
    dev, _, lib = where
    x, cot, k, pad, pad_top = _inputs(_FG[name], dev)
    got = _probe(lib, x, cot, k, pad, pad_top, form, p, pm, waves)
    want = convops.conv2d_weight_grad_plain(x, cot, k, pad, pad_top)
    assert _rel(got, want) <= BAR


def test_filtergrad_plan(emu):
    """The dot form for the 1x1 cout-1 head only; two channels a group where
    cin is even; g pixel-major where its rows are not whole 16-byte vectors."""
    plan = lambda *a: (emu.probe_fg_plan(*a) // 65536, *divmod(emu.probe_fg_plan(*a) % 65536, 256))
    assert plan(8, 8, 350, 354, 1218, 1, 1) == (0, 0, ord("D"))
    assert plan(8, 1, 352, 352, 1216, 8, 5) == (0, 1, ord("T"))
    assert plan(8, 8, 352, 352, 1216, 8, 5) == plan(8, 16, 88, 88, 304, 8, 3) == (0, 2, ord("T"))
    assert plan(8, 16, 352, 350, 1214, 8, 3) == (1, 2, ord("T"))  # nconv6
    assert plan(8, 8, 9, 9, 40, 8, 1) == (0, 2, ord("T"))


@pytest.mark.parametrize("bad", ["k 2", "cout 4", "negative pad", "negative implied pad"])
def test_filtergrad_entry_refuses_what_it_cannot_take(emu, bad):
    """The entry raises (through the launch wrapper, nothing counted) for a
    k or cout it has no form of and for pads that do not fit the sizes."""
    b, cin, h, w, cout, k, pt, pl = 1, 4, 8, 16, 8, 3, 1, 1
    if bad == "k 2":
        k = 2
    elif bad == "cout 4":
        cout = 4
    elif bad == "negative pad":
        pt = -1
    x, cot = torch.zeros(b, cin, h, w), torch.zeros(b, cout, h, w)
    if bad == "negative implied pad":
        cot = torch.zeros(b, cout, h - 2, w)  # ho + k - 1 < h + pad_top
    part, out = torch.zeros(4, cout * cin * k * k), torch.zeros(cout, cin, k, k)
    with emulated_card(emu), pytest.raises(RuntimeError, match="CUDA error"):
        kernels.launch("filtergrad", "nct_filtergrad", out, x, cot, b, cin, h, w, cout, cot.shape[2], cot.shape[3],
                       k, pt, pl, part, out)
    assert kernels.launch_counts()["filtergrad"] == 0
