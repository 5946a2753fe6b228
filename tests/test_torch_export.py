"""The port's ``torch.export`` program (``nconv_tpu_torch.runtime.export``)
on the CPU, where its custom ops run the kernels' plain versions: reloaded,
against the port's eager ``export`` (1e-6 rel RMSE) and, in a fresh process
that imports only the port, against the JAX package's ``export_guided``
artifact on the same weights (1e-4, the f32 guided bar), at b = 1, 2 and 3
from one artifact; the four serving ops in its graph; the op's fake shapes
against their plain results; the table cache after a trace."""
import json
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from nconv_tpu.runtime import export_guided as jexport_guided
from nconv_tpu.runtime import load_exported as jload_exported
from nconv_tpu.runtime import save_exported as jsave_exported
from nconv_tpu_torch.cli import main
from nconv_tpu_torch.convert import from_jax_variables
from nconv_tpu_torch.models import GuidedDepthNet, maybe_fold
from nconv_tpu_torch.ops import library
from nconv_tpu_torch.ops.tables import TABLES
from nconv_tpu_torch.runtime import export_guided, load_exported, save_exported
from nconv_tpu_torch.training import save_best
from test_torch_engine import jax_variables

H, W = 104, 128  # rows 45-58 lie inside the border mask: nonzero outputs
BATCHES = (1, 2, 3)
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def inputs(b, seed):
    """f32 NHWC inputs of the contract at batch ``b``: sparse smooth depth."""
    rng = np.random.default_rng(seed)
    i, j = np.mgrid[0:H, 0:W]
    truth = (5 + 3 * np.sin(i / 9) + 2 * np.cos(j / 11)).astype(np.float32)
    out = []
    for _ in range(2):
        out.append((rng.random((b, H, W, 3)) * 255).astype(np.float32))
        out.append((truth[None, :, :, None] * (rng.random((b, H, W, 1)) < 0.06)).astype(np.float32))
    return out


@pytest.fixture(scope="module")
def exported(tmp_path_factory, one_torch_thread):
    """The folded f32 model from seeded JAX weights, exported once (the
    table cache emptied first, the eager outputs taken before), saved and
    reloaded."""
    variables = jax_variables()
    model, state = maybe_fold(GuidedDepthNet(device="cpu"), from_jax_variables(variables))
    model.load_state_dict(state)
    args = [torch.from_numpy(a) for a in inputs(2, 0)]
    before = model.export(*args)
    TABLES._tables.clear()
    ep = export_guided(model, height=H, width=W)
    after_tables = dict(TABLES._tables)
    path = save_exported(ep, tmp_path_factory.mktemp("export") / "guided.pt2")
    return dict(variables=variables, model=model, ep=ep, path=path, call=load_exported(path), args=args,
                before=before, after_tables=after_tables)


def test_the_trace_leaves_no_table_behind_and_eager_frames_unchanged(exported):
    assert exported["after_tables"] == {}
    model, args = exported["model"], exported["args"]
    after = model.export(*args)
    assert all(torch.equal(a, b) for a, b in zip(after, exported["before"]))
    assert TABLES._tables and not any(isinstance(t, torch._subclasses.FakeTensor)
                                      for v in TABLES._tables.values()
                                      for t in (v if isinstance(v, tuple) else (v,)))


@pytest.mark.parametrize("b", BATCHES)
def test_program_matches_the_eager_export(exported, b):
    """One artifact, every batch: within 1e-6 of the eager call (the CPU
    plain versions' convolutions may pick another order for the program's
    contiguous operands), bitwise where it is bitwise."""
    args = [torch.from_numpy(a) for a in inputs(b, 10 + b)]
    got = exported["call"](*args)
    want = exported["model"].export(*args)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (b, H, W, 1)
        assert float(w.abs().max()) > 0
        assert torch.equal(g, w) or rel(g, w) <= 1e-6


def test_program_has_a_dynamic_batch_axis_and_the_four_serving_ops(exported):
    ep = exported["ep"]
    (constraint,) = ep.range_constraints.values()
    assert constraint.lower == 1 and constraint.upper > 1e6
    ops = Counter(str(n.target) for m in ep.graph_module.modules() if isinstance(m, torch.fx.GraphModule)
                  for n in m.graph.nodes if n.op == "call_function")
    assert {k: n for k, n in ops.items() if k.startswith("nconv_tpu_torch.")} == {
        "nconv_tpu_torch.nconv2d_fused.default": 9, "nconv_tpu_torch.conv3x3.default": 23,
        "nconv_tpu_torch.conv_transpose4x4s2.default": 3, "nconv_tpu_torch.conv3x3_chain2.default": 4}
    # the tables and the mask are constants of the program, on its device
    assert ep.constants and all(c.device.type == "cpu" for c in ep.constants.values())


RELOAD = """
import json, sys
import numpy as np
from nconv_tpu_torch.models import guided
from nconv_tpu_torch.runtime.export import load_exported
def refuse(*a, **k):
    raise AssertionError("the reloading process built a model")
guided.GuidedDepthNet.__init__ = refuse
call = load_exported(sys.argv[1])
data = np.load(sys.argv[2])
out = {}
for b in (1, 2, 3):
    o0, o1 = call(*(data[f"{b}_{i}"] for i in range(4)))
    out[f"{b}_0"], out[f"{b}_1"] = o0.numpy(), o1.numpy()
np.savez(sys.argv[3], **out)
print(json.dumps(sorted(m for m in sys.modules if m == "jax" or m.split(".")[0] in ("nconv_tpu", "flax"))))
"""


def test_fresh_process_serves_every_batch_like_the_jax_artifact(exported, tmp_path):
    """``python -m nconv_tpu_torch export --device cpu`` writes one program;
    a process that imports only the port and builds no model reloads it
    and serves b = 1, 2, 3, each within 1e-4 of the JAX package's
    dynamic-batch StableHLO artifact of the same weights."""
    ck = save_best(tmp_path, "g", from_jax_variables(exported["variables"]))
    program = str(tmp_path / "g.pt2")
    assert main(["export", "--checkpoint", ck, "--out", program, "--height", str(H), "--width", str(W),
                 "--device", "cpu"]) == 0
    data = {f"{b}_{i}": a for b in BATCHES for i, a in enumerate(inputs(b, 20 + b))}
    np.savez(tmp_path / "in.npz", **data)
    proc = subprocess.run([sys.executable, "-c", RELOAD, program, str(tmp_path / "in.npz"),
                           str(tmp_path / "out.npz")], capture_output=True, text=True, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    got = np.load(tmp_path / "out.npz")
    jcall = jload_exported(jsave_exported(jexport_guided(exported["variables"], height=H, width=W),
                                          str(tmp_path / "guided.stablehlo")))
    for b in BATCHES:
        want = jcall(*(data[f"{b}_{i}"] for i in range(4)))
        for s in (0, 1):
            w = np.asarray(want[s])
            assert got[f"{b}_{s}"].shape == w.shape == (b, H, W, 1)
            assert np.abs(w).max() > 0
            assert rel(got[f"{b}_{s}"], w) <= 1e-4, (b, s)


def _nconv_case():
    g = torch.Generator().manual_seed(0)
    full = torch.rand((2, 8, 16, 24), generator=g)
    half = torch.rand((2, 8, 8, 12), generator=g)
    w = torch.rand((8, 16, 3, 3), generator=g)
    return library._nconv2d_fused_op, [[full, half], [full.clone(), half.clone()], w, torch.rand(8, generator=g),
                                       1, [False, True], 1, True, 1e-7]


def _cases():
    g = torch.Generator().manual_seed(1)
    r = lambda *s: torch.rand(s, generator=g)  # noqa: E731
    x, y = r(2, 5, 12, 16), r(2, 3, 12, 16)
    u8 = (r(2, 3, 12, 16) * 255).to(torch.uint8)
    bf = r(2, 8, 12, 16).bfloat16()
    return {
        "nconv_pool_up2_crop": _nconv_case(),
        "nconv_plain": (library._nconv2d_fused_op, [[x[:, :1]], [y[:, :1]], r(1, 1, 5, 5), r(1), 2, [False], 0,
                                                    False, 1e-7]),
        "conv3x3_parts_s2": (library.conv3x3, [[x, y], r(6, 8, 3, 3), r(6), 2, True, None, torch.float32]),
        "conv3x3_residual_u8": (library.conv3x3, [[u8], r(4, 3, 3, 3), r(4), 1, True, r(4, 3, 1, 1),
                                                      torch.bfloat16]),
        "conv3x3_bf16_head": (library.conv3x3, [[bf], r(1, 8, 3, 3), None, 1, False, None, torch.bfloat16]),
        "conv_transpose": (library.conv_transpose4x4s2, [[x, y], r(8, 4, 4, 4), r(4), True]),
        "conv_transpose_bf16": (library.conv_transpose4x4s2, [[bf], r(8, 4, 4, 4), None, False]),
        "chain": (library.conv3x3_chain2, [x.contiguous(), r(7, 5, 3, 3), r(7), r(6, 7, 3, 3), r(6)]),
        "chain_bf16": (library.conv3x3_chain2, [bf, r(7, 8, 3, 3), r(7), r(6, 7, 3, 3), r(6)]),
    }


@pytest.mark.parametrize("case", sorted(_cases()))
def test_custom_op_fake_matches_its_plain_result(case):
    """``torch.library.opcheck``: the schema, and each op's fake output
    (shape, dtype, strides) against its CPU implementation (the plain
    version) on the same inputs, none of them aliasing an input."""
    op, args = _cases()[case]
    torch.library.opcheck(op, args, test_utils=("test_schema", "test_faketensor"))
    real = op(*args)
    real = real if isinstance(real, tuple) else (real,)
    assert all(t.is_contiguous() for t in real)


def test_eager_calls_never_reach_the_ops(monkeypatch):
    """Outside a trace the public functions call the kernels (here their
    plain versions) directly."""
    def refuse(*a, **k):
        raise AssertionError("an eager call reached a custom op")

    for name in ("nconv2d_fused", "conv3x3", "conv_transpose4x4s2", "conv3x3_chain2"):
        monkeypatch.setattr(library, name, refuse)
    model = GuidedDepthNet(device="cpu")
    with torch.no_grad():
        out = model.export(*(torch.from_numpy(a) for a in inputs(1, 3)))
    assert out[0].shape == (1, H, W, 1)
