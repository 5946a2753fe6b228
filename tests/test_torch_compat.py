"""The port's interop layer (``nconv_tpu_torch.compat``) against the JAX
package's on the same weights: the deployment ONNX contract; the port's
artifact executed by the port's numpy interpreter against JAX's
``GuidedDepthNet.export`` (1e-4 rel RMSE, nonzero outputs, b = 1 and 2);
the port's interpreter on the JAX package's artifact against JAX's
interpreter; the checkpoint converters key for key (bitwise), converted
models within 1e-4, and both kernel modes' round trips."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nconv_tpu import compat as jcompat
from nconv_tpu.compat.onnx_exec import run_onnx as jrun_onnx
from nconv_tpu.models import GuidedDepthNet as JGuided
from nconv_tpu.models import NConvUNet as JUNet
from nconv_tpu_torch import compat
from nconv_tpu_torch.compat import onnx_exec
from nconv_tpu_torch.compat.onnx_export import INPUT_NAMES, OUTPUT_NAMES, selftest_frames
from nconv_tpu_torch.compat.onnx_exec import run_onnx
from nconv_tpu_torch.convert import from_jax_unguided_variables, from_jax_variables
from nconv_tpu_torch.models import GuidedDepthNet, NConvUNet, maybe_fold
from test_torch_cli import unet_variables
from test_torch_engine import jax_variables

SMALL = (64, 96)  # the contract's checks (the border mask zeroes every row)
EXEC = (128, 160)  # executed: rows 45-82 inside the border mask


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def variables():
    return jax_variables()


@pytest.fixture(scope="module")
def state(variables):
    return from_jax_variables(variables)


@pytest.fixture(scope="module")
def port_onnx(state, tmp_path_factory):
    return compat.export_guided_onnx(state, str(tmp_path_factory.mktemp("onnx") / "guided.onnx"),
                                     height=EXEC[0], width=EXEC[1])


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def jax_export(variables, rgb, dep, *, pos_fn="softplus"):
    """JAX's deployed forward on NCHW arrays, returned NCHW."""
    nhwc = lambda x: jnp.asarray(np.transpose(x, (0, 2, 3, 1)))  # noqa: E731
    outs = JGuided(step1_pos_fn=pos_fn).apply(variables, nhwc(rgb), nhwc(dep), nhwc(rgb[::-1]), nhwc(dep[::-1]),
                                              method=JGuided.export)
    return [np.transpose(np.asarray(o), (0, 3, 1, 2)) for o in outs]


def test_onnx_contract(state, tmp_path):
    path = compat.export_guided_onnx(state, str(tmp_path / "g.onnx"), height=SMALL[0], width=SMALL[1])
    s = compat.read_onnx_summary(path)
    assert (s["opset"], s["inputs"], s["outputs"]) == (17, INPUT_NAMES, OUTPUT_NAMES)
    assert s["dims"] == {**{n: ["batch_size", 3 if n.startswith("rgb") else 1, *SMALL] for n in INPUT_NAMES},
                         **{n: ["batch_size", 1, *SMALL] for n in OUTPUT_NAMES}}
    # every weight an initializer: the 978,336 parameters and the BN
    # statistics, with the tables
    assert s["initializers"] > 0 and s["total_weight_floats"] >= 978_336
    ops = s["op_counts"]
    # one batch-stacked pass: 18 convs of step 1's 9 nconvs, 31 of the
    # guided net; 3 transpose convs
    assert (ops["Conv"], ops["ConvTranspose"]) == (49, 3)
    assert set(ops) <= set(onnx_exec._ELEMENTWISE) | set(onnx_exec._UNARY) | set(onnx_exec._OPS)
    assert not list(tmp_path.glob("*.tmp"))


def test_onnx_selftest_checks_the_structure(state, tmp_path):
    path = compat.export_guided_onnx(state, str(tmp_path / "g.onnx"), height=SMALL[0], width=SMALL[1])
    s = compat.selftest_guided_onnx(path, height=SMALL[0], width=SMALL[1])
    assert s["opset"] == 17 and s["exec_rel_rmse"] is None
    data = open(path, "rb").read()
    bad = tmp_path / "bad.onnx"
    bad.write_bytes(data[: len(data) // 2])
    with pytest.raises(Exception):
        compat.selftest_guided_onnx(str(bad))


@pytest.mark.parametrize("b", (1, 2))
def test_port_onnx_runs_like_the_jax_export(port_onnx, variables, b):
    rgb, dep = selftest_frames(*EXEC, batch=b, seed=b)
    got = run_onnx(port_onnx, {"rgb_0": rgb, "depth_0": dep, "rgb_1": rgb[::-1].copy(), "depth_1": dep[::-1].copy()})
    want = jax_export(variables, rgb, dep)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (b, 1, *EXEC) and np.abs(w).mean() > 0.1
        assert rel(g, w) < 1e-4


def test_onnx_selftest_executes_against_the_plain_path(port_onnx, state):
    s = compat.selftest_guided_onnx(port_onnx, state, height=EXEC[0], width=EXEC[1])
    assert s["exec_rel_rmse"] < 1e-4


def test_port_interpreter_runs_the_jax_artifact(variables, tmp_path):
    """The JAX package's artifact (BatchNormalization, MaxPool, Resize, one
    pass a stream) through both interpreters: the same outputs to f32
    rounding (their convolutions sum in different orders)."""
    path = jcompat.export_guided_onnx(variables, str(tmp_path / "jax.onnx"), height=EXEC[0], width=EXEC[1])
    rgb, dep = selftest_frames(*EXEC, batch=1, seed=7)
    feeds = {"rgb_0": rgb, "depth_0": dep, "rgb_1": rgb, "depth_1": dep}
    got, want = run_onnx(path, feeds), jrun_onnx(path, feeds)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.abs(w).mean() > 0.1
        assert rel(g, w) < 1e-6


@pytest.mark.parametrize("mode", ("softplus", "raw"))
def test_to_guided_state_dict_is_the_jax_converters(variables, state, mode):
    got = compat.to_guided_state_dict(state, kernel_mode=mode)
    want = jcompat.to_guided_state_dict(variables, kernel_mode=mode)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == np.asarray(w).dtype and np.array_equal(got[k], np.asarray(w)), k


@pytest.mark.parametrize("mode", ("softplus", "raw"))
def test_to_unguided_state_dict_is_the_jax_converters(mode):
    variables = unet_variables(2)
    got = compat.to_unguided_state_dict(from_jax_unguided_variables(variables), kernel_mode=mode)
    want = jcompat.to_unguided_state_dict(variables, kernel_mode=mode)
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], np.asarray(w)) for k, w in want.items())


def reference_dict(sd):
    """A reference checkpoint's state dict: DataParallel prefixes and the
    reference's dead state beside ``sd``'s keys."""
    out = {"module." + k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    out["module.step1.d_net.nconv1.bnorm.weight"] = torch.ones(8)
    out["module.rgb_encoder4.encoder.0.weight"] = torch.ones(64, 64, 3, 3)
    out["module.rgb_encoder0.encoder.1.num_batches_tracked"] = torch.tensor(3)
    return out


@pytest.mark.parametrize("mode", ("softplus_inverse", "raw"))
def test_reference_dict_converts_like_the_jax_converter(variables, mode):
    """Reference dict -> each package's converter -> each package's model:
    the deployed outputs within 1e-4."""
    ref = reference_dict(jcompat.to_guided_state_dict(variables, kernel_mode="softplus"))
    pos_fn = "softplus" if mode == "softplus_inverse" else "identity"
    jvars = jcompat.convert_guided_state_dict({k: v.numpy() for k, v in ref.items()}, kernel_mode=mode)
    model = GuidedDepthNet(step1_pos_fn=pos_fn, device="cpu")
    model.load_state_dict(compat.convert_guided_state_dict(ref, kernel_mode=mode))
    rgb, dep = selftest_frames(104, 128, batch=1, seed=3)
    with torch.no_grad():
        got = model.export(*(torch.from_numpy(np.transpose(x, (0, 2, 3, 1)).copy())
                             for x in (rgb, dep, rgb[::-1], dep[::-1])))
    want = jax_export(jvars, rgb, dep, pos_fn=pos_fn)
    for g, w in zip(got, want):
        assert np.abs(w).max() > 0 and rel(g.permute(0, 3, 1, 2).numpy(), w) <= 1e-4


def test_unguided_reference_dict_converts_like_the_jax_converter():
    variables = unet_variables(4)
    ref = {"module." + k: torch.from_numpy(np.array(v))
           for k, v in jcompat.to_unguided_state_dict(variables, kernel_mode="softplus").items()}
    ref["module.d_net.nconv2.bnorm.bias"] = torch.zeros(8)
    jvars = jcompat.convert_unguided_state_dict({k: v.numpy() for k, v in ref.items()}, kernel_mode="softplus_inverse")
    net = NConvUNet(device="cpu")
    net.load_state_dict(compat.convert_unguided_state_dict(ref, kernel_mode="softplus_inverse"))
    d = (np.random.default_rng(5).random((1, 48, 64, 1)) * (np.random.default_rng(6).random((1, 48, 64, 1)) < 0.1)
         ).astype(np.float32) * 5
    with torch.no_grad():
        got = net(torch.from_numpy(d))[0].numpy()
    want = np.asarray(JUNet().apply(jvars, jnp.asarray(d))[0])
    assert rel(got, want) <= 1e-5


def test_round_trips(state):
    """raw: bitwise; softplus then its inverse: to f32 rounding."""
    raw = compat.convert_guided_state_dict(compat.to_guided_state_dict(state, kernel_mode="raw"), kernel_mode="raw")
    assert raw.keys() == state.keys() and all(torch.equal(raw[k], v) for k, v in state.items())
    soft = compat.convert_guided_state_dict(compat.to_guided_state_dict(state, kernel_mode="softplus"),
                                            kernel_mode="softplus_inverse")
    assert soft.keys() == state.keys()
    for k, v in state.items():
        torch.testing.assert_close(soft[k], v, rtol=0, atol=1e-6)


def test_dead_state_is_dropped_and_unknown_keys_raise(state):
    ref = reference_dict(compat.to_guided_state_dict(state))
    assert compat.convert_guided_state_dict(ref).keys() == state.keys()
    with pytest.raises(KeyError, match="unrecognized"):
        compat.convert_guided_state_dict({**ref, "module.fuse0.extra.weight": torch.ones(1)})
    folded = maybe_fold(GuidedDepthNet(device="cpu"), state)[1]
    with pytest.raises(ValueError, match="unfolded"):
        compat.to_guided_state_dict(folded)
    assert compat.strip_data_parallel_prefix({"module.a": 1, "b": 2}) == {"a": 1, "b": 2}


def test_pth_tar_is_the_reference_format(state, tmp_path):
    path = compat.save_pth_tar(tmp_path / "g.pth.tar", state)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    assert set(ckpt) == {"epoch", "state_dict", "stats"}
    assert all(k.startswith("module.") for k in ckpt["state_dict"])
    sd = compat.load_pth_tar(path)
    want = jcompat.load_pth_tar(path)
    assert sd.keys() == want.keys() and all(np.array_equal(sd[k], want[k]) for k in want)


@pytest.mark.parametrize("writer", ("port", "jax"))
def test_pth_tar_loads_weights_only(variables, state, writer, tmp_path):
    """Both packages' ``.pth.tar`` writers give a file that loads with
    ``weights_only=True``, and load_pth_tar reads it to the same arrays."""
    path = str(tmp_path / "g.pth.tar")
    if writer == "port":
        compat.save_pth_tar(path, state, epoch=3, stats={"loss": [0.5, 0.25]})
    else:
        jcompat.save_pth_tar(path, variables, epoch=3, stats={"loss": [0.5, 0.25]})
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    assert (ckpt["epoch"], ckpt["stats"]) == (3, {"loss": [0.5, 0.25]})
    sd = compat.load_pth_tar(path)
    assert sd.keys() == ckpt["state_dict"].keys()
    assert all(np.array_equal(sd[k], v.numpy()) for k, v in ckpt["state_dict"].items())


class _Opaque:
    """An object outside the ``.pth.tar`` format; unpickling it would
    import and construct arbitrary code."""


def test_pth_tar_with_a_pickled_object_is_refused(state, tmp_path):
    path = str(tmp_path / "crafted.pth.tar")
    sd = {"module." + k: torch.as_tensor(np.asarray(v)) for k, v in compat.to_guided_state_dict(state).items()}
    torch.save({"epoch": 0, "state_dict": sd, "stats": _Opaque()}, path)
    with pytest.raises(Exception, match="[Ww]eights only load failed"):
        compat.load_pth_tar(path)
