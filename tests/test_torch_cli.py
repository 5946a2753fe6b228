"""The port's command line (``python -m nconv_tpu_torch``) on the CPU
(``--device cpu``): the parser, train-step1 -> eval and train-step2 ->
infer end to end, eval and infer against the JAX package's commands on the
same weights (metrics within 1e-4 rel; dense maps within 1e-4 rel RMSE and
one uint16 step), the inferno dumps pixel-equal to the JAX package's,
bench printing the JAX command's keys, and export (pt2, onnx) and convert
(both directions, and after the JAX command's ``convert --reverse``)."""
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from nconv_tpu.cli import main as jmain
from nconv_tpu.models import GuidedDepthNet as JGuided
from nconv_tpu.cli import _SyntheticDataset as JSynthetic
from nconv_tpu.data import Loader as JLoader
from nconv_tpu.data import io as jio
from nconv_tpu.models import NConvUNet as JUNet
from nconv_tpu.runtime.streaming import FrameStats as JFrameStats
from nconv_tpu.training import evaluate as jevaluate
from nconv_tpu.training import make_unguided_predict as jmake_unguided_predict
from nconv_tpu.training import save_best as jsave_best
from nconv_tpu.utils import save_depth as jsave_depth
from nconv_tpu_torch.cli import build_parser, main
from nconv_tpu_torch.compat import read_onnx_summary
from nconv_tpu_torch.models import GuidedDepthNet, maybe_fold
from nconv_tpu_torch.runtime import load_exported
from nconv_tpu_torch.convert import from_jax_unguided_variables, from_jax_variables
from nconv_tpu_torch.data import io, png
from nconv_tpu_torch.training import load_best, save_best
from nconv_tpu_torch.utils import depth_to_inferno, save_depth
from test_torch_engine import jax_variables

UNET_LAYERS = [("nconv1", 5, 1, 8), ("nconv2", 5, 8, 8), ("nconv_down1", 5, 8, 8),
               ("nconv_down2", 5, 8, 8), ("nconv_down3", 5, 8, 8), ("nconv4", 3, 16, 8),
               ("nconv5", 3, 16, 8), ("nconv6", 3, 16, 8), ("nconv7", 1, 8, 1)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of a thread a core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def unet_variables(seed):
    rng = np.random.default_rng(seed)
    return {"params": {
        name: {"kernel": jnp.asarray(rng.random((k, k, cin, cout)).astype(np.float32)),
               "bias": jnp.full((cout,), 0.01, jnp.float32)}
        for name, k, cin, cout in UNET_LAYERS}}


def last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def write_frames(directory, n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    directory.mkdir()
    for i in range(n):
        Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(directory / f"{i}_rgb.png")
        jio.save_depth_png16(str(directory / f"{i}_depth.png"),
                             (rng.random((h, w)) * 5 * (rng.random((h, w)) < 0.1)).astype(np.float32))


SMALL = ["--dataset", "synthetic", "--height", "48", "--width", "64", "--num-workers", "0", "--device", "cpu"]


def test_parser():
    p = build_parser()
    with pytest.raises(SystemExit):
        p.parse_args([])
    for cmd in ("export", "convert"):  # their required flags
        with pytest.raises(SystemExit):
            p.parse_args([cmd])
    a = p.parse_args(["export", "--checkpoint", "c", "--out", "m.pt2"])
    assert (a.format, a.kernel_mode, a.batch, a.height, a.width, a.device, a.selftest) == (
        "pt2", "softplus", None, 480, 640, "cuda", False)
    with pytest.raises(SystemExit):
        p.parse_args(["export", "--checkpoint", "c", "--out", "m", "--format", "stablehlo"])  # pt2 replaces it
    a = p.parse_args(["convert", "--pth", "r.pth.tar", "--reverse", "--checkpoint", "c"])
    assert (a.model, a.kernel_mode, a.reverse, a.checkpoint, a.out) == (
        "guided", "softplus_inverse", True, "c", None)
    a = p.parse_args(["train-step1", "--lr", "1e-2", "1e-3", "--weight-decay", "1e-7", "1e-2",
                      "--grid-parallel", "--two-stream"])
    assert (a.lr, a.weight_decay, a.grid_parallel, a.two_stream, a.device) == (
        [1e-2, 1e-3], [1e-7, 1e-2], True, True, "cuda")
    a = p.parse_args(["train-step2", "--step1-checkpoint", "ck/s1", "--batch-reduce", "first",
                      "--precision", "bf16", "--device", "cpu"])
    assert (a.step1_checkpoint, a.batch_reduce, a.precision, a.device) == ("ck/s1", "first", "bf16", "cpu")
    a = p.parse_args(["eval", "--checkpoint", "c", "--model", "unguided", "--split", "test",
                      "--max-batches", "3", "--pos-fn", "identity"])
    assert (a.model, a.split, a.max_batches, a.pos_fn) == ("unguided", "test", 3, "identity")
    a = p.parse_args(["infer", "--checkpoint", "c", "--out-dir", "o", "--dataset", "kitti_test",
                      "--root", "r", "--mixed"])
    assert (a.dataset, a.root, a.mixed, a.height, a.width) == ("kitti_test", "r", True, 480, 640)
    a = p.parse_args(["bench", "--throughput", "--batch", "4"])
    assert (a.throughput, a.batch, a.height, a.width) == (True, 4, 352, 1216)
    a = p.parse_args(["bench", "--train", "--precision", "bf16"])
    assert (a.train, a.precision) == (True, "bf16")
    a = p.parse_args(["profile", "--mixed", "--iters", "5"])
    assert (a.mixed, a.iters, a.device) == (True, 5, "cuda")
    with pytest.raises(SystemExit):
        p.parse_args(["bench", "--backend", "pallas"])  # the device, not a backend, picks the path


def test_commands_need_the_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["bench", "--height", "48", "--width", "64", "--frames", "3"])
    with pytest.raises(SystemExit, match="evaluation-only"):
        main(["train-step1", "--dataset", "kitti_test", "--root", str(tmp_path), "--device", "cpu"])
    with pytest.raises(SystemExit, match="no ground"):
        main(["eval", "--checkpoint", "c", "--dataset", "kitti_test", "--device", "cpu"])


def test_train_step1_then_eval(tmp_path, capsys):
    ckdir = str(tmp_path / "ck")
    assert main(["train-step1", *SMALL, "--epochs", "1", "--batch-size", "2", "--limit", "4",
                 "--checkpoint-dir", ckdir, "--name", "s1"]) == 0
    assert "saved best model" in capsys.readouterr().out
    state = load_best(os.path.join(ckdir, "s1"))
    assert "nconv1.weight" in state and len(state) == 18
    assert main(["eval", *SMALL, "--limit", "2", "--checkpoint", os.path.join(ckdir, "s1"),
                 "--model", "unguided", "--batch-size", "1"]) == 0
    stats = last_json(capsys)
    assert set(stats) == {"rmse", "mae", "irmse", "imae", "delta1", "delta2", "delta3"}
    assert all(np.isfinite(v) for v in stats.values()) and stats["rmse"] > 0


def test_eval_matches_the_jax_evaluate(tmp_path, capsys):
    variables = unet_variables(1)
    ck = save_best(tmp_path, "s1", from_jax_unguided_variables(variables))
    assert main(["eval", *SMALL, "--limit", "3", "--checkpoint", ck, "--model", "unguided",
                 "--batch-size", "1", "--max-batches", "2"]) == 0
    got = last_json(capsys)
    want = jevaluate(jmake_unguided_predict(variables, JUNet()), JLoader(JSynthetic(8, 48, 64, seed=1), 1),
                     max_batches=2)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(round(want[k], 6), rel=1e-4, abs=1e-6), k


def test_train_step2_then_infer(tmp_path, capsys):
    ckdir = str(tmp_path / "ck")
    assert main(["train-step1", *SMALL, "--height", "96", "--width", "128", "--epochs", "1",
                 "--batch-size", "2", "--limit", "2", "--checkpoint-dir", ckdir, "--name", "s1"]) == 0
    assert main(["train-step2", *SMALL, "--height", "96", "--width", "128", "--epochs", "1",
                 "--batch-size", "1", "--limit", "2", "--checkpoint-dir", ckdir, "--name", "g",
                 "--step1-checkpoint", os.path.join(ckdir, "s1")]) == 0
    s1, g = load_best(os.path.join(ckdir, "s1")), load_best(os.path.join(ckdir, "g"))
    for k, v in s1.items():  # step 1 stays frozen
        assert torch.equal(g[f"step1.{k}"], v), k
    write_frames(tmp_path / "frames", 3, 96, 128)
    out = tmp_path / "out"
    assert main(["infer", "--checkpoint", os.path.join(ckdir, "g"), "--device", "cpu",
                 "--rgb-glob", str(tmp_path / "frames" / "*_rgb.png"),
                 "--depth-glob", str(tmp_path / "frames" / "*_depth.png"),
                 "--out-dir", str(out), "--height", "96", "--width", "128"]) == 0
    assert sorted(os.listdir(out)) == sorted(f"{i}_rgb_{s}.png" for i in range(3) for s in ("depth", "vis"))
    for i in range(3):
        dense = io.load_depth_png16(str(out / f"{i}_rgb_depth.png"))
        assert dense.shape == (96, 128) and np.isfinite(dense).all() and dense.max() > 0
        vis = png.read(out / f"{i}_rgb_vis.png")
        assert vis.samples.shape == (96, 128, 3) and vis.samples.dtype == np.uint8


def test_infer_matches_the_jax_infer(tmp_path):
    """f32: the decoded maps within 1e-4 rel RMSE and one uint16 step of the
    JAX command's. ``--mixed``: no further from the JAX f32 maps than twice
    the JAX command's own mixed maps (the bar of tests/test_torch_runtime.py)."""
    variables = jax_variables()
    ck_jax = jsave_best(str(tmp_path), "jax_ck", variables)
    ck = save_best(tmp_path, "port_ck", from_jax_variables(variables))
    write_frames(tmp_path / "frames", 3, 96, 128, seed=4)  # an odd frame fills both streams
    flags = ["--rgb-glob", str(tmp_path / "frames" / "*_rgb.png"),
             "--depth-glob", str(tmp_path / "frames" / "*_depth.png"), "--height", "96", "--width", "128"]
    maps = {}
    for mixed in ([], ["--mixed"]):
        jdir, pdir = tmp_path / f"jax{len(mixed)}", tmp_path / f"port{len(mixed)}"
        assert jmain(["infer", "--checkpoint", ck_jax, "--out-dir", str(jdir), *flags, *mixed]) == 0
        assert main(["infer", "--checkpoint", ck, "--out-dir", str(pdir), "--device", "cpu", *flags, *mixed]) == 0
        for i in range(3):
            name = f"{i}_rgb_depth.png"
            maps[len(mixed), i] = (png.read(pdir / name).samples.astype(np.int64),
                                   np.asarray(Image.open(jdir / name)).astype(np.int64))
    for i in range(3):
        got, want = maps[0, i]
        assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want), i
        assert np.abs(got - want).max() <= 1, i
        got_mixed, jax_mixed = maps[1, i]
        assert 0 < np.linalg.norm(got_mixed - want) <= 2 * np.linalg.norm(jax_mixed - want), i


def test_save_depth_is_pixel_equal_to_the_jax_dump(tmp_path):
    rng = np.random.default_rng(5)
    for i, d in enumerate([rng.random((1, 17, 23, 1)).astype(np.float32) * 9,
                           np.linspace(-2, 7, 391, dtype=np.float32).reshape(17, 23),
                           np.full((5, 6), 3.0, np.float32)]):  # flat: all zeros
        save_depth(d, tmp_path / f"p{i}.png")
        jsave_depth(d, str(tmp_path / f"j{i}.png"))
        want = np.asarray(Image.open(tmp_path / f"j{i}.png"))
        np.testing.assert_array_equal(png.read(tmp_path / f"p{i}.png").samples, want)
        np.testing.assert_array_equal(depth_to_inferno(d.reshape(want.shape[:2])), want)


def test_bench_prints_the_jax_commands_keys(capsys):
    # the keys of nconv_tpu/cli.py:cmd_bench's line: nconv_tpu.runtime.benchmark's
    # three clocks, each a FrameStats.as_dict()
    stats_keys = JFrameStats(1.0, 1.0, 1.0, 1.0, 1.0, 1).as_dict().keys()
    assert main(["bench", "--device", "cpu", "--height", "48", "--width", "64", "--frames", "3"]) == 0
    got = last_json(capsys)
    assert set(got) == {"device", "synced", "e2e"}
    for k in got:
        assert got[k].keys() == stats_keys and got[k]["fps"] > 0, k
    assert main(["bench", "--device", "cpu", "--height", "48", "--width", "64", "--throughput",
                 "--batch", "1"]) == 0
    got = last_json(capsys)
    assert set(got) == {"throughput_fps", "batch"} and got["throughput_fps"] > 0
    assert main(["bench", "--device", "cpu", "--height", "48", "--width", "64", "--train"]) == 0
    got = last_json(capsys)
    # the keys of nconv_tpu/cli.py:_bench_train's line
    assert set(got) == {"backend", "height", "width", "precision", "unguided_train_ms_per_batch",
                        "unguided_batch_size", "guided_train_ms_per_batch", "guided_batch_size"}
    assert got["backend"] == "cpu" and got["guided_train_ms_per_batch"] > 0


def guided_inputs(b, h, w, seed):
    """NHWC f32 (rgb, depth) with a smooth sparse depth."""
    rng = np.random.default_rng(seed)
    i, j = np.mgrid[0:h, 0:w]
    truth = (5 + 3 * np.sin(i / 9) + 2 * np.cos(j / 11)).astype(np.float32)[None, :, :, None]
    return ((rng.random((b, h, w, 3)) * 255).astype(np.float32),
            (truth * (rng.random((b, h, w, 1)) < 0.06)).astype(np.float32))


def test_export_pt2_serves_the_eager_export(tmp_path, capsys):
    """``export`` (pt2, the default): the folded net's program, reloaded,
    serves b = 1 and 2 within 1e-6 of the eager export; its selftest runs;
    without ``--device cpu`` it needs the card."""
    state = from_jax_variables(jax_variables())
    ck = save_best(tmp_path, "g", state)
    argv = ["export", "--checkpoint", ck, "--out", str(tmp_path / "g.pt2"), "--height", "104", "--width", "128"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)
    assert main([*argv, "--device", "cpu", "--selftest"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("selftest: reloaded")
    call = load_exported(tmp_path / "g.pt2")
    model, folded = maybe_fold(GuidedDepthNet(device="cpu"), state)
    model.load_state_dict(folded)
    for b in (1, 2):
        rgb, d = (torch.from_numpy(a) for a in guided_inputs(b, 104, 128, b))
        for g, w in zip(call(rgb, d, rgb, d), model.export(rgb, d, rgb, d)):
            assert g.shape == (b, 104, 128, 1) and float((g - w).norm() / w.norm()) <= 1e-6


def test_export_onnx_with_selftest(tmp_path, capsys):
    ck = save_best(tmp_path, "g", from_jax_variables(jax_variables()))
    out = tmp_path / "g.onnx"
    assert main(["export", "--checkpoint", ck, "--out", str(out), "--height", "128", "--width", "160",
                 "--format", "onnx", "--selftest"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith(f"exported deployment ONNX to {out}") and "executed by the numpy executor" in lines[-1]
    s = read_onnx_summary(str(out))
    assert (s["opset"], s["inputs"], s["outputs"]) == (17, ["rgb_0", "depth_0", "rgb_1", "depth_1"],
                                                      ["output_depth_0", "output_depth_1"])


def test_convert_reverse_roundtrip(tmp_path):
    """convert --reverse writes a reference .pth.tar that convert maps back
    to the state written; each direction refuses a missing destination."""
    state = from_jax_variables(jax_variables())
    ck = save_best(tmp_path, "g", state)
    pth = str(tmp_path / "ours.pth.tar")
    assert main(["convert", "--reverse", "--pth", pth]) == 2
    assert main(["convert", "--reverse", "--checkpoint", ck, "--pth", pth]) == 0
    ckpt = torch.load(pth, map_location="cpu", weights_only=True)
    assert set(ckpt) == {"epoch", "state_dict", "stats"}
    assert all(k.startswith("module.") for k in ckpt["state_dict"])
    assert main(["convert", "--pth", pth]) == 2
    assert main(["convert", "--pth", pth, "--out", str(tmp_path / "back")]) == 0
    back = load_best(tmp_path / "back")
    assert back.keys() == state.keys()
    for k, v in state.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=1e-6)


def test_jax_reverse_then_port_convert_serves_the_jax_depth(tmp_path):
    """A JAX checkpoint through the JAX command's ``convert --reverse``, then
    the port's ``convert``: the port's model serves the JAX model's depth
    (1e-4 rel RMSE, the f32 guided bar)."""
    variables = jax_variables()
    jck = jsave_best(str(tmp_path), "jax_g", variables)
    pth = str(tmp_path / "ref.pth.tar")
    assert jmain(["convert", "--reverse", "--checkpoint", jck, "--pth", pth]) == 0
    assert main(["convert", "--pth", pth, "--out", str(tmp_path / "port_g")]) == 0
    model = GuidedDepthNet(device="cpu")
    model.load_state_dict(load_best(tmp_path / "port_g"))
    rgb, d = guided_inputs(1, 104, 128, 9)
    with torch.no_grad():
        got = model.export(*(torch.from_numpy(a) for a in (rgb, d, rgb, d)))
    want = JGuided().apply(variables, rgb, d, rgb, d, method=JGuided.export)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float64)
        assert np.abs(w).max() > 0
        assert np.linalg.norm(g.double().numpy() - w) <= 1e-4 * np.linalg.norm(w)
