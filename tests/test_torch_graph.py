"""The engine's CUDA graph on the card: the mixed two-stream frame at 96x128
captured once and replayed, bitwise equal to the eager frame on the same
staged wires, with the capture's launches those of one eager frame and a
fresh result each request. It needs the card and skips without one; it
imports no JAX, so it runs where the kernels do:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_graph.py
"""
import numpy as np
import pytest
import torch

from nconv_tpu_torch import kernels
from nconv_tpu_torch.models import GuidedDepthNet
from nconv_tpu_torch.runtime import StreamingEngine

H, W = 96, 128


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph and the kernels have no CPU form")
    return torch.device("cuda")


def frames(seed, n):
    rng = np.random.default_rng(seed)
    return [tuple(a for _ in range(2) for a in ((rng.random((H, W, 3)) * 255).astype(np.float32),
                                                (rng.random((H, W)) * 80 * (rng.random((H, W)) < 0.06))
                                                .astype(np.float32)))
            for _ in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("wire", [{}, dict(rgb_wire="yuv422", depth_wire="coo")], ids=["dense", "yuv422_coo"])
def test_graph_replay_is_bitwise_the_eager_mixed_frame(card, wire):
    state = GuidedDepthNet(device=card, seed=0).state_dict()
    eng = StreamingEngine(state, height=H, width=W, compute_dtype=torch.bfloat16, device=card, **wire)
    assert eng.capture_counts["nconv"] == 9 and eng.capture_counts["conv_chain_tc"] == 4
    outs = [(f, eng(*f)) for f in frames(8, 3)]
    for f, out in outs:
        kernels.reset_launch_counts()
        ref = eng.forward_staged(eng.stage(*f))
        assert {k: n for k, n in kernels.launch_counts().items() if n} == eng.capture_counts
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
    assert not torch.equal(outs[0][1][0], outs[1][1][0])
    got = list(eng.run(iter(f for f, _ in outs), depth=1, stage_ahead=2))
    for (_, out), res in zip(outs, got):
        assert all(torch.equal(a, b) for a, b in zip(out, res))
