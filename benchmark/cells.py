"""The loops a traffic file names (``"loop"``), each the program under
one kind of load. A loop's constructor is the set-up (inputs and weights
from the seed, the program built and warmed on every shape the window
uses); :meth:`window` measures; :meth:`release` frees the program's state;
:meth:`check` then compares what the window produced with the plain
reference.

  * ``stream``: frames replayed from a ring as fast as the engine takes
    them, through ``StreamingEngine.run`` (staging threads, frames in
    flight); ``frames_per_s`` over the window.
  * ``request``: one client, closed loop: ``engine(*frame)`` and a
    synchronize before the next; ``request_p50_ms`` and ``request_p95_ms``
    over every request of the window. Traced, a request is the public
    ``stage()`` and ``replay()``, each timed to its synchronize.
  * ``train``: ``Trainer.train_step`` back to back on batches fed by
    ``prefetch_to_device``, no synchronize until the window ends;
    ``step_ms`` is the window over its steps.

The program is reached only through its public entry points; nothing here
reads its weights or state back but its outputs, its losses and the
optimizer's moments after the first step.
"""
from __future__ import annotations

import itertools
import sys
import time

import numpy as np
import torch

from . import generate, trace, weights, work
from .check import serving_readings, training_readings

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Reservoir:
    """A uniform sample of ``k`` of a stream of unknown length, drawn from
    the seed (Algorithm R)."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.items = k, generate.rng_of(seed, 3), 0, []

    def offer(self, item):
        if self.seen < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


class Phases:
    """Wall seconds of each named part of a set-up, for standard error."""

    def __init__(self):
        self.t, self.parts = time.perf_counter(), {}

    def mark(self, name):
        now = time.perf_counter()
        self.parts[name] = now - self.t
        self.t = now


class Window:
    """What a window measured: its end-to-end values, the units it
    attempted (an error stops the run, so none fails and returns), and the
    profiled slice of a traced run."""

    def __init__(self, values, attempted, traced=None):
        self.values, self.attempted, self.traced = values, attempted, traced


def _split(seconds: float, trace_on: bool) -> tuple[float, float]:
    """The window's time before and after the profiled slice."""
    return (0.4 * seconds, 0.6 * seconds) if trace_on else (seconds, 0.0)


def guided_state(seed, device) -> dict:
    """The seed's unfolded weights of the guided network."""
    from nconv_tpu_torch.models import GuidedDepthNet

    return weights.make({k: v.shape for k, v in GuidedDepthNet(device="cpu").state_dict().items()}, seed, device)


def step1_state(cfg, seed, device) -> dict:
    """The seed's weights of the step-1 densifier."""
    from nconv_tpu_torch.models import NConvUNet

    model = NConvUNet(cfg["channels"], cfg["pos_fn"], device="cpu")
    return weights.make({k: v.shape for k, v in model.state_dict().items()}, seed, device)


class _Serving:
    """A ``StreamingEngine`` of the configuration on the seed's weights, and
    the seed's ring of frames."""

    def __init__(self, cfg, traffic, seed, device):
        from nconv_tpu_torch.runtime import StreamingEngine

        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.phases = Phases()
        self.frames = generate.frames(traffic["frames"], cfg["height"], cfg["width"], seed)
        self.phases.mark("frames")
        self.state = guided_state(seed, device)
        self.phases.mark("weights")
        self.engine = StreamingEngine(
            {k: v.clone() for k, v in self.state.items()}, height=cfg["height"], width=cfg["width"],
            compute_dtype=DTYPES[cfg["feature_dtype"]], rgb_wire=cfg["rgb_wire"],
            rgb_wire_dtype=np.dtype(cfg["rgb_wire_dtype"]), depth_wire=cfg["depth_wire"],
            depth_wire_dtype=np.dtype(cfg["depth_wire_dtype"]), fold_bn=cfg["fold_bn"], device=device)
        served = sum(p.numel() for p in self.engine.model.parameters())
        if served != cfg["parameters_folded"]:
            raise SystemExit(f"the engine serves {served} parameters, the configuration states "
                             f"{cfg['parameters_folded']}")
        self.phases.mark("engine")
        self.work = work.of(cfg)
        self.sample = Reservoir(traffic["check_sample"], seed)
        self.n = 0  # units so far in the window; unit i serves frames[i % ring]

    def release(self):
        del self.engine
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        return serving_readings(self.cfg, self.state, self.frames, self.sample.items, self.device)

    def _keep(self, out):
        self.sample.offer((self.n % len(self.frames), out))
        self.n += 1


class Stream(_Serving):
    def __init__(self, cfg, traffic, seed, device):
        super().__init__(cfg, traffic, seed, device)
        for _ in self.engine.run(itertools.islice(itertools.cycle(self.frames), traffic["warm_units"]),
                                 **traffic["run"]):
            pass
        _sync(device)
        self.phases.mark("warm")

    def _frames(self, stop):
        i = self.n
        while stop(i):
            yield self.frames[i % len(self.frames)]
            i += 1

    def _run(self, stop):
        count = 0
        for out in self.engine.run(self._frames(stop), **self.traffic["run"]):
            self._keep(out)
            count += 1
        return count

    def _timed(self, seconds):
        """Frames sent for ``seconds``, then none; the clock is read once
        all that was sent has finished."""
        t0 = time.perf_counter()
        n = self._run(lambda i: time.perf_counter() - t0 < seconds)
        sent = time.perf_counter()
        _sync(self.device)
        end = time.perf_counter()
        print(f"stream: {n} frames in {end - t0:.3f} s, of which {end - sent:.3f} s the drain", file=sys.stderr)
        return n, end - t0

    def window(self, seconds, trace_on):
        before, after = _split(seconds, trace_on)
        n, wall = self._timed(before)
        traced = None
        if trace_on:
            k = self.traffic["trace_units"]
            end = self.n + k
            traced = trace.profile(lambda: self._run(lambda i: i < end), k, self.work,
                                   lambda: _sync(self.device))
            n2, wall2 = self._timed(after)
            traced.unit_s = (wall + wall2) / (n + n2)
            n, wall = n + k + n2, wall + traced.window_s + wall2
        return Window({"frames_per_s": n / wall}, n, traced=traced)


class Request(_Serving):
    def __init__(self, cfg, traffic, seed, device):
        super().__init__(cfg, traffic, seed, device)
        for i in range(traffic["warm_units"]):
            frame = self.frames[i % len(self.frames)]
            self.engine(*frame)
            self.engine.replay(self.engine.stage(*frame))
            _sync(device)
        self.phases.mark("warm")

    def _request(self):
        self._keep(self.engine(*self.frames[self.n % len(self.frames)]))
        _sync(self.device)

    def _staged(self, spans):
        frame = self.frames[self.n % len(self.frames)]
        t0 = time.perf_counter()
        with torch.profiler.record_function("stage"):
            wire = self.engine.stage(*frame)
            _sync(self.device)
        t1 = time.perf_counter()
        with torch.profiler.record_function("replay"):
            self._keep(self.engine.replay(wire))
            _sync(self.device)
        t2 = time.perf_counter()
        if spans is not None:
            spans["stage"].append((t1 - t0) * 1e3)
            spans["replay"].append((t2 - t1) * 1e3)

    def window(self, seconds, trace_on):
        before, after = _split(seconds, trace_on)
        lat, spans = [], {"stage": [], "replay": []}
        call = (lambda: self._staged(spans)) if trace_on else self._request
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < before:
            t = time.perf_counter()
            call()
            lat.append(time.perf_counter() - t)
        traced = None
        if trace_on:
            k = self.traffic["trace_units"]

            def run_slice():
                for _ in range(k):
                    self._staged(None)

            traced = trace.profile(run_slice, k, self.work, lambda: _sync(self.device))
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < after:
                t = time.perf_counter()
                call()
                lat.append(time.perf_counter() - t)
            traced.unit_s = sum(lat) / len(lat)
            traced.spans = spans
        ms = np.asarray(lat) * 1e3
        values = {"request_p50_ms": float(np.percentile(ms, 50)), "request_p95_ms": float(np.percentile(ms, 95))}
        return Window(values, len(lat) + (traced.units if traced else 0), traced=traced)


class Train:
    """``Trainer(UnguidedTask(NConvUNet))`` on the seed's weights, fed the
    seed's ring of batches through ``prefetch_to_device``. Set-up drives
    the trainer through its first three steps, the ones the check
    compares, then hands the same trainer to the window."""

    CHECKED_STEPS = 3

    def __init__(self, cfg, traffic, seed, device):
        from nconv_tpu_torch.data import prefetch_to_device
        from nconv_tpu_torch.models import NConvUNet
        from nconv_tpu_torch.training import OptimizerConfig, TrainConfig, Trainer, UnguidedTask

        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.phases = Phases()
        opt = cfg["optimizer"]
        if opt["name"] != "adamw" or tuple(opt["betas"]) != (0.9, 0.999) or opt["eps"] != 1e-8:
            raise SystemExit("the trainer's AdamW has betas (0.9, 0.999) and eps 1e-8")
        self.batches = generate.batches(traffic["batches"], cfg["batch"], cfg["height"], cfg["width"], seed)
        self.phases.mark("batches")
        model = NConvUNet(cfg["channels"], cfg["pos_fn"], device=device)
        self.state = step1_state(cfg, seed, device)
        model.load_state_dict({k: v.clone() for k, v in self.state.items()})
        if sum(p.numel() for p in model.parameters()) != cfg["parameters"]:
            raise SystemExit("the model's parameter count is not the configuration's")
        tcfg = TrainConfig(batch_size=cfg["batch"], use_gradient_loss=cfg["loss"]["gradient_loss"],
                           optimizer=OptimizerConfig("adamw", opt["lr"], opt["weight_decay"]))
        self.trainer = Trainer(UnguidedTask(model), tcfg, log_fn=lambda msg: None, device=device)
        self.feed = prefetch_to_device(itertools.cycle(self.batches), device, traffic["prefetch_depth"])
        self.work = work.of(cfg)
        self.phases.mark("trainer")

        params = dict(model.named_parameters())
        start = {n: p.detach().clone() for n, p in params.items()}
        losses = [self.trainer.train_step(next(self.feed))]
        moments = self.trainer.optimizer.state  # empty for a leaf the step left alone
        self.first_grad = {n: float(moments.get(p, {}).get("exp_avg", torch.zeros(())).norm()) / (1 - opt["betas"][0])
                           for n, p in params.items()}
        for _ in range(self.CHECKED_STEPS - 1):
            losses.append(self.trainer.train_step(next(self.feed)))
        self.update = {n: float((p.detach() - start[n]).norm()) for n, p in params.items()}
        self.losses = [float(v) for v in losses]
        self.phases.mark("checked_steps")
        for _ in range(traffic["warm_units"]):
            self.trainer.train_step(next(self.feed))
        _sync(device)
        self.phases.mark("warm")

    def _steps(self, stop):
        n = 0
        while stop(n):
            with torch.profiler.record_function("train_step"):
                self.trainer.train_step(next(self.feed))
            n += 1
        return n

    def _timed(self, seconds):
        t0 = time.perf_counter()
        n = self._steps(lambda _: time.perf_counter() - t0 < seconds)
        _sync(self.device)
        return n, time.perf_counter() - t0

    def window(self, seconds, trace_on):
        before, after = _split(seconds, trace_on)
        n, wall = self._timed(before)
        traced = None
        if trace_on:
            k = self.traffic["trace_units"]
            traced = trace.profile(lambda: self._steps(lambda i: i < k), k, self.work,
                                   lambda: _sync(self.device))
            n2, wall2 = self._timed(after)
            traced.unit_s = (wall + wall2) / (n + n2)
            n, wall = n + k + n2, wall + traced.window_s + wall2
        return Window({"step_ms": 1e3 * wall / n}, n, traced=traced)

    def release(self):
        self.feed.close()
        del self.trainer, self.feed
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        program = {"loss": self.losses, "grad": self.first_grad, "update": self.update}
        return training_readings(self.cfg, self.state, self.batches[: self.CHECKED_STEPS], program, self.device)


LOOPS = {"stream": Stream, "request": Request, "train": Train}

