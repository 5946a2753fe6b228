"""``BENCHMARK.json`` and the files it names, found by name.

A cell is one entry of ``workloads``. Its configuration is the JSON file
the configuration's ``file`` names; its traffic mix is
``benchmark/traffic/<traffic>.json``; its loop is the one the traffic names
(``"loop"``): one of :data:`.cells.LOOPS`, or else a loop file
``benchmark/loops/<loop>.py`` (:meth:`Cell.loop`); each per-layer metric it
reports is a reader in ``benchmark/metrics/<metric name>.py`` (a function
``read(traced)`` returning a number, or ``None`` where it finds nothing to
read). All are looked up under one root, the checkout's, so a later cell,
configuration, model, loop, traffic mix or metric is a new file and a new
entry, with no file edited.
"""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    root: Path

    def reader(self, metric: str):
        """The ``read`` function of per-layer metric ``metric``."""
        return _module(self.root / "benchmark" / "metrics" / f"{metric}.py", "benchmark_metric_", metric).read

    def loop(self):
        """The loop class of the cell's traffic (``"loop"``): the one of
        :data:`.cells.LOOPS` by that name (``stream``, ``request``,
        ``train``), else the ``LOOP`` of ``benchmark/loops/<loop>.py``.

        A loop file brings a model or a kind of load that the built-in
        loops do not run. It may import ``benchmark.cells``, ``check``,
        ``generate``, ``trace``, ``weights``, ``work`` and
        ``benchmark.reference``, and defines:

          * ``LOOP(cfg, traffic, seed, device)``: the set-up (inputs and
            weights from the seed; the program built and warmed on every
            shape the window uses). It leaves ``phases`` (a
            :class:`.cells.Phases`) and ``work``, the :class:`.work.Work`
            of one unit, which the loop file counts itself (from
            ``work.Work`` and ``work.conv_flops``, or a module of its own):
            ``work.WORK`` knows only the built-in models;
          * ``LOOP.window(seconds, trace_on)``: the measured window; returns
            a :class:`.cells.Window` with the cell's end-to-end values and,
            traced, the profiled slice (:func:`.trace.profile`);
          * ``LOOP.release()``: frees the program's state;
          * ``LOOP.check()``: ``{name: reading}`` of what the window
            produced against the plain reference, which :func:`.check.judge`
            holds to the configuration's ``correct.limits``;
          * ``control(cell, seed, device)``: ``{kind: readings}``, the
            control (and any fault) in the program's place, for
            :func:`.calibrate.control_readings`.
        """
        from . import cells

        name = self.traffic["loop"]
        return cells.LOOPS[name] if name in cells.LOOPS else self.loop_file().LOOP

    def loop_file(self):
        """The module ``benchmark/loops/<loop>.py`` of the cell's traffic."""
        from . import cells

        name = self.traffic["loop"]
        path = self.root / "benchmark" / "loops" / f"{name}.py"
        if not path.is_file():
            raise SystemExit(f"unknown loop {name!r} of traffic {self.traffic_name!r}: not in benchmark.cells.LOOPS "
                             f"{sorted(cells.LOOPS)} and no file {path}")
        return _module(path, "benchmark_loop_", name)


def _module(path: Path, prefix: str, name: str):
    spec = importlib.util.spec_from_file_location(prefix + re.sub(r"\W", "_", name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _for_cell(metrics: list[dict], cell: str, moved: set[str] | None = None) -> list[dict]:
    """The metrics that ``cell`` reports: those listing it, and those with no
    list that move an end-to-end metric the cell reports (``moved``)."""
    out = []
    for m in metrics:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif moved is None or m["moves"] in moved:
            out.append(m)
    return out


def load(root, workload: str) -> Cell:
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = _for_cell(bench["end_to_end"], workload)
    per_layer = _for_cell(bench["per_layer"], workload, {m["name"] for m in e2e})
    return Cell(workload, w["chips"], w["config"], config, w["traffic"], traffic, e2e, per_layer, root)
