"""``BENCHMARK.json`` and the files it names, found by name.

A cell is one entry of ``workloads``. Its configuration is the JSON file
the configuration's ``file`` names; its traffic mix is
``benchmark/traffic/<traffic>.json``; each per-layer metric it reports is a
reader in ``benchmark/metrics/<metric name>.py`` (a function ``read(traced)``
returning a number, or ``None`` where it finds nothing to read). All are
looked up under one root, the checkout's, so a later cell, configuration,
traffic mix or metric is a new file and a new entry, with no file edited.
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
        path = self.root / "benchmark" / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location("benchmark_metric_" + re.sub(r"\W", "_", metric), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


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
