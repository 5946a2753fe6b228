"""What a run loads: no module whose whole top-level name is ``jax``,
``jaxlib``, ``flax`` or ``nconv_tpu`` (``nconv_tpu_torch`` is another
name), and the references load nothing of ``nconv_tpu_torch``."""
from __future__ import annotations

import json
import subprocess
import sys

from conftest import REPO, make_root

PROBE = """
import json, sys, time
before = set(sys.modules)
{body}
print(json.dumps(sorted({{m.split(".", 1)[0] for m in set(sys.modules) - before}})))
"""


def _loaded(body: str, cwd) -> set[str]:
    out = subprocess.run([sys.executable, "-c", PROBE.format(body=body)], cwd=cwd, capture_output=True,
                         text=True, timeout=300, env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_cell_run_loads_no_jax_and_not_the_jax_package(tmp_path):
    root = make_root(tmp_path / "checkout")
    body = ("from benchmark import spec, run\n"
            "r = run.run_cell(spec.load('.', 'kitti-mixed-request'), 1, 0.2, False, 'cpu', time.time())\n"
            "assert r['correct'] and run.forbidden_modules() == []")
    loaded = _loaded(body, root)
    assert "nconv_tpu_torch" in loaded and "torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "nconv_tpu"}


def test_the_references_load_nothing_of_the_port():
    loaded = _loaded("import benchmark.reference.guided, benchmark.reference.step1, benchmark.check", REPO)
    assert "torch" in loaded
    assert not loaded & {"nconv_tpu_torch", "nconv_tpu", "jax", "jaxlib", "flax"}
