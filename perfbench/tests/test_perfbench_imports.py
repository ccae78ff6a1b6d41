"""What a run loads, and how the harness refuses to run."""
from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT

CHECK = r"""
import sys, time
sys.path[:0] = [{root!r}, {src!r}]
from pathlib import Path
from perfbench import harness, controls, readers
from perfbench.drivers import fleet, serve
from perfbench.reference import fleet as rf, llama
import perfbench.counts.k1, perfbench.counts.k2, perfbench.counts.dense_lm
for p in sorted(Path({root!r}, "perfbench", "metrics").glob("*.py")):
    harness.load_file_module(p)
import repro_torch.serve, repro_torch.sched, repro_torch.models.model_zoo
import repro_torch.train.serve_step, repro_torch.models.layers, repro_torch.configs.base
import repro_torch.core.gibbs, repro_torch.kernels
print(harness.forbidden_modules())
"""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    code = CHECK.format(root=str(ROOT), src=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_forbidden_names_are_compared_whole():
    from perfbench import harness

    sys.modules.setdefault("repro_torch_lookalike_for_test", sys)
    found = harness.forbidden_modules()
    assert "repro_torch" not in found and "repro_torch_lookalike_for_test" not in found
    assert set(harness.FORBIDDEN) == {"jax", "jaxlib", "flax", "repro"}


def test_the_references_import_nothing_of_the_program():
    for path in (ROOT / "perfbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("repro", "repro_torch", "jax", "perfbench"), (path, n)


def _run(cwd, env_extra=None, workload="fleet-100k.gated"):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload", workload, "--seed",
                           str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, env=env, timeout=300)


def test_without_a_card_the_run_fails_and_prints_no_result():
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA card" in out.stderr


def test_the_benchmark_alone_does_not_run(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_the_result_line_puts_the_checks_last():
    """The harness prints ``checks`` as the last key of its line."""
    src = (ROOT / "perfbench" / "harness.py").read_text()
    assert src.index('line["checks"] = ') > src.index('line["breakdown"] = ')
    line = json.loads(json.dumps(dict(correct=True, metrics={}, checks={})))
    assert list(line)[-1] == "checks"
