"""``examples/train_hetero_torch.py`` and ``examples/elastic_failover_torch.py``
on the CPU.

Both scripts run as a user runs them, ``--device cpu``, as subprocesses on
one thread, with their checkpoints under ``tmp_path``.  ``train_hetero``
at ``--small --steps 24`` must meet ``chip_smoke.py``'s conditions: finite
losses, the last decile's mean loss below the first's, the last quarter's
simulated makespan below the first's, at least one split, and in the last
split the slow worker (22 s a unit) with no more microbatches than any
other.  ``elastic_failover`` must raise a straggler event for worker 1,
shrink the fleet to 2, resume at step 48 with mu restored bitwise, and
pass the reference's cold-start assert (pooled <= global / 2).  Phase 5's
schedulers each start from a copy of the fleet's generator: the fleet's
state is left bitwise as it was.
"""
import ast
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch


ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))
import elastic_failover_torch as elastic  # noqa: E402
import train_hetero_torch as hetero  # noqa: E402

ENV = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread: the suite's worker processes would oversubscribe
    the cores (tests/test_torch_dag.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(script, *argv):
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / script), *argv], cwd=ROOT,
                          env=ENV, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.splitlines()


def _numbers(line):
    return [float(x) for x in re.findall(r"-?\d+\.\d+", line)]


def test_train_hetero_small_runs_on_the_cpu_and_rebalances(tmp_path):
    lines = _run("train_hetero_torch.py", "--small", "--steps", "24", "--device", "cpu",
                 "--ckpt-dir", str(tmp_path / "ckpt"))
    assert lines[0] == "training smollm-135m-smoke: ~2L d=64 steps=24 microbatches=8"
    first, last = _numbers(next(line for line in lines if line.startswith("loss:")))
    assert np.isfinite([first, last]).all() and last < first
    splits = [np.asarray(ast.literal_eval(line.split("(")[0].strip().replace(" ", ",")))
              for line in lines if "(true speeds" in line]
    assert splits and all(s.sum() == hetero.MICROBATCHES for s in splits)
    assert splits[-1][3] <= splits[-1].min()  # the 22-s/unit worker
    makespan = next(line for line in lines if line.startswith("simulated step makespan:"))
    m_first, m_last = _numbers(makespan)[:2]
    assert m_last < m_first
    # a checkpoint every steps // 3: steps 8, 16 and 24
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        f"step_{s:08d}" for s in (8, 16, 24)]


def test_elastic_failover_runs_on_the_cpu_through_its_five_phases(tmp_path):
    lines = _run("elastic_failover_torch.py", "--device", "cpu", "--ckpt-dir",
                 str(tmp_path / "ckpt"))
    text = "\n".join(lines)
    assert "straggler events: {'type': 'straggler', 'workers': [1]}" in text
    assert "fleet size now 2 " in text and "'failure', 'evict'" in text
    assert "resumed at step 48; beliefs restored bit-exactly" in text
    pooled, glob = (int(re.search(rf"{label} prior admit: (\d+) observations", text).group(1))
                    for label in ("pooled", "global"))
    assert pooled <= glob / 2
    assert f"cold-start transfer: {pooled} vs {glob} obs" in text


def _tensors(tree):
    """Every tensor of a (nested) NamedTuple state, the generator left out."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [t for x in tree for t in _tensors(x)]
    return []


def test_cold_start_leaves_the_fleet_untouched_and_starts_both_from_its_stream():
    fleet = elastic.warm_fleet("cpu")
    before = [t.clone() for t in _tensors(fleet.state)]
    stream = fleet.state.generator.get_state()
    out = elastic.cold_start(fleet, "cpu")
    after = _tensors(fleet.state)
    assert len(after) == len(before) > 10
    for got, want in zip(after, before):
        assert torch.equal(got, want)
    assert torch.equal(fleet.state.generator.get_state(), stream)
    for label in ("pooled", "global"):
        assert torch.equal(out["starts"][label], stream), label
    assert out["obs"]["pooled"] <= out["obs"]["global"] / 2


def test_own_stream_copies_the_generator_and_shares_the_rest():
    fleet = elastic.warm_fleet("cpu")
    copy = elastic.own_stream(fleet.state)
    assert copy.generator is not fleet.state.generator
    assert copy.gibbs is fleet.state.gibbs and copy.ewma_ll is fleet.state.ewma_ll
    torch.rand(3, generator=copy.generator)  # the copy advances alone
    assert not torch.equal(copy.generator.get_state(), fleet.state.generator.get_state())


@pytest.mark.parametrize("example", [hetero, elastic])
def test_examples_refuse_to_run_without_a_card_unless_asked(example, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main(["--ckpt-dir", str(tmp_path)])
