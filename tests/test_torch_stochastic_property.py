"""Hypothesis property tests on the port: random stochastic DAGs against the
reference and against the Monte-Carlo oracle.

Mirrors tests/test_stochastic_property.py (a module of its own, so the rest
runs where hypothesis is absent).  For every example, the port's analytic
moments are held to the reference's at 1e-5 relative: the mean directly,
the variance relative to the E[t^2] it is cancelled from in float32 (to
2e-6 E^2, within 1e-5 of E[t^2]).  For every example
but two, each package's analytic moments are held to its own simulator at
the reference's tolerances (chain 1e-2 / 1e-2, in-tree 1.5e-2 / 8e-2).

The two exceptions are the examples on which the reference's own property
tests fail (chain: s=3, seed=19, exec_lo=1.0, rework_hi=0.125, cap=2;
in-tree: s=3, seed=0).  On them the port's analytic-vs-Monte-Carlo gap, in
the mean and in the variance, must lie within 3 Monte-Carlo standard errors
of the reference's gap.  The two failures differ in kind:

  * chain: the reference's variance gap is 1.14 %, 2.4 standard errors of
    a sample variance at 2e5 samples (a tolerance of 1e-2 is only about two
    standard errors wide there); the port's own gap is 0.02 %.  Sampling
    noise, not an analytic error: chain composition is exact in moments.
  * in-tree: the Normal-matched PERT max of bimodal (conditional) branches
    overstates the mean by 6.9 % (37 standard errors) and understates the
    variance by 44 %.  A real bias of the approximation, so the port must
    fall outside the tolerance too: it repeats the finding, it does not
    hide it.
"""
import pytest

hypothesis = pytest.importorskip("hypothesis")

import hypothesis.strategies as st
import jax
import jax.numpy as jnp
import numpy as np
import torch
from hypothesis import example, given, settings

from repro import sched as js
from repro import sim as jsim
from repro.core import frontier as jf
from repro_torch import sched as ts
from repro_torch import sim
from repro_torch.core import frontier as tf
from test_torch_stochastic import (
    _analytic_dag_moments,
    _reference_analytic,
    _stage_leaves,
    close_to_reference,
)

KNOWN_CHAIN = dict(s=3, seed=19, exec_lo=1.0, rework_hi=0.125, cap=2)
KNOWN_INTREE = dict(s=3, seed=0)
N_MC = 200_000


def _chain(s, seed, exec_lo, rework_hi, cap):
    """tests/test_stochastic_property.py's chain example, draw for draw."""
    rng = np.random.default_rng(seed)
    dag = ts.WorkflowDAG.chain(s, 3).with_stochastic(
        exec_probs=tuple(round(float(x), 3) for x in rng.uniform(exec_lo, 1.0, s)),
        rework_probs=tuple(round(float(x), 3) for x in rng.uniform(0.0, rework_hi, s)),
        max_retries=(cap,) * s,
    )
    fracs = rng.dirichlet(np.ones(3), size=s).astype(np.float32)
    return dag, fracs, _stage_leaves(seed + 100, s, 3)


def _intree(s, seed):
    """tests/test_stochastic_property.py's in-tree example, draw for draw."""
    rng = np.random.default_rng(seed)
    preds = [[] for _ in range(s)]
    for i in range(s - 1):
        preds[int(rng.integers(i + 1, s))].append(i)
    dag = ts.WorkflowDAG(preds=tuple(tuple(p) for p in preds), num_workers=3).with_stochastic(
        exec_probs=tuple(round(float(x), 3) for x in rng.uniform(0.4, 1.0, s)),
        rework_probs=tuple(round(float(x), 3) for x in rng.uniform(0.0, 0.4, s)),
        max_retries=tuple(int(c) for c in rng.integers(1, 6, s)),
    )
    fracs = rng.dirichlet(np.ones(3), size=s).astype(np.float32)
    return dag, fracs, _stage_leaves(seed + 200, s, 3)


def _samples(dag, fracs, leaves, mc_seed):
    """2e5 completion times from each package's simulator."""
    port = sim.simulate_workflow(mc_seed, dag, fracs, tf.UnitParams(*map(torch.as_tensor, leaves)),
                                 num_samples=N_MC, device="cpu")
    jdag = js.WorkflowDAG(preds=dag.preds, num_workers=dag.num_workers, exec_probs=dag.exec_probs,
                          rework_probs=dag.rework_probs, max_retries=dag.max_retries)
    ref = jsim.simulate_workflow(jax.random.PRNGKey(mc_seed), jdag, jnp.asarray(fracs),
                                 jf.UnitParams(*map(jnp.asarray, leaves)), num_samples=N_MC)
    return port.numpy().astype(np.float64), np.asarray(ref, np.float64)


def _check(dag, fracs, leaves, mc_seed, rtol_mean, rtol_var, known=None):
    """``known``: None, or "noise" / "bias" for the reference's two failing
    examples (see the module's docstring)."""
    port_a = [float(x) for x in _analytic_dag_moments(dag, fracs, tf.UnitParams(*map(torch.as_tensor, leaves)))]
    ref_a = [float(x) for x in _reference_analytic(dag, fracs, leaves)]
    close_to_reference(port_a, ref_a)
    port_t, ref_t = _samples(dag, fracs, leaves, mc_seed)
    moments = lambda t: (t.mean(), t.var())
    if known is None:
        for (e_a, v_a), t in ((port_a, port_t), (ref_a, ref_t)):
            np.testing.assert_allclose(e_a, t.mean(), rtol=rtol_mean)
            np.testing.assert_allclose(v_a, t.var(), rtol=rtol_var)
        return
    # Standard errors of a sample mean, sd / sqrt(n), and of a sample
    # variance, sqrt((m4 - v^2) / n).
    se = lambda t: (t.std() / np.sqrt(t.size),
                    np.sqrt((np.mean((t - t.mean()) ** 4) - t.var() ** 2) / t.size))
    outside = False
    for i, rtol in enumerate((rtol_mean, rtol_var)):
        gap_port = port_a[i] - moments(port_t)[i]
        gap_ref = ref_a[i] - moments(ref_t)[i]
        assert abs(gap_port - gap_ref) <= 3 * np.hypot(se(port_t)[i], se(ref_t)[i]), (i, gap_port, gap_ref)
        outside |= abs(gap_port) > rtol * abs(moments(port_t)[i])
    if known == "bias":
        assert outside, "the port hides the reference's analytic-vs-Monte-Carlo bias"


@given(
    s=st.integers(2, 4),
    seed=st.integers(0, 50),
    exec_lo=st.floats(0.25, 1.0),
    rework_hi=st.floats(0.0, 0.5),
    cap=st.integers(1, 5),
)
@example(**KNOWN_CHAIN)
@settings(max_examples=6, deadline=None, derandomize=True, database=None)
def test_random_stochastic_chain_matches_reference_and_oracle(s, seed, exec_lo, rework_hi, cap):
    """Chains with random branch/rework annotations: serial composition of
    the stochastic transforms is exact in the moments."""
    dag, fracs, leaves = _chain(s, seed, exec_lo, rework_hi, cap)
    known = dict(s=s, seed=seed, exec_lo=exec_lo, rework_hi=rework_hi, cap=cap) == KNOWN_CHAIN
    _check(dag, fracs, leaves, seed + 1000, 1e-2, 1e-2, "noise" if known else None)


@given(s=st.integers(3, 5), seed=st.integers(0, 50))
@example(**KNOWN_INTREE)
@settings(max_examples=6, deadline=None, derandomize=True, database=None)
def test_random_stochastic_intree_matches_reference_and_oracle(s, seed):
    """In-trees (branch finishes independent) with random annotations: joins
    go through the Normal-matched PERT max, so the variance tolerance is
    wider."""
    dag, fracs, leaves = _intree(s, seed)
    known = dict(s=s, seed=seed) == KNOWN_INTREE
    _check(dag, fracs, leaves, seed + 2000, 1.5e-2, 8e-2, "bias" if known else None)
