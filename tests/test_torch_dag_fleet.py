"""Port parity: ``propose_dag(params=)`` on ``chip_smoke.py`` phase 11's
8-stage workflow topology, against the reference.

Split from tests/test_torch_dag.py (whose helpers, and its one-thread
fixture, it imports) so that the suite's workers, which take one file each,
run these four cases beside the rest of that file instead of after it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import sched as js
from repro.core import frontier as jf
from repro_torch import sched as ts
from repro_torch.core import frontier as tf
from test_torch_dag import T, _assert_proposals_close, one_torch_thread  # noqa: F401 (autouse)


FLEET_EDGES = ((0, 1), (0, 2), (0, 3), (1, 4), (2, 4), (3, 4), (4, 5), (4, 6), (5, 7), (6, 7))
FLEET_SCALE = np.asarray((0.4, 1.6, 1.0, 0.5, 0.4, 0.8, 1.2, 0.6))


def _fleet_case(k=32):
    """chip_smoke.py phase 11's 8-stage topology at width k (stage 7 k/2
    wide), deterministic and stochastic, in both packages; its truth (half
    the workers fast and noisy, half slow and precise); and beliefs that
    differ from the truth in one place: worker 0 of every stage is believed
    at mu < 0 with a smaller sigma, as a noisy worker fed the proposal floor
    can be after a few cycles."""
    dags = []
    for pkg in (js, ts):
        det = pkg.WorkflowDAG.from_edges(8, FLEET_EDGES, num_workers=k).with_stage_workers(
            (k,) * 7 + (k // 2,))
        dags.append((det, det.with_stochastic(
            exec_probs=(1.0, 1.0, 0.3, 1.0, 1.0, 1.0, 0.5, 1.0),
            rework_probs=(0.0, 0.0, 0.0, 0.4, 0.0, 0.2, 0.0, 0.0),
            max_retries=(1, 1, 1, 4, 1, 3, 1, 1))))
    rng = np.random.default_rng(2016)
    fast = np.arange(k) < k // 2
    mu = FLEET_SCALE[:, None] * np.where(fast, 5.0, 9.0) * np.exp(rng.uniform(-0.2, 0.2, (8, k)))
    sigma = FLEET_SCALE[:, None] * np.where(fast, 6.0, 0.3) * np.ones((8, 1))
    truth = [x.astype(np.float32) for x in (mu, sigma, np.full((8, k), 0.9), np.full((8, k), 0.55))]
    beliefs = [x.copy() for x in truth]
    beliefs[0][:, 0], beliefs[1][:, 0] = -0.5 * FLEET_SCALE, 1.2 * FLEET_SCALE
    return dags, truth, beliefs


@pytest.mark.parametrize("stochastic", [False, True], ids=["deterministic", "stochastic"])
@pytest.mark.parametrize("believed", [False, True], ids=["truth", "beliefs"])
def test_propose_dag_at_the_fleet_topology_matches_reference(believed, stochastic):
    """propose_dag(params=) on phase 11's 8-stage topology, with its
    variance budget (half the uniform split's composed variance under the
    truth) and its proposal floor 1/(8K).

    Under the truth both packages agree within the tolerance above, and
    both topologies' splits beat the uniform one.  Under beliefs with a
    negative mu the stage solves put the largest share on that worker; the
    reference's float32 solve then drifts ~1e-3 from its own float64 answer
    and the port's does not, so the port is held to the float64 reference
    (within 1e-4; measured ~4e-6).  Priced at the truth, the split made from
    those beliefs loses to the uniform split in both packages: the algorithm
    fed a negative mu, not the port."""
    k = 32
    (jdags, tdags), truth, beliefs = _fleet_case(k)
    jdag, tdag = jdags[stochastic], tdags[stochastic]
    t_truth = tf.UnitParams(*map(T, truth))
    uniform = ts.uniform_fractions(tdags[1], "cpu")
    price = lambda f: float(ts.dag_stats(tdags[1], T(np.asarray(f, np.float32)), t_truth,
                                         num_points=512).e_t)
    budget = 0.5 * float(ts.dag_stats(tdags[1], uniform, t_truth, num_points=512).var)
    kw = dict(n_iters=4, grid_size=64, num_points=512, opt_steps=200, min_fraction=1.0 / (8 * k))
    jcfg = js.SchedulerConfig(objective=js.Objective.variance_budget(budget), **kw)
    tcfg = ts.SchedulerConfig(objective=ts.Objective.variance_budget(budget), **kw)
    leaves = beliefs if believed else truth
    got = ts.propose_dag(ts.init_dag(tcfg, tdag, seed=0, device="cpu"), tdag, tcfg,
                         params=tf.UnitParams(*map(T, leaves)))
    if believed:
        with jax.enable_x64():
            want = js.propose_dag(js.init_dag(jcfg, jdag, jax.random.PRNGKey(0)), jdag, jcfg,
                                  params=jf.UnitParams(*(jnp.asarray(x, jnp.float64) for x in leaves)))
            want = jax.tree_util.tree_map(np.asarray, want)
        assert want[0].dtype == np.float64
    else:
        want = js.propose_dag(js.init_dag(jcfg, jdag, jax.random.PRNGKey(0)), jdag, jcfg,
                              params=jf.UnitParams(*map(jnp.asarray, leaves)))
    _assert_proposals_close(got, want)
    fracs = got[0].numpy()
    if believed:
        assert (fracs.argmax(-1) == 0).all()
        assert price(fracs) > price(uniform) and price(want[0]) > price(uniform)
    else:
        assert price(fracs) < price(uniform)
