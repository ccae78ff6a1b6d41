"""The estimator as an always-on service: decoupled observe/propose cadence.

PyTorch counterpart of ``repro.serve.service``.  A synchronous
observe -> propose chain makes every caller wait for a Gibbs sweep and a
simplex solve.  This module splits the two rates:

  * **observe on every drained batch** — telemetry lands in a device
    ``TelemetryRing`` and each tick drains the whole buffer through the
    fleet-native estimator (``sched.advance_fleet``, masked tail), optionally
    with only a top-M active set on the exponent grid (``active_size``);
  * **propose only when posteriors move** — a drift statistic (the
    symmetrized-KL ``posterior_drift``, or the max per-worker
    ``hier.surprise`` with hierarchical pooling) gates the simplex solve
    against a self-calibrating EWMA baseline (``serve.gate``) or a fixed
    ``drift_threshold``, with a hard ``max_staleness``;
  * **readers never block** — the last-good split lives in a
    double-buffered host slot (``ServiceLoop.fractions()``).

Control flow differs from the reference's single jitted tick:

  * whether the ring holds data, and whether the hyperprior refit is due,
    depend only on how many pushes the host made; ``ServiceLoop`` keeps host
    mirrors of the ring's un-drained count and of ``hyper_age`` and branches
    on them with no device read.  An empty tick leaves the beliefs and the
    generator untouched;
  * the propose decision depends on the drift, which lives on the device:
    the tick reads that one flag.  Everything before the read — drain,
    ``select_active``, the advance, hyperprior refit and shrink, drift and
    gate — waits for nothing (``ServiceLoop.tick(guard=device.no_sync(...))``
    runs it under ``torch.cuda.set_sync_debug_mode("error")``);
  * the state is replaced, not donated: the ring's buffers are written in
    place, and the rest of a tick's tensors free the ones they replace, so
    device memory does not grow from tick to tick;
  * ``async_propose`` runs the solve on a side CUDA stream and publishes it
    from ``poll`` once an event recorded after it has completed.  The side
    stream waits for the tick's work; the solve owns copies of the
    parameters it reads; tensors that cross streams are recorded on the
    stream that uses them.  The 200 Adam steps are still enqueued from the
    host at dispatch, so "off the tick path" costs host time.  On the CPU
    the solve runs at dispatch and is still published only by ``poll``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from repro_torch.core.compress import select_active
from repro_torch.core.frontier import UnitParams
from repro_torch.device import resolve_device
from repro_torch.hier.hyperprior import Hyperprior, fit_hyperprior, hyper_init, shrink, surprise
from repro_torch.sched import scheduler as _sched
from repro_torch.sched.scheduler import (
    ProposeStats,
    SchedulerConfig,
    SchedulerState,
    advance_fleet,
    solve_fractions,
    unit_params,
)

from .gate import (
    DEFAULT_GATE_DECAY,
    DEFAULT_GATE_WARMUP,
    DEFAULT_GATE_Z,
    GateState,
    gate_init,
    gate_update,
)
from .ring import TelemetryRing, drain, push, ring_init


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Static service knobs.

    ``drift_threshold=None`` (the default) is the self-calibrating gate;
    a float keeps a fixed threshold (the gate state is then never touched).
    ``max_staleness`` caps the drains between proposes and owns proposing
    during the calibrated gate's warm-up.  ``active_size`` runs only the
    top-M workers of ``core.compress.select_active`` on the exponent grid
    per drain (None = every worker, every drain).  ``async_propose`` moves
    the solve off the tick (see the module docstring).
    """

    sched: SchedulerConfig = SchedulerConfig()
    capacity: int = 64  # ring slots buffered between drains
    drift_threshold: Optional[float] = None  # None = self-calibrating gate
    max_staleness: int = 8  # hard cap: drains between proposes
    gate_z: float = DEFAULT_GATE_Z
    gate_warmup: int = DEFAULT_GATE_WARMUP
    gate_decay: float = DEFAULT_GATE_DECAY
    active_size: Optional[int] = None
    async_propose: bool = False


class ServeState(NamedTuple):
    """Everything the service owns."""

    sched: SchedulerState  # fleet posteriors (K,) leaves and the generator
    ring: TelemetryRing  # buffered telemetry
    fractions: Tensor  # (K,) last-published split
    stats: ProposeStats  # frontier stats at the last propose
    ref: UnitParams  # posterior point estimates at the last propose
    staleness: Tensor  # int32, drains since the last propose
    n_drains: Tensor  # int32, lifetime non-empty drains
    n_proposes: Tensor  # int32, lifetime proposes
    last_drift: Tensor  # float32, drift measured at the last tick
    gate: GateState  # EWMA baseline of the drift statistic
    hyper: Hyperprior  # pooled fleet prior (refit every hyper_refit_every)
    hyper_age: Tensor  # int32, drains since the last hyperprior refit
    refresh_age: Optional[Tensor] = None  # (K,) int32 drains since each
    # worker's last full grid refresh; allocated only under active_size


class TickInfo(NamedTuple):
    """Per-tick observability."""

    ll: Tensor  # (K,) per-worker log-likelihood of the drained batch
    proposed: bool  # did this tick re-solve the split?
    drift: Tensor  # float32 gate statistic (KL drift or max surprise)
    drained: int  # observations consumed from the ring


def posterior_drift(ref: UnitParams, cur: UnitParams) -> Tensor:
    """How far the fleet's posterior point estimates moved; scalar >= 0.

    Per worker: the symmetrized KL divergence between N(mu_ref, sigma_ref^2)
    and N(mu_cur, sigma_cur^2), plus 4 x the squared shifts of the exponent
    means; the fleet drift is the max over workers.
    """
    s2r = ref.sigma**2 + 1e-12
    s2c = cur.sigma**2 + 1e-12
    d2 = (ref.mu - cur.mu) ** 2
    kl_sym = 0.25 * ((s2r + d2) / s2c + (s2c + d2) / s2r) - 0.5
    expo = (ref.alpha - cur.alpha) ** 2 + (ref.beta - cur.beta) ** 2
    return torch.amax(kl_sym + 4.0 * expo)


def init(config: ServeConfig, num_workers: int, seed: int = 0, device=None) -> ServeState:
    """Fresh service state: empty ring, uniform split, saturated staleness.

    An entry point: runs on CUDA unless ``device`` says otherwise.  Staleness
    and the hyperprior's age start saturated, so the first data tick proposes
    and refits; under ``active_size`` every refresh age starts saturated, so
    the first drains take every worker through a full grid refresh.
    """
    device = resolve_device(device)
    sched_state = _sched.init(config.sched, num_workers, seed, device)
    k = num_workers
    scalar = lambda v, dtype: torch.full((), v, dtype=dtype, device=device)
    inf = lambda: scalar(float("inf"), torch.float32)
    return ServeState(
        sched=sched_state,
        ring=ring_init(config.capacity, num_workers, device=device),
        fractions=torch.full((k,), 1.0 / k, dtype=torch.float32, device=device),
        stats=ProposeStats(e_t=inf(), var=inf(), score=inf()),
        ref=unit_params(sched_state),
        staleness=scalar(config.max_staleness, torch.int32),
        n_drains=scalar(0, torch.int32),
        n_proposes=scalar(0, torch.int32),
        last_drift=scalar(0.0, torch.float32),
        gate=gate_init(device),
        hyper=hyper_init(config.sched.mu_guess, device),
        hyper_age=scalar(config.sched.hyper_refit_every, torch.int32),
        refresh_age=(None if config.active_size is None
                     else torch.full((k,), 1_000_000, dtype=torch.int32, device=device)),
    )


def solve_published(
    cur: UnitParams, config: ServeConfig = ServeConfig(), live: Optional[Tensor] = None
) -> Tuple[Tensor, ProposeStats]:
    """The publish-grade simplex solve: exactly what a synchronous tick runs,
    split out so ``async_propose`` can run it off the tick."""
    fr, st = solve_fractions(
        cur,
        objective=config.sched.objective,
        steps=config.sched.opt_steps,
        lr=config.sched.opt_lr,
        num_points=config.sched.num_points,
        min_fraction=config.sched.min_fraction,
        live=live,
    )
    f32 = lambda x: x.to(torch.float32)
    return f32(fr), ProposeStats(e_t=f32(st.e_t), var=f32(st.var), score=f32(st.score))


def _tick_advance(
    state: ServeState, config: ServeConfig, has_data: bool, refit_due: bool
) -> Tuple[ServeState, Tensor, Tensor, Optional[Tensor], UnitParams]:
    """A tick up to the propose decision, with no device read: drain ->
    (active set) -> advance -> (hyperprior refit, shrink) -> drift -> gate.

    Returns the state with everything but the propose applied, the
    log-likelihood, the drift, the device flag ``should`` (None on an empty
    tick) and the post-advance point estimates.
    """
    sched_state = state.sched
    batch, ring = drain(state.ring)

    k = state.fractions.shape[0]
    active_idx = None
    refresh_age = state.refresh_age
    if has_data and config.active_size is not None and config.active_size < k:
        active_idx, _ = select_active(
            config.active_size,
            age=state.refresh_age,
            nu=sched_state.gibbs.ng.nu0,
            surprise=(surprise(sched_state.gibbs, state.hyper)
                      if config.sched.hierarchical else None),
            anomaly=sched_state.ewma_ll,
            live=sched_state.live,
        )
        refresh_age = (state.refresh_age + 1).index_fill(0, active_idx, 0)

    if has_data:
        fleet, ll = advance_fleet(
            sched_state.gibbs, batch.times, batch.fracs, config.sched, sched_state.generator,
            mask=batch.mask, active_idx=active_idx,
        )
        sched_state = sched_state._replace(gibbs=fleet, step=sched_state.step + 1)
        ll = ll.to(torch.float32)
    else:  # an empty ring: not even the generator moves
        ll = torch.zeros_like(sched_state.ewma_ll)

    if config.sched.hierarchical:
        # Refit the pooled prior on its cadence, score each worker against
        # it on the un-shrunk posteriors (shrinking first would blunt the
        # statistic), then blend every worker toward the fresh pool.
        hyper = fit_hyperprior(sched_state.gibbs) if refit_due else state.hyper
        hyper_age = (torch.zeros_like(state.hyper_age) if refit_due
                     else state.hyper_age + int(has_data))
        drift = torch.amax(surprise(sched_state.gibbs, hyper)).to(torch.float32)
        if refit_due:
            sched_state = sched_state._replace(
                gibbs=shrink(sched_state.gibbs, hyper, strength=config.sched.hyper_strength))
    else:
        hyper, hyper_age = state.hyper, state.hyper_age
        drift = posterior_drift(state.ref, unit_params(sched_state)).to(torch.float32)

    cur = unit_params(sched_state)
    staleness = state.staleness + int(has_data)
    gate, should = state.gate, None
    if has_data:
        stale = staleness >= config.max_staleness
        if config.drift_threshold is None:
            fire, gate = gate_update(state.gate, drift, z=config.gate_z,
                                     warmup=config.gate_warmup, decay=config.gate_decay)
            should = fire | stale
        else:
            should = (drift > config.drift_threshold) | stale

    new_state = state._replace(
        sched=sched_state,
        ring=ring,
        staleness=staleness,
        n_drains=state.n_drains + int(has_data),
        last_drift=drift,
        gate=gate,
        hyper=hyper,
        hyper_age=hyper_age,
        refresh_age=refresh_age,
    )
    return new_state, ll, drift, should, cur


def _tick_decide(state: ServeState, config: ServeConfig, should: bool, cur: UnitParams) -> ServeState:
    """Apply the propose decision: bookkeeping, and the solve itself unless
    it runs asynchronously."""
    if not should:
        return state
    state = state._replace(
        ref=cur, staleness=torch.zeros_like(state.staleness), n_proposes=state.n_proposes + 1)
    if not config.async_propose:
        fr, st = solve_published(cur, config, state.sched.live)
        state = state._replace(fractions=fr, stats=st)
    return state


def _refit_due(config: ServeConfig, drained: int, hyper_age: int) -> bool:
    return (config.sched.hierarchical and drained > 0
            and hyper_age >= config.sched.hyper_refit_every)


def _run_tick(state: ServeState, config: ServeConfig, drained: int, refit_due: bool,
              guard=None) -> Tuple[ServeState, TickInfo, UnitParams]:
    has_data = drained > 0
    with guard if guard is not None else contextlib.nullcontext():
        state, ll, drift, should_t, cur = _tick_advance(state, config, has_data, refit_due)
    should = has_data and bool(should_t)  # the tick's one read of the device
    state = _tick_decide(state, config, should, cur)
    return state, TickInfo(ll=ll, proposed=should, drift=drift, drained=drained), cur


def tick_with_params(
    state: ServeState, config: ServeConfig = ServeConfig()
) -> Tuple[ServeState, TickInfo, UnitParams]:
    """One service beat; also returns the post-advance point estimates (the
    parameters an async solve reads).  Reads the ring's count and the
    hyperprior's age from the device; ``ServiceLoop`` keeps host mirrors of
    both instead."""
    drained = int(state.ring.count)
    return _run_tick(state, config, drained, _refit_due(config, drained, int(state.hyper_age)))


def tick(state: ServeState, config: ServeConfig = ServeConfig()) -> Tuple[ServeState, TickInfo]:
    """One service beat: drain -> observe -> drift-gated propose."""
    new_state, info, _ = tick_with_params(state, config)
    return new_state, info


class _PendingSolve(NamedTuple):
    fractions: Tensor
    stats: ProposeStats
    done: Optional["torch.cuda.Event"]  # None: finished at dispatch (CPU)

    def is_ready(self) -> bool:
        return self.done is None or self.done.query()


class ServiceLoop:
    """Imperative shell of the push-mode service.

    Owns a ``ServeState``, host mirrors of the ring's un-drained count and
    of the hyperprior's age, and a double-buffered host slot of the
    published split: ``fractions()`` reads whichever buffer is active
    without touching a device, so readers never wait on a Gibbs sweep.  An
    entry point: runs on CUDA unless ``device`` says otherwise.
    ``last_dispatch`` holds the host's ``time.perf_counter()`` at the start
    and the end of the last async dispatch: the host time that enqueuing the
    solve adds to a tick.
    """

    def __init__(
        self,
        num_workers: int,
        *,
        config: Optional[ServeConfig] = None,
        seed: int = 0,
        state: Optional[ServeState] = None,
        device=None,
    ):
        self.config = config or ServeConfig()
        self.state = state if state is not None else init(self.config, num_workers, seed, device)
        self.device = self.state.fractions.device
        host = self.state.fractions.cpu().numpy()
        self._slots = [host.copy(), host.copy()]
        self._active = 0
        self._version = 0
        self._pending: Optional[_PendingSolve] = None
        self.last_dispatch: Optional[Tuple[float, float]] = None
        # Host mirrors (one read of a given state, none afterwards).
        self._buffered = int(self.state.ring.count)
        self._hyper_age = int(self.state.hyper_age)
        self._side = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    # -- ingestion (producer side) -----------------------------------------
    def push(self, fracs, times, valid=None) -> None:
        """Buffer one telemetry row (host arrays are copied to the device)."""
        dev = lambda x: torch.as_tensor(x if isinstance(x, Tensor) else np.asarray(x, np.float32),
                                        dtype=torch.float32, device=self.device)
        ring = push(self.state.ring, dev(fracs), dev(times), None if valid is None else dev(valid))
        self.state = self.state._replace(ring=ring)
        self._buffered = min(self._buffered + 1, self.config.capacity)

    # -- the service beat (estimator side) ---------------------------------
    def tick(self, guard=None) -> TickInfo:
        """Drain + observe (+ propose iff the posterior moved); publish.

        With ``config.async_propose`` a fired gate dispatches the solve off
        the tick; a later ``poll`` (each tick starts with one) publishes it.
        A solve already in flight suppresses re-dispatch.  ``guard``, a
        context manager, is entered around everything before the tick's one
        flag read: ``repro_torch.device.no_sync(device)`` checks that none
        of it waits for the card.
        """
        if self.config.async_propose:
            self.poll()
        refit_due = _refit_due(self.config, self._buffered, self._hyper_age)
        self.state, info, cur = _run_tick(self.state, self.config, self._buffered, refit_due,
                                          guard)
        self._hyper_age = 0 if refit_due else self._hyper_age + int(info.drained > 0)
        self._buffered = 0
        if info.proposed:
            if not self.config.async_propose:
                self._publish(self.state.fractions)
            elif self._pending is None:
                start = time.perf_counter()
                self._pending = self._dispatch(cur)
                self.last_dispatch = (start, time.perf_counter())
        return info

    def _dispatch(self, cur: UnitParams) -> _PendingSolve:
        """Start the solve on the side stream and return without waiting."""
        live = self.state.sched.live
        if self._side is None:
            fr, st = solve_published(cur, self.config, live)
            return _PendingSolve(fr, st, None)
        # The solve owns its inputs: copies made on the tick's stream.
        owned = [x.clone() for x in cur] + ([] if live is None else [live.clone()])
        main = torch.cuda.current_stream(self.device)
        self._side.wait_stream(main)
        with torch.cuda.stream(self._side):
            fr, st = solve_published(UnitParams(*owned[:4]), self.config,
                                     owned[4] if live is not None else None)
            done = torch.cuda.Event()
            done.record(self._side)
        for x in owned:  # allocated on the tick's stream, read on the side one
            x.record_stream(self._side)
        return _PendingSolve(fr, st, done)

    def poll(self) -> bool:
        """Publish a completed async solve, if any; never blocks.  Returns
        True iff a new split was published."""
        pending = self._pending
        if pending is None or not pending.is_ready():
            return False
        self._pending = None
        if pending.done is not None:
            main = torch.cuda.current_stream(self.device)
            main.wait_event(pending.done)
            for x in (pending.fractions, *pending.stats):  # made on the side stream
                x.record_stream(main)
        self.state = self.state._replace(fractions=pending.fractions, stats=pending.stats)
        self._publish(pending.fractions)
        return True

    def _publish(self, fractions: Tensor) -> None:
        inactive = 1 - self._active
        self._slots[inactive][:] = fractions.cpu().numpy()
        self._active = inactive  # atomic flip: readers see old or new
        self._version += 1

    # -- publication (reader side; never blocks) ---------------------------
    def fractions(self) -> np.ndarray:
        """Last-good published split — a host read, no device, no lock."""
        return self._slots[self._active]

    @property
    def version(self) -> int:
        """Bumps once per published split."""
        return self._version

    # -- observability ------------------------------------------------------
    def counters(self) -> dict:
        """Lifetime drain/propose/drop counters (reads four device scalars)."""
        return {
            "drains": int(self.state.n_drains),
            "proposes": int(self.state.n_proposes),
            "dropped": int(self.state.ring.dropped),
            "pushes": int(self.state.ring.total),
        }

    @property
    def num_workers(self) -> int:
        return int(self.state.fractions.shape[0])
