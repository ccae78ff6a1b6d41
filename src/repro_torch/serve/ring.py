"""Device-resident telemetry ring buffer: fixed capacity, no host sync.

PyTorch counterpart of ``repro.serve.ring``.  A fleet serving heavy traffic
produces telemetry continuously; the estimator consumes it in batches.
``TelemetryRing`` decouples the two rates on the device:

  * every buffer has a fixed capacity; ``push`` writes one slot at a device
    index and ``drain`` reads the whole buffer in push order with a masked
    tail, so neither changes a shape or waits for the device.  ``head``,
    ``count``, ``dropped`` and ``total`` are int32 scalars on the device;
  * ``push`` writes its slot into the ring's buffers in place (as the model
    caches are written), so a caller that keeps an old ring sees the slot
    change; the counters are new tensors;
  * overflow drops the OLDEST entries and counts them in ``dropped``.

Drains present observations oldest first with a masked tail — the padded
batch layout of ``core.gibbs.fit`` — so drains advanced through
``gibbs_batch`` compute what batches of the same observations do.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import Tensor


class TelemetryRing(NamedTuple):
    """Fixed-capacity ring of (fracs, times) observations.

    Buffers are ``(capacity,)`` for a single unit or ``(capacity, K)`` for a
    K-worker fleet (slot-major, so one push writes one row).  ``head`` is the
    next write slot, ``count`` the un-drained entries (saturating at
    capacity), ``dropped`` / ``total`` the lifetime overflow and push counts.
    """

    fracs: Tensor  # (C,) or (C, K)
    times: Tensor  # (C,) or (C, K)
    valid: Tensor  # (C,) or (C, K) float32 per-element validity
    head: Tensor  # int32 scalar
    count: Tensor  # int32 scalar
    dropped: Tensor  # int32 scalar
    total: Tensor  # int32 scalar

    @property
    def capacity(self) -> int:
        return int(self.times.shape[0])

    @property
    def num_workers(self) -> Optional[int]:
        return int(self.times.shape[1]) if self.times.ndim == 2 else None


class DrainedBatch(NamedTuple):
    """One whole-buffer drain in estimator layout: ``times`` / ``fracs`` /
    ``mask`` of shape (K, capacity) for a fleet ring ((capacity,) for one
    unit), in push order, ``mask`` 0 on empty or invalid slots; ``count`` the
    slots that carry telemetry."""

    times: Tensor
    fracs: Tensor
    mask: Tensor
    count: Tensor  # int32 scalar


def ring_init(capacity: int, num_workers: Optional[int] = None, *, device=None,
              dtype=torch.float32) -> TelemetryRing:
    """An empty ring on ``device``; ``num_workers=None`` builds a
    single-unit (C,) ring."""
    if capacity < 1:
        raise ValueError("capacity must be >= 1")
    shape = (capacity,) if num_workers is None else (capacity, num_workers)
    zero = lambda: torch.zeros((), dtype=torch.int32, device=device)
    # Empty slots carry interior dummies (f = 0.5, t = 1.0), so a fully
    # masked drain is an exact no-op on every masked reduction downstream.
    return TelemetryRing(
        fracs=torch.full(shape, 0.5, dtype=dtype, device=device),
        times=torch.full(shape, 1.0, dtype=dtype, device=device),
        valid=torch.zeros(shape, dtype=dtype, device=device),
        head=zero(),
        count=zero(),
        dropped=zero(),
        total=zero(),
    )


def push(ring: TelemetryRing, fracs, times, valid=None) -> TelemetryRing:
    """Append one observation row at ``head``; no host sync.

    ``fracs`` / ``times`` are scalars for a single-unit ring or (K,) for a
    fleet ring, on the ring's device to keep the call free of host copies.
    ``valid`` marks elements invalid (non-finite telemetry of a failed
    worker) so they never reach the estimator.  When the ring is full the
    oldest un-drained entry is overwritten and counted in ``dropped``.
    """
    cap = ring.capacity
    as_f = lambda x: torch.as_tensor(x, dtype=ring.times.dtype, device=ring.times.device)
    t = torch.broadcast_to(as_f(times), ring.times.shape[1:])
    f = torch.broadcast_to(as_f(fracs), t.shape)
    v = torch.ones_like(t) if valid is None else torch.broadcast_to(as_f(valid), t.shape)
    # Invalid elements get interior dummies: inf/nan must never be stored
    # (0 * inf = nan would leak through the drain mask).
    f = torch.where(v > 0, f, 0.5)
    t = torch.where(v > 0, t, 1.0)
    slot = torch.remainder(ring.head, cap).to(torch.int64).reshape(1)
    ring.fracs.index_copy_(0, slot, f[None])
    ring.times.index_copy_(0, slot, t[None])
    ring.valid.index_copy_(0, slot, v[None])
    full = (ring.count == cap).to(torch.int32)
    return ring._replace(
        head=torch.remainder(ring.head + 1, cap),
        count=torch.clamp(ring.count + 1, max=cap),
        dropped=ring.dropped + full,
        total=ring.total + 1,
    )


def drain(ring: TelemetryRing) -> Tuple[DrainedBatch, TelemetryRing]:
    """Empty the ring into one gibbs-ready batch; no host sync.

    The batch is the whole buffer (static shape = capacity) in push order,
    oldest first, with a masked tail.  The drain order ``(start + arange(C))
    % C`` is computed on the device from ``head`` and ``count``.  The
    returned ring is logically empty (``count = 0``); its buffers are reused
    by the next pushes.
    """
    cap = ring.capacity
    ar = torch.arange(cap, dtype=torch.int32, device=ring.times.device)
    start = torch.remainder(ring.head - ring.count, cap)
    order = torch.remainder(start + ar, cap).to(torch.int64)  # oldest -> newest
    slot_mask = (ar < ring.count).to(ring.valid.dtype)
    t = ring.times.index_select(0, order)
    f = ring.fracs.index_select(0, order)
    v = ring.valid.index_select(0, order)
    if t.ndim == 2:  # fleet ring: slot-major storage -> worker-major batch
        mask = (slot_mask[:, None] * v).T.contiguous()
        t, f = t.T.contiguous(), f.T.contiguous()
    else:
        mask = slot_mask * v
    batch = DrainedBatch(times=t, fracs=f, mask=mask, count=ring.count)
    return batch, ring._replace(count=torch.zeros_like(ring.count))
