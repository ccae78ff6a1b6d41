"""Device choice for the port's entry points.

Entry points (``sched.init``, ``sched.Scheduler``, ``serve.init``,
``serve.ServiceLoop``, ``core.fit``, ``core.fit_fleet``, ``core.fit_dag``,
``models.model_zoo.init_model_params``, ``models.model_zoo.init_cache`` and
``python -m repro_torch.launch.serve``) run on the card unless the caller
names another device.
With no device given and no CUDA device present they raise: the port never
carries on on the CPU unasked.  Every other function follows the device of
its input tensors.
"""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


@contextlib.contextmanager
def no_sync(device):
    """Run the block under ``torch.cuda.set_sync_debug_mode("error")``: any
    operation that waits for the card raises.  On another device nothing is
    checked."""
    if torch.device(device).type != "cuda":
        yield
        return
    previous = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(previous)


def host_constant(values, device, dtype=torch.float32) -> torch.Tensor:
    """A small constant known on the host (a number or a tuple of them) as a
    tensor on ``device``.  On a card it is copied from pinned memory without
    waiting, so it may be made under ``no_sync``."""
    x = torch.tensor(values, dtype=dtype)
    device = torch.device(device)
    if device.type != "cuda":
        return x.to(device)
    return x.pin_memory().to(device, non_blocking=True)
