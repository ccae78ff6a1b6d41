"""PyTorch and CUDA port of the Bayesian workflow partitioner.

Mirrors the layout of the JAX package ``repro`` (``core``, ``kernels``,
``sched``, ``hier``, ``serve``, ``distributed``, ``configs``, ``models``,
``optim``, ``data``, ``train``, ``launch``, ``checkpoint``) and never imports
it or JAX.  Entry points run on the CUDA card unless the caller passes
``device="cpu"``; the kernels are hand-written for Hopper and built with
``nvcc`` at first use.

Subpackages are imported on first access (PEP 562), so that importing one
layer imports only what it builds on: ``import repro_torch.core`` leaves
``repro_torch.sched`` unimported.
"""
import importlib

__all__ = ["checkpoint", "configs", "convert", "core", "data", "distributed", "hier", "kernels",
           "launch", "models", "optim", "sched", "serve", "train"]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
