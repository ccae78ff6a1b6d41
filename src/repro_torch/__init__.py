"""PyTorch and CUDA port of the Bayesian workflow partitioner.

Mirrors the layout of the JAX package ``repro`` (``core``, ``kernels``,
``sched``, ``hier``, ``serve``, ``distributed``, ``configs``, ``models``,
``train``, ``launch``, ``checkpoint``) and never imports
it or JAX.  Entry points run on the CUDA card unless the caller passes
``device="cpu"``; the kernels are hand-written for Hopper and built with
``nvcc`` at first use.
"""
from . import (checkpoint, configs, convert, core, distributed, hier, kernels, models, sched,
               serve, train)

__all__ = ["checkpoint", "configs", "convert", "core", "distributed", "hier", "kernels", "models",
           "sched", "serve", "train"]
