"""The model stack of the port: the dense, hybrid (RG-LRU + local
attention) and MoE families, for serving."""
from . import layers, model_zoo, moe, params, recurrent, transformer

__all__ = ["layers", "model_zoo", "moe", "params", "recurrent", "transformer"]
