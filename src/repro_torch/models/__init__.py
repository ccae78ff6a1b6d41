"""The model stack of the port: the dense and hybrid (RG-LRU + local
attention) families, for serving."""
from . import layers, model_zoo, params, recurrent, transformer

__all__ = ["layers", "model_zoo", "params", "recurrent", "transformer"]
