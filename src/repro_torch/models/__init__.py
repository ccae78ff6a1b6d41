"""The model stack of the port: the dense, vision, hybrid (RG-LRU + local
attention), MoE and encoder-decoder families, for serving."""
from . import encdec, layers, model_zoo, moe, params, recurrent, transformer
from .layers import ApplyCtx

__all__ = ["ApplyCtx", "encdec", "layers", "model_zoo", "moe", "params", "recurrent",
           "transformer"]
