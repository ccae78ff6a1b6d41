"""The model stack of the port: the dense, vision, hybrid (RG-LRU + local
attention), MoE, encoder-decoder and ssm families, for serving and training,
on one device or on a mesh (``MeshInfo``)."""
from . import encdec, layers, model_zoo, moe, params, recurrent, transformer
from .layers import ApplyCtx, MeshInfo

__all__ = ["ApplyCtx", "MeshInfo", "encdec", "layers", "model_zoo", "moe", "params", "recurrent",
           "transformer"]
