"""checkpoint subpackage: atomic, async, retention-managed checkpoints whose
key paths match the JAX package's (``CheckpointManager``)."""
from .checkpoint import CheckpointManager

__all__ = ["CheckpointManager"]
