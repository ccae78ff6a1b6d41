"""AdamW of the port (``optim.adamw``)."""
from . import adamw

__all__ = ["adamw"]
