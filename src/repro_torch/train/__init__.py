"""Training and serving steps of the port, and the trainer
(``train.trainer``, imported on its own: it builds on the scheduler)."""
from . import serve_step, train_step

__all__ = ["serve_step", "train_step"]
