"""The port's data pipeline (``data.pipeline``), in numpy."""
from . import pipeline

__all__ = ["pipeline"]
