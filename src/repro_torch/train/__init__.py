"""Serving steps of the port (training waits for a later slice)."""
from . import serve_step

__all__ = ["serve_step"]
