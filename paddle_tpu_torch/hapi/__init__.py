"""paddle.hapi of the port: ``Model`` and its callbacks."""
from . import callbacks  # noqa: F401
from .model import Model  # noqa: F401

__all__ = ["Model", "callbacks"]
