"""Distributed models of the incubate package."""
from . import moe  # noqa: F401
