"""The incubate package's distributed models (MoE on one device)."""
from . import models  # noqa: F401
