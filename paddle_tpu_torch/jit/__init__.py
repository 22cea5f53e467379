"""jit of the port: ``TrainStep`` (eager PyTorch; nothing is compiled)."""
from .train import TrainStep

__all__ = ["TrainStep"]
