"""jit of the port: ``TrainStep`` (eager PyTorch) and, in ``jit.graphs``,
``StepRunner``: the step programs captured once per key as CUDA graphs and
replayed."""
from .train import TrainStep

__all__ = ["TrainStep"]
