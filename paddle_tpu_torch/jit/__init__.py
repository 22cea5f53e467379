"""jit of the port: ``TrainStep`` (one CUDA graph per batch signature,
replayed; ``run_steps``, ``aot_prime``, ``export_state`` /
``import_state``), ``fingerprint`` (the signature) and ``graphs``
(``StepRunner``: the step programs captured once per key as CUDA graphs
and replayed, and the capture pieces ``TrainStep`` shares)."""
from .fingerprint import aval_fingerprint
from .train import TrainStep

__all__ = ["TrainStep", "aval_fingerprint"]
