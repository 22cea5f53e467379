"""jit of the port: ``to_static`` (one CUDA graph per input signature on
the card), ``save`` / ``load`` / ``TranslatedLayer`` (a ``torch.export``
program beside its weights), ``TrainStep`` (one CUDA graph per batch
signature, replayed; ``run_steps``, ``aot_prime``, ``export_state`` /
``import_state``), ``fingerprint`` (the signature) and ``graphs``
(``StepRunner``: the step programs captured once per key as CUDA graphs
and replayed, and the capture pieces ``TrainStep`` and ``to_static``
share)."""
from .api import (
    StaticFunction,
    TranslatedLayer,
    enable_to_static,
    ignore_module,
    load,
    not_to_static,
    save,
    set_code_level,
    set_verbosity,
    to_static,
)
from .fingerprint import aval_fingerprint
from .train import TrainStep

__all__ = ["TrainStep", "aval_fingerprint", "to_static", "StaticFunction",
           "enable_to_static", "not_to_static", "ignore_module", "save",
           "load", "TranslatedLayer", "set_verbosity", "set_code_level"]
