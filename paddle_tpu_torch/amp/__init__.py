"""AMP — the counterpart of ``paddle_tpu/amp/__init__.py``: ``decorate`` at
level O2 casts a model's parameters to bf16 (or another float dtype) and
turns on the optimizers' f32 master weights (``multi_precision``).

As in the JAX package (``amp/__init__.py:84-93``) only batch-norm and
LayerNorm layers keep their dtype, so RMSNorm weights go to bf16 too. O1
(``auto_cast``, per-op casting by white and black lists) is not ported yet.
"""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["decorate", "auto_cast"]

_EXCLUDED = (nn.modules.batchnorm._BatchNorm, nn.LayerNorm)


@torch.no_grad()
def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None):
    """O2: every floating parameter outside batch-norm / LayerNorm layers is
    cast IN PLACE to ``dtype`` (the Parameter objects stay, so an optimizer
    built before keeps them); optimizers get ``multi_precision`` unless
    ``master_weight`` is False. O1 leaves the parameters as they are, as in
    the JAX package. Returns the models (and optimizers when given)."""
    d = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        for m in model_list:
            for layer in m.modules():
                if isinstance(layer, _EXCLUDED):
                    continue
                for p in layer.parameters(recurse=False):
                    if p.is_floating_point():
                        p.data = p.data.to(d)
        if optimizers is not None:
            opts = (optimizers if isinstance(optimizers, (list, tuple))
                    else [optimizers])
            for o in opts:
                o._multi_precision = master_weight is not False
    elif level != "O1":
        raise ValueError(f"level must be 'O1' or 'O2', got {level!r}")
    if optimizers is None:
        return models if single else model_list
    return (models if single else model_list), optimizers


def auto_cast(*args, **kwargs):
    raise NotImplementedError(
        "auto_cast (AMP O1, per-op casting) is not ported yet; use "
        "decorate(level='O2')")
