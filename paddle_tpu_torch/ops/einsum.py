"""einsum — the counterpart of ``paddle_tpu/ops/einsum.py``: a direct
``torch.einsum`` over operands of one dtype."""
from __future__ import annotations

import torch

from . import _promote_all, apply_op

__all__ = ["einsum"]


def einsum(equation, *operands):
    return apply_op(lambda *vs: torch.einsum(equation, *_promote_all(vs)),
                    "einsum", *operands)
