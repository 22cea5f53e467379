"""Operators of the port.

Two layers live here.

The kernels: the paged attention kernel (``ops.paged_attention``), the
dense split-KV kernel (``ops.decode_attention``) and the flash-attention
kernels (``ops.flash_attention``), each beside its plain twin.

The op layer, the counterpart of ``paddle_tpu/ops/__init__.py``: every
paddle op is a torch function run through ONE dispatch helper,
``apply_op(fn, name, *args, **kwargs)``, which unwraps the paddle-style
Tensors, applies the AMP cast for the op's NAME (``_amp_wrap``, JAX
``:39-66``), calls ``fn`` on torch tensors, scans the outputs for NaN/Inf
when ``FLAGS_check_nan_inf`` is set, and wraps the outputs. Autograd is
torch's: ``fn`` runs under the current grad mode and its outputs carry
their graph. The JAX package also keeps an eager vjp cache (``_eager_key``
and ``_build_entry``, JAX ``:91-149``), because JAX traces every eager op
anew; torch's eager dispatch runs each op at once and needs none, so it is
not ported. The operator-statistics hook (``_maybe_record_op_stats``)
waits for ``amp.debugging``.

Capture safety: no op synchronises with the host unless its output shape
depends on its values (``nonzero``, ``masked_select``, ``unique``,
boolean-mask indexing, ``bincount``, ``histogram``), and the NaN/Inf scan,
which reads a count back, is skipped while a CUDA graph is being captured.
"""
from __future__ import annotations

# the op names below shadow builtins here (abs, sum, complex, ...): the
# helpers use ``builtins.`` where they need one of those
import builtins
import warnings

import numpy as np
import torch

from .. import amp as _amp
from ..framework.flags import flag as _flag
from ..tensor import Tensor
from .paged_attention import (
    paged_cache_update,
    paged_decode_attention,
    paged_decode_attention_ref,
    write_positions,
)


def _unwrap(a):
    return a._value if isinstance(a, Tensor) else a


def _amp_wrap(fn, name: str):
    """The AMP seam: under ``amp.auto_cast`` the floating inputs of op
    ``name`` are cast to its dtype before ``fn`` runs (inside autograd, so
    each gradient comes back in its input's dtype). O1: black list f32,
    white list the amp dtype, any other op as it is. O2: every op in the
    amp dtype except the black list (f32)."""
    target = _amp._op_cast_target(name)
    if target is None:
        return fn

    def amp_fn(*vals, **kwargs):
        return fn(*[v.to(target) if isinstance(v, torch.Tensor)
                    and v.is_floating_point() and v.dtype != target else v
                    for v in vals], **kwargs)

    return amp_fn


def apply_op(fn, name: str, *args, **kwargs):
    """``fn(*vals, **kwargs)`` on the unwrapped ``args`` (Tensor, torch
    tensor, Python scalar or None); kwargs pass as they are. Returns a
    Tensor, or a tuple / list of Tensors where ``fn`` returns one."""
    fn = _amp_wrap(fn, name)
    out = fn(*[_unwrap(a) for a in args], **kwargs)
    _maybe_scan_nan_inf(name, out)
    return _wrap_outputs(out)


def apply_like(fn, name: str, x, *args, **kwargs):
    """``apply_op`` whose outputs are of ``x``'s kind: Tensors when ``x``
    is a Tensor, torch tensors when it is a torch tensor. The nn
    functionals dispatch through it, so the torch-level models, which call
    them on torch tensors, get torch tensors back, and AMP reaches both by
    the op's name. A torch ``x`` takes the short way, with no Tensor made
    on the way."""
    if isinstance(x, Tensor):
        return apply_op(fn, name, x, *args, **kwargs)
    out = _amp_wrap(fn, name)(x, *[_unwrap(a) for a in args], **kwargs)
    _maybe_scan_nan_inf(name, out)
    return out


def _maybe_scan_nan_inf(name, out):
    """Per-op NaN/Inf scan under ``FLAGS_check_nan_inf`` (reference
    nan_inf_utils). It reads a count back to the host, so it is skipped
    while a CUDA graph is captured."""
    if not _flag("FLAGS_check_nan_inf") or _capturing():
        return
    leaves = out if isinstance(out, (tuple, list)) else [out]
    for i, v in enumerate(leaves):
        if not isinstance(v, torch.Tensor) or not v.is_floating_point():
            continue
        bad = int((~torch.isfinite(v)).sum())
        if bad:
            msg = f"op {name!r} output {i} contains {bad} NaN/Inf values"
            if _flag("FLAGS_check_nan_inf_level") >= 1:
                warnings.warn(msg)
            else:
                raise FloatingPointError(msg)


def _capturing() -> bool:
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def _wrap(o):
    return Tensor(o) if isinstance(o, torch.Tensor) else o


def _wrap_outputs(out):
    if isinstance(out, tuple):
        return tuple(_wrap(o) for o in out)
    if isinstance(out, list):
        return [_wrap(o) for o in out]
    return _wrap(out)


def unary_op(tfn, name):
    def op(x, name=None):
        return apply_op(tfn, op.__name__, x)

    op.__name__ = op.__qualname__ = name
    op.__doc__ = f"paddle.{name} — elementwise."
    return op


def _place() -> torch.device:
    """The device creation ops put new tensors on: the current place."""
    from ..framework.device import get_place

    return get_place().device


def _inexact(v):
    """``v`` as JAX (x64) makes it inexact for a float-valued op: int64 to
    float64, smaller integers and bool to float32, floats as they are."""
    if v.is_floating_point() or v.is_complex():
        return v
    return v.to(torch.float64 if v.dtype == torch.int64 else torch.float32)


def _as_operand(s, like):
    """A Python or numpy scalar beside tensor ``like``, as a 0-d CPU tensor
    (a CUDA op reads it at launch: no host-to-device copy, so it is safe
    inside a CUDA graph capture). A numpy scalar keeps its dtype (a strong
    type in JAX); a Python scalar takes ``like``'s (a weak type), but a
    Python float beside an integer or bool tensor takes the default dtype
    (the JAX package's ``_promote_binop``)."""
    from ..framework import dtype as _dt

    if isinstance(s, torch.Tensor):
        return s
    if isinstance(s, np.generic):
        return torch.as_tensor(np.asarray(s))
    if isinstance(s, float) and not (like.is_floating_point()
                                     or like.is_complex()):
        return torch.tensor(s, dtype=_dt.get_default_dtype())
    if isinstance(s, builtins.complex) and not like.is_complex():
        return torch.tensor(s)
    return torch.tensor(s, dtype=like.dtype)


def _promote(a, b):
    """Two operands of a binary op as tensors of one dtype: a scalar beside
    a tensor by ``_as_operand``, two tensors by type alone (JAX's rule:
    a 0-d float64 tensor beside a float32 one gives float64, where torch
    would keep float32)."""
    if not isinstance(a, torch.Tensor):
        a = _as_operand(a, b)
    elif not isinstance(b, torch.Tensor):
        b = _as_operand(b, a)
    return tuple(_promote_all([a, b]))


def _promote_all(vs):
    """Tensors as one dtype, promoted by type alone (the inputs of a
    concat, a stack or an einsum, as JAX promotes them)."""
    d = vs[0].dtype
    for v in vs[1:]:
        d = torch.promote_types(d, v.dtype)
    return [v if v.dtype == d else v.to(d) for v in vs]


# Submodules (creation / math / ... patch Tensor methods in patch_methods).
from . import creation  # noqa: E402
from . import math  # noqa: E402
from . import manipulation  # noqa: E402
from . import logic  # noqa: E402
from . import reduction  # noqa: E402
from . import search  # noqa: E402
from . import linalg  # noqa: E402
from . import random  # noqa: E402
from . import indexing  # noqa: E402
from . import einsum as _einsum_mod  # noqa: E402
from . import parity  # noqa: E402

from .creation import *  # noqa: F401,F403,E402
from .math import *  # noqa: F401,F403,E402
from .manipulation import *  # noqa: F401,F403,E402
from .logic import *  # noqa: F401,F403,E402
from .reduction import *  # noqa: F401,F403,E402
from .search import *  # noqa: F401,F403,E402
from .linalg import *  # noqa: F401,F403,E402
from .random import *  # noqa: F401,F403,E402
from .einsum import einsum  # noqa: F401,E402
from .parity import *  # noqa: F401,F403,E402

bitwise_invert = logic.bitwise_not       # the reference's second name

from . import patch_methods  # noqa: E402,F401  (binds methods / operators)

# in-place variants (``paddle.tanh_(x)``), made where the methods are bound
globals().update(patch_methods.INPLACE)

__all__ = sorted(
    {"paged_decode_attention", "paged_decode_attention_ref",
     "paged_cache_update", "write_positions", "einsum", "apply_op"}
    | set(patch_methods.INPLACE)
    | {"bitwise_invert"}
    | {n for m in (creation, math, manipulation, logic, reduction, search,
                   linalg, random, parity) for n in m.__all__})
