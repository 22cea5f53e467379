"""Activation recompute — the counterpart of
``paddle_tpu/distributed/fleet/recompute.py:15-60`` (``recompute``,
``recompute_sequential``).

The JAX package wraps the call in ``jax.checkpoint``: the backward replays
the forward, with an optional policy of what to keep. The port runs
non-reentrant ``torch.utils.checkpoint`` with a selective-checkpoint policy
(``torch.utils.checkpoint.create_selective_checkpoint_contexts``):

* ``policy=None`` / ``"block"``: keep only the region's inputs; every op
  is recomputed in the backward;
* ``policy="dots"`` (JAX ``checkpoint_policies.checkpoint_dots``): keep
  the outputs of the matrix products ``aten.mm``, ``aten.addmm``,
  ``aten.bmm`` (and ``aten.matmul``'s 1-d forms ``aten.dot``, ``aten.mv``)
  and recompute the rest. The flash kernels are not a product here, as
  the Pallas call is not a dot in JAX: their forward runs again in the
  backward, and its outputs are recomputed.

Under both policies the output of the dropout mask op (``aten.bernoulli``,
``nn.functional.common.keep_mask``) is kept, one byte an element: the
recomputed forward reuses the forward's masks and draws nothing. That is
the port's ``preserve_rng_state``: JAX recomputes a mask from the same key;
torch can neither rewind a generator inside a CUDA graph capture nor replay
a custom generator through ``torch.utils.checkpoint`` (which stashes torch's
global RNG states, and is given ``preserve_rng_state=False``), so the port
keeps the mask instead. The port's generator advances only in the forward,
so a recomputed step draws what the same step without recompute draws.

The region runs again under the AMP state of its forward (``amp.auto_cast``
may have exited before the backward), so its ops cast as they did.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ... import amp

__all__ = ["recompute", "recompute_sequential", "POLICIES"]

_aten = torch.ops.aten
# the ops whose outputs "dots" keeps, and the random ops every policy keeps
_DOTS = frozenset({_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
                   _aten.dot.default, _aten.mv.default})
_RANDOM = frozenset({_aten.bernoulli.p, _aten.bernoulli.default})
POLICIES = (None, "block", "dots")


def _policy_fn(saved):
    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return policy


def recompute(function, *args, **kwargs):
    """``function(*args, **kwargs)`` with its activations recomputed in the
    backward. ``policy``: None or "block" (keep nothing but the inputs) or
    "dots" (keep the matrix products' outputs). ``use_reentrant`` and
    ``preserve_rng_state`` are accepted as the JAX package accepts them; the
    call is always non-reentrant and always keeps the dropout masks."""
    kwargs.pop("use_reentrant", None)
    kwargs.pop("preserve_rng_state", None)
    policy = kwargs.pop("policy", None)
    if policy not in POLICIES:
        raise ValueError(f"policy must be one of {POLICIES}, got {policy!r}")
    saved = _RANDOM | _DOTS if policy == "dots" else _RANDOM
    state = amp._snapshot()

    def run(*a, **k):
        with amp._restored(state):
            return function(*a, **k)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=functools.partial(
                          create_selective_checkpoint_contexts,
                          _policy_fn(saved)),
                      **kwargs)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """``functions`` (a sequence of layers) in ``ctx["segments"]`` chunks,
    each under ``recompute`` (JAX :47-60)."""
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else 1
    layers = list(functions)
    per = (len(layers) + segments - 1) // segments
    out = args[0] if len(args) == 1 else args
    for i in range(0, len(layers), per):
        chunk = layers[i:i + per]

        def seg_fn(x, _chunk=chunk):
            for layer in _chunk:
                x = layer(x)
            return x

        out = recompute(seg_fn, out, **kwargs)
    return out
