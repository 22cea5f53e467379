"""Weight bridge between the JAX package and the port, as numpy arrays under
the same parameter names: ``from_paddle_tpu_state`` builds a port model
from the JAX package's GPT state; ``to_paddle_tpu_state`` returns a port
model's parameters the other way, so the two can be compared after steps.

The bridge takes numpy only and imports nothing of JAX; a caller holding a
JAX model passes ``{k: np.asarray(v) for k, v in
jax_model.gpt.raw_state().items()}``. Names may carry the ``gpt.`` prefix
or not. Linear weights keep paddle's ``[in, out]`` layout on both sides, so
nothing is transposed.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.gpt import GPTForCausalLM

__all__ = ["from_paddle_tpu_state", "to_paddle_tpu_state"]


def from_paddle_tpu_state(state, config, device="cuda", dtype=None):
    """dict[str, np.ndarray] + GPTConfig -> GPTForCausalLM on ``device``.
    Every parameter must be present with its exact shape."""
    model = GPTForCausalLM(config, device=device, dtype=dtype)
    params = dict(model.gpt.named_parameters())
    given = {(k[len("gpt."):] if k.startswith("gpt.") else k): v
             for k, v in state.items()}
    missing = sorted(set(params) - set(given))
    extra = sorted(set(given) - set(params))
    if missing or extra:
        raise ValueError(f"state does not match the model: missing "
                         f"{missing}, unexpected {extra}")
    with torch.no_grad():
        for name, p in params.items():
            arr = np.asarray(given[name])
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {arr.shape} != "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(arr)).to(p.dtype))
    return model


def to_paddle_tpu_state(model):
    """{name: np.ndarray} of every parameter of a port model, under the JAX
    package's ``state_dict()`` names (``gpt.blocks.0.attn.qkv_proj.weight``,
    paddle's ``[in, out]`` layout). numpy has no bf16: bf16 parameters come
    back as the float32 arrays of the same values."""
    out = {}
    for name, p in model.named_parameters():
        t = p.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[name] = t.numpy().copy()
    return out
