"""Weight bridge between the JAX package and the port, as numpy arrays under
the same parameter names: ``from_paddle_tpu_state`` builds the port model
that a config names from the JAX package's state; ``to_paddle_tpu_state``
returns a port model's parameters the other way, so the two can be
compared after steps.

``GPTConfig`` builds ``GPTForCausalLM`` (either family, with the
GPT-2-style variant's positions, biases and untied head), ``LlamaConfig``
``LlamaForCausalLM`` and ``BertConfig`` ``BertForMaskedLM``. The bridge
takes numpy only and imports nothing of JAX; a caller holding a JAX model
passes ``{k: np.asarray(v) for k, v in jax_model.raw_state().items()}``
(or, for GPT, of ``jax_model.gpt.raw_state()``). Names may carry the
model's top prefix (``gpt.``, ``llama.``, ``bert.``) or not. Linear
weights keep paddle's ``[in, out]`` layout on both sides, so nothing is
transposed.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.bert import BertConfig, BertForMaskedLM
from .models.gpt import GPTConfig, GPTForCausalLM
from .models.llama import LlamaConfig, LlamaForCausalLM

__all__ = ["from_paddle_tpu_state", "to_paddle_tpu_state"]

# config type -> (model class, the top module whose prefix is optional)
_MODELS = {GPTConfig: (GPTForCausalLM, "gpt"),
           LlamaConfig: (LlamaForCausalLM, "llama"),
           BertConfig: (BertForMaskedLM, "bert")}


def _model_for(config):
    for cfg_type, entry in _MODELS.items():
        if isinstance(config, cfg_type):
            return entry
    raise TypeError(f"no port model for {type(config).__name__}")


def from_paddle_tpu_state(state, config, device="cuda", dtype=None):
    """dict[str, np.ndarray] + a model config -> the port model on
    ``device``. Every parameter must be present with its exact shape, and
    no other name may be."""
    cls, top = _model_for(config)
    model = cls(config, device=device, dtype=dtype)
    params = dict(model.named_parameters())
    given = {}
    for k, v in state.items():
        name = k if k in params else f"{top}.{k}"
        given[name] = v
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
    ``llama.layers.0.self_attn.q_proj.weight``, ``lm_head.weight``, paddle's
    ``[in, out]`` layout). numpy has no bf16: bf16 parameters come back as
    the float32 arrays of the same values."""
    out = {}
    for name, p in model.named_parameters():
        t = p.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[name] = t.numpy().copy()
    return out
