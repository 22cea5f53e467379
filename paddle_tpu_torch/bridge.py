"""Weight bridge between the JAX package and the port, as numpy arrays under
the same parameter names: ``from_paddle_tpu_state`` builds the port model
that a config names from the JAX package's state; ``to_paddle_tpu_state``
returns a port model's parameters the other way, so the two can be
compared after steps.

``GPTConfig`` builds ``GPTForCausalLM`` (either family, with the
GPT-2-style variant's positions, biases and untied head), ``LlamaConfig``
``LlamaForCausalLM`` and ``BertConfig`` ``BertForMaskedLM``. Any
``nn.Layer`` model (a ResNet, a Transformer) takes the place of a config:
it takes the JAX model's ``state_dict()`` under the same structured names,
parameters and persistable buffers (batch norm's ``_mean`` /
``_variance``) alike, and gives its own back the same way. The bridge
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
from .nn.layer import Layer
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


def _load_layer(layer, state):
    """``state`` into ``layer`` by structured name, each value into its
    tensor's storage and dtype; every entry of the layer's state dict must
    be given with its exact shape, and no other name."""
    own = layer.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise ValueError(f"state does not match the model: missing "
                         f"{missing}, unexpected {extra}")
    for k, t in own.items():
        if tuple(np.shape(state[k])) != tuple(t.shape):
            raise ValueError(f"{k}: shape {np.shape(state[k])} != "
                             f"{tuple(t.shape)}")
    layer.set_state_dict(state)
    return layer


def from_paddle_tpu_state(state, config, device="cuda", dtype=None):
    """dict[str, np.ndarray] + a model config -> the port model on
    ``device``; or + an ``nn.Layer`` -> that layer, loaded. Every parameter
    (and, for a Layer, persistable buffer) must be present with its exact
    shape, and no other name may be."""
    if isinstance(config, Layer):
        return _load_layer(config, state)
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
    ``[in, out]`` layout); for an ``nn.Layer``, its ``state_dict()``
    (buffers too). numpy has no bf16: bf16 parameters come back as the
    float32 arrays of the same values."""
    out = {}
    items = (((k, t._value) for k, t in model.state_dict().items())
             if isinstance(model, Layer) else model.named_parameters())
    for name, p in items:
        t = p.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[name] = t.numpy().copy()
    return out
