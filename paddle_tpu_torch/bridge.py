"""Weight bridge between the JAX package and the port, as numpy arrays under
the same parameter names: ``from_paddle_tpu_state`` builds the port model
that a config names from the JAX package's state; ``to_paddle_tpu_state``
returns a port model's parameters the other way, so the two can be
compared after steps.

``GPTConfig`` builds ``GPTForCausalLM`` (either family, with the
GPT-2-style variant's positions, biases and untied head), ``LlamaConfig``
``LlamaForCausalLM`` and ``BertConfig`` ``BertForMaskedLM``. Any
``nn.Layer`` model (a ResNet, a Transformer, a recurrent model) takes the
place of a config: it takes the JAX model's ``state_dict()`` under the
same structured names, parameters and persistable buffers (batch norm's
``_mean`` / ``_variance``) alike, and gives its own back the same way.
The recurrent layers carry each cell's ``weight_ih`` / ``weight_hh`` /
``bias_ih`` / ``bias_hh`` per layer and direction
(``cells.{layer·dirs + dir}.weight_ih``), ``SpectralNorm`` its
``weight_u`` / ``weight_v``, ``HSigmoidLoss`` its ``weight`` / ``bias``
and ``AdaptiveLogSoftmaxWithLoss`` its ``head_weight`` (``head_bias``)
and ``tail_{i}_0`` / ``tail_{i}_1``, as JAX names them. The bridge
takes numpy only and imports nothing of JAX; a caller holding a JAX model
passes ``{k: np.asarray(v) for k, v in jax_model.raw_state().items()}``
(or, for GPT, of ``jax_model.gpt.raw_state()``). Names may carry the
model's top prefix (``gpt.``, ``llama.``, ``bert.``) or not. Linear
weights keep paddle's ``[in, out]`` layout on both sides, so nothing is
transposed.

Tensor parallelism: ``shard_state(state, config, tp, rank)`` cuts a GPT,
LLaMA or BERT state into rank ``rank``'s shards of a tp-way model, and
``gather_state(shards, config)`` puts the ranks' shards back together.
The fused ``qkv_proj`` (BERT's ``qkv``) is cut per head group — rank r's
columns are its query heads', then its kv heads' keys, then their
values — and ``gate_up`` per half, as an SPMD rank's attention and SwiGLU
read them: a contiguous cut of the fused columns would give a rank other
heads' keys and compute wrong attention without an error. LLaMA's
separate ``q/k/v/gate/up`` projections and ``lm_head`` are cut in
columns, ``o/down`` in rows, the embeddings in vocabulary rows.
``from_paddle_tpu_state``
cuts the state for a model built over a model-parallel group, and
``to_paddle_tpu_state`` returns that rank's shards.

Pipeline stages and ZeRO: ``stage_state(state, model)`` takes the whole
state under JAX's names (a ``PipelineLayer``'s ``run_function.{i}.…``, a
shared layer under its first use) to the part ``model`` holds on this
rank, each tensor cut where its layout (``distributed.layout``) says:
the stage's layers only, the tensor-parallel shards, the ZeRO-3 rows.
``part_record`` / ``gather_parts`` go back: every rank's parts (state,
gradients or accumulators) placed into the whole tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.bert import BertConfig, BertForMaskedLM
from .nn.layer import Layer
from .models.gpt import GPTConfig, GPTForCausalLM
from .models.llama import LlamaConfig, LlamaForCausalLM

__all__ = ["from_paddle_tpu_state", "to_paddle_tpu_state", "shard_state",
           "gather_state", "stage_state", "part_record", "gather_parts"]

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
    group = getattr(model, "tp_group", None)
    if group is not None:
        state = shard_state(state, config, group.nranks, group.rank)
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


# ---------------------------------------------------- tensor parallelism
# (leaf names cut per head group, in columns, in rows) of each family
_TP_LEAVES = {
    GPTConfig: (("qkv_proj.weight", "qkv_proj.bias"),
                ("fc1.weight", "fc1.bias", "lm_head.weight"),
                ("out_proj.weight", "down.weight")),
    LlamaConfig: ((),
                  ("q_proj.weight", "k_proj.weight", "v_proj.weight",
                   "gate_proj.weight", "up_proj.weight", "lm_head.weight"),
                  ("o_proj.weight", "down_proj.weight")),
    BertConfig: (("qkv.weight", "qkv.bias"),
                 ("fc1.weight", "fc1.bias", "transform.weight",
                  "transform.bias"),
                 ("out.weight", "fc2.weight")),
}


def _gpt_layout(name, config):
    """How a parameter of a GPT, LLaMA or BERT is cut over tp ranks:
    ("rows",) / ("cols",) a contiguous cut of dim 0 / the last dim,
    ("qkv",) per head group, ("halves",) each half of the last dim, None
    replicated."""
    leaf = ".".join(name.split(".")[-2:])
    if name.endswith(("embed_tokens.weight", "word_embeddings.weight")):
        return ("rows",)
    qkv, cols, rows = _TP_LEAVES[_family(config)]
    if leaf in qkv:
        return ("qkv",)
    if leaf == "gate_up.weight":
        return ("halves",)
    if leaf in cols:
        return ("cols",)
    if leaf in rows:
        return ("rows",)
    return None


def _family(config):
    for cfg_type in _TP_LEAVES:
        if isinstance(config, cfg_type):
            return cfg_type
    raise TypeError("tensor-parallel shards are defined for GPT, LLaMA "
                    "and BERT")


def _qkv_parts(config):
    d = config.hidden_size // config.num_heads
    kv = getattr(config, "num_kv_heads", config.num_heads)
    return [config.num_heads * d, kv * d, kv * d]


def _cut(arr, layout, config, tp, rank):
    if layout is None:
        return arr
    kind = layout[0]
    if kind == "rows":
        return np.split(arr, tp, axis=0)[rank]
    if kind == "cols":
        return np.split(arr, tp, axis=-1)[rank]
    parts = (_qkv_parts(config) if kind == "qkv"
             else [arr.shape[-1] // 2] * 2)
    pieces = np.split(arr, np.cumsum(parts)[:-1], axis=-1)
    return np.concatenate([np.split(p, tp, axis=-1)[rank] for p in pieces],
                          axis=-1)


def _join(arrs, layout, config):
    if layout is None:
        return arrs[0]
    kind = layout[0]
    if kind == "rows":
        return np.concatenate(arrs, axis=0)
    if kind == "cols":
        return np.concatenate(arrs, axis=-1)
    tp = len(arrs)
    parts = (_qkv_parts(config) if kind == "qkv"
             else [arrs[0].shape[-1] * tp // 2] * 2)
    local = [p // tp for p in parts]
    per_rank = [np.split(a, np.cumsum(local)[:-1], axis=-1) for a in arrs]
    return np.concatenate([np.concatenate([r[i] for r in per_rank], axis=-1)
                           for i in range(len(parts))], axis=-1)


def _check_tp(config, tp):
    _family(config)
    for what, n in (("num_heads", config.num_heads),
                    ("num_kv_heads", getattr(config, "num_kv_heads",
                                             config.num_heads)),
                    ("intermediate_size", config.intermediate_size),
                    ("vocab_size", config.vocab_size)):
        if n % tp:
            raise ValueError(f"tp={tp} must divide {what} ({n})")


def shard_state(state, config, tp, rank):
    """{name: np.ndarray} of a whole GPT, LLaMA or BERT -> rank ``rank``'s
    shards of a ``tp``-way tensor-parallel model, under the same
    names."""
    _check_tp(config, tp)
    return {k: np.ascontiguousarray(_cut(np.asarray(v),
                                         _gpt_layout(k, config), config, tp,
                                         rank))
            for k, v in state.items()}


def gather_state(shards, config):
    """The inverse of ``shard_state``: every rank's shards, in rank order
    -> the whole state."""
    _check_tp(config, len(shards))
    return {k: _join([np.asarray(s[k]) for s in shards],
                     _gpt_layout(k, config), config)
            for k in shards[0]}


# ------------------------------------- pipeline stages and ZeRO slices
def _tensors(model):
    """{name: torch tensor} of a model's state (a paddle-style Layer's
    Parameters unwrapped; a torch module's own tensors, kept live)."""
    if isinstance(model, Layer):
        return {k: getattr(t, "_value", t)
                for k, t in model.state_dict().items()}
    return dict(model.state_dict(keep_vars=True))


def stage_state(state, model):
    """The whole state (JAX's names: a ``PipelineLayer``'s
    ``run_function.{i}.…`` and its shared layers' first-use names) ->
    ``model``'s part on this rank, under its names: only the stage's
    layers, each tensor cut by its layout (``distributed.layout``: the
    tensor-parallel shards, the ZeRO rows, GPT's fused per-head-group
    columns)."""
    from .distributed.layout import layout_of

    out = {}
    for k, t in _tensors(model).items():
        if k not in state:
            raise KeyError(f"the whole state has no {k!r}")
        arr = np.asarray(state[k])
        shape, pieces = layout_of(t)
        if list(arr.shape) != list(shape):
            raise ValueError(f"{k}: whole shape {arr.shape} != {shape}")
        local = np.empty(tuple(t.shape), dtype=arr.dtype)
        for sl, off in pieces:
            src = tuple(slice(o, o + (s.stop - s.start))
                        for o, s in zip(off, sl))
            local[sl] = arr[src]
        out[k] = local
    return out


def part_record(model, values=None):
    """{name: (array, global shape, pieces)} of this rank's part of
    ``model``'s state (or of ``values``, {name: tensor} laid out like it:
    gradients) for ``gather_state``; bf16 as f32."""
    from .distributed.layout import layout_of

    out = {}
    for k, t in _tensors(model).items():
        v = t if values is None else values.get(k)
        if v is None:
            continue
        # a value with a layout of its own (a ZeRO accumulator's rows)
        shape, pieces = layout_of(v if hasattr(v, "_global_shape") else t)
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            v = v.float()
        out[k] = (v.numpy().copy(), shape,
                  [([(s.start, s.stop) for s in sl], off)
                   for sl, off in pieces])
    return out


def gather_parts(records):
    """The whole state from every rank's ``part_record``: each part placed
    where its layout says (replicas write the same values)."""
    whole = {}
    for rec in records:
        for k, (arr, shape, pieces) in rec.items():
            if k not in whole:
                whole[k] = np.zeros(shape, dtype=arr.dtype)
            for sl, off in pieces:
                src = tuple(slice(a, b) for a, b in sl)
                dst = tuple(slice(o, o + (b - a))
                            for o, (a, b) in zip(off, sl))
                whole[k][dst] = arr[src]
    return whole
