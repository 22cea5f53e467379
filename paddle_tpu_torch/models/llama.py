"""LLaMA causal LM — the counterpart of ``paddle_tpu/models/llama.py``.

``LlamaForCausalLM`` keeps the JAX package's parameter names
(``llama.layers.N.self_attn.q_proj.weight``, ..., ``llama.norm.weight``,
``lm_head.weight``), so ``bridge.py`` maps them by name: separate q / k /
v / o and gate / up / down projections without biases,
``silu(gate) * up`` (JAX ``llama.py:167-168``), pre-norm RMSNorm at
``rms_eps``, neox RoPE at ``rope_theta``, any GQA (``num_kv_heads``
dividing ``num_heads``) and an untied ``lm_head``.

The attention has the three branches of ``GPTAttention``: the cache-free
causal forward through ``F.flash_attention`` (the flash kernels on CUDA;
the training path, each layer under ``recompute`` "block" or "dots" in
training when the config sets it), the paged cache branch (the serving
step programs, ``verify_step``) and the dense cache branch (dense
``generate()``). Its decode layer (``LlamaDecoder``) takes the call of
``GPTModel``'s, ``(ids, k_caches, v_caches, step, decode_kernel)`` ->
logits, so ``GenerationMixin``, the schedulers, the servers and
speculative decoding serve it as they serve GPT.

Tensor parallelism follows JAX's layer kinds (``llama.py:69-75``,
``:160-164``, ``:241``), as ``GPTForCausalLM`` does: given a
model-parallel group of tp ranks (``mp_group=``, else the hybrid group's
mp axis or the serving mesh's "tp" axis; ``fleet.mp_ops.mp_group``),
``q/k/v/gate/up`` are column-parallel and ``o/down`` row-parallel, so a
rank attends on ``num_heads / tp`` query and ``num_kv_heads / tp`` kv
heads (RoPE on its local heads; tp must divide both, GQA groups stay
whole) and its paged pool is head-sharded ``[Hkv / tp, P, BS, D]``; the
embedding is vocabulary-parallel and ``lm_head`` column-parallel, its
vocab columns not gathered: the loss is ``ParallelCrossEntropy``,
``gather_logits`` gathers them, and the step programs gather them before
the sampler. ``bridge.shard_state`` cuts JAX's whole weights into a
rank's shards.
"""
from __future__ import annotations

import torch
from torch import nn

from ..amp import _amp_add, _amp_cast
from ..distributed.fleet.meta_parallel import (
    ColumnParallelLinear,
    ParallelCrossEntropy,
    RowParallelLinear,
    VocabParallelEmbedding,
)
from ..distributed.fleet.mp_ops import (
    gather_last,
    mp_group as resolve_mp_group,
)
from ..distributed.fleet.recompute import recompute
from ..framework import make_generator, resolve_device
from ..incubate.nn.functional import apply_rope, rope_cos_sin
from ..nn import RMSNorm
from ..nn import functional as F
from ..ops.decode_attention import decode_attention, decode_attention_ref
from ..ops.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_ref,
)
from .generation import GenerationMixin
from .steps import (DECODE_KERNELS, attend_cached, kernel_serves,
                    step_positions)

__all__ = ["LlamaConfig", "LlamaAttention", "LlamaMLP", "LlamaDecoderLayer",
           "LlamaModel", "LlamaForCausalLM", "llama2_7b", "llama_tiny"]


class LlamaConfig:
    def __init__(self, vocab_size=32000, hidden_size=4096, num_layers=32,
                 num_heads=32, num_kv_heads=None, intermediate_size=11008,
                 max_position=4096, rms_eps=1e-5, rope_theta=10000.0,
                 recompute=None):
        if recompute not in (None, "block", "dots"):
            raise ValueError(f"recompute must be None, 'block' or 'dots', "
                             f"got {recompute!r}")
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.intermediate_size = intermediate_size
        self.max_position = max_position
        self.rms_eps = rms_eps
        self.rope_theta = rope_theta
        self.recompute = recompute


def llama2_7b():
    """LLaMA-2-7B (BASELINE config 5): 32 layers, hidden 4096, 32 heads of
    128, SwiGLU 11008, vocab 32000, untied head."""
    return LlamaConfig()


def llama_tiny():
    """A CPU-sized shape with real GQA (4 q heads over 2 kv heads)."""
    return LlamaConfig(vocab_size=512, hidden_size=64, num_layers=2,
                       num_heads=4, num_kv_heads=2, intermediate_size=128,
                       max_position=128)


def _check_supported(c: LlamaConfig, group=None):
    if c.num_heads % c.num_kv_heads:
        raise ValueError(f"num_kv_heads {c.num_kv_heads} must divide "
                         f"num_heads {c.num_heads}")
    tp = 1 if group is None else group.nranks
    for what, n in (("num_heads", c.num_heads),
                    ("num_kv_heads", c.num_kv_heads),
                    ("intermediate_size", c.intermediate_size),
                    ("vocab_size", c.vocab_size)):
        if n % tp:
            raise ValueError(f"tensor parallelism over {tp} ranks needs tp "
                             f"to divide {what} ({n})")


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None,
                 group=False):
        super().__init__()
        c = config
        tp = 1 if not group else group.nranks
        # this rank's heads (all of them without a group)
        self.num_heads = c.num_heads // tp
        self.num_kv_heads = c.num_kv_heads // tp
        self.head_dim = c.hidden_size // c.num_heads
        kv_size = c.num_kv_heads * self.head_dim
        kw = dict(has_bias=False, mp_group=group, device=device, dtype=dtype)
        col = dict(kw, gather_output=False)
        self.q_proj = ColumnParallelLinear(c.hidden_size, c.hidden_size,
                                           **col)
        self.k_proj = ColumnParallelLinear(c.hidden_size, kv_size, **col)
        self.v_proj = ColumnParallelLinear(c.hidden_size, kv_size, **col)
        self.o_proj = RowParallelLinear(c.hidden_size, c.hidden_size,
                                        input_is_parallel=True, **kw)

    def forward(self, x, rope, k_pool=None, v_pool=None, step=None,
                decode_kernel="kernel"):
        """As ``GPTAttention.forward``: causal flash attention without
        ``step``; the paged or dense cache branch with one."""
        B, S = x.shape[0], x.shape[1]
        H, Hkv, D = self.num_heads, self.num_kv_heads, self.head_dim
        q, k = apply_rope(self.q_proj(x).reshape(B, S, H, D), *rope,
                          self.k_proj(x).reshape(B, S, Hkv, D))
        v = self.v_proj(x).reshape(B, S, Hkv, D)
        if step is None:
            out, _ = F.flash_attention(q, k, v, causal=True,
                                       training=self.training)
        else:
            kernel = kernel_serves(decode_kernel, q)
            out = attend_cached(
                q, k, v, k_pool, v_pool, step,
                paged_decode_attention if kernel
                else paged_decode_attention_ref,
                decode_attention if kernel else decode_attention_ref)
        return self.o_proj(out.reshape(B, S, H * D))


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None,
                 group=False):
        super().__init__()
        c = config
        kw = dict(has_bias=False, mp_group=group, device=device, dtype=dtype)
        col = dict(kw, gather_output=False)
        self.gate_proj = ColumnParallelLinear(c.hidden_size,
                                              c.intermediate_size, **col)
        self.up_proj = ColumnParallelLinear(c.hidden_size,
                                            c.intermediate_size, **col)
        self.down_proj = RowParallelLinear(c.intermediate_size,
                                           c.hidden_size,
                                           input_is_parallel=True, **kw)

    def forward(self, x):
        g, u = _amp_cast("multiply", F.silu(self.gate_proj(x)),
                         self.up_proj(x))
        return self.down_proj(g * u)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None,
                 group=False):
        super().__init__()
        c = config
        self.input_layernorm = RMSNorm(c.hidden_size, epsilon=c.rms_eps,
                                       device=device, dtype=dtype)
        self.self_attn = LlamaAttention(c, device=device, dtype=dtype,
                                        group=group)
        self.post_attention_layernorm = RMSNorm(
            c.hidden_size, epsilon=c.rms_eps, device=device, dtype=dtype)
        self.mlp = LlamaMLP(c, device=device, dtype=dtype, group=group)

    def forward(self, x, rope, k_pool=None, v_pool=None, step=None,
                decode_kernel="kernel"):
        x = _amp_add(x, self.self_attn(self.input_layernorm(x), rope,
                                       k_pool, v_pool, step, decode_kernel))
        return _amp_add(x, self.mlp(self.post_attention_layernorm(x)))


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None,
                 group=False):
        super().__init__()
        c = config
        self.config = c
        self.embed_tokens = VocabParallelEmbedding(c.vocab_size,
                                                   c.hidden_size,
                                                   mp_group=group,
                                                   device=device, dtype=dtype)
        self.layers = nn.ModuleList([
            LlamaDecoderLayer(c, device=device, dtype=dtype, group=group)
            for _ in range(c.num_layers)])
        self.norm = RMSNorm(c.hidden_size, epsilon=c.rms_eps, device=device,
                            dtype=dtype)

    def forward(self, input_ids, k_pools=None, v_pools=None, step=None,
                decode_kernel="kernel", position_ids=None):
        """input_ids [B, S] -> the final normed hidden states [B, S, h].
        Without ``step``: the cache-free causal forward at ``position_ids``
        ([S] or [B, S], default ``arange(S)``); with a ``PagedStep`` or
        ``DenseStep``: through the per-layer pools or dense caches."""
        c = self.config
        x = self.embed_tokens(input_ids)
        B, S = input_ids.shape
        if step is None:
            pos = (torch.arange(S, device=x.device) if position_ids is None
                   else torch.as_tensor(position_ids, device=x.device))
            pos = pos.expand(B, S)
        else:
            if decode_kernel not in DECODE_KERNELS:
                raise ValueError(
                    f"decode_kernel must be one of {DECODE_KERNELS}")
            pos = step_positions(step, B, S, x.device)
        rope = rope_cos_sin(pos, c.hidden_size // c.num_heads, x.dtype,
                            base=c.rope_theta)
        if step is None:
            remat = c.recompute if self.training else None
            for blk in self.layers:
                x = (recompute(blk, x, rope, policy=remat) if remat
                     else blk(x, rope))
        else:
            for blk, kp, vp in zip(self.layers, k_pools, v_pools):
                x = blk(x, rope, kp, vp, step, decode_kernel)
        return self.norm(x)


class LlamaDecoder(nn.Module):
    """The decode layer of ``LlamaForCausalLM``: the model's own ``llama``
    and ``lm_head``, under their names, called as ``GPTModel`` is on the
    cache branches -> logits."""

    def __init__(self, llama, lm_head):
        super().__init__()
        self.llama = llama
        self.lm_head = lm_head

    def forward(self, input_ids, k_pools, v_pools, step, decode_kernel):
        return self.lm_head(self.llama(input_ids, k_pools, v_pools, step,
                                       decode_kernel))


class LlamaForCausalLM(nn.Module, GenerationMixin):
    """LLaMA with an untied ``lm_head`` (the LLaMA-2 convention) and the
    step programs of ``GenerationMixin``. Weights are drawn from a seeded
    ``torch.Generator`` on ``device`` (Xavier, as in the JAX package;
    nothing is downloaded). ``device`` defaults to CUDA and raises on a
    machine without it unless the caller passes ``device="cpu"``. The
    model starts in training mode, as a JAX ``Layer`` does."""

    def __init__(self, config: LlamaConfig, device="cuda", dtype=None,
                 seed=0, mp_group=None):
        super().__init__()
        c = config
        group = resolve_mp_group(mp_group)
        _check_supported(c, group)
        dev = resolve_device(device)
        self.config = c
        self.tp_group = group
        self.llama = LlamaModel(c, device=dev, dtype=dtype,
                                group=group or False)
        self.lm_head = ColumnParallelLinear(c.hidden_size, c.vocab_size,
                                            has_bias=False,
                                            gather_output=False,
                                            mp_group=group or False,
                                            device=dev, dtype=dtype)
        # held outside the module tree: its parameters are the model's own
        self.__dict__["_decoder"] = LlamaDecoder(self.llama, self.lm_head)
        self.reset_parameters(make_generator(seed, dev))

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    @torch.no_grad()
    def reset_parameters(self, generator):
        for mod in self.modules():
            if hasattr(mod, "reset_parameters") and mod is not self:
                mod.reset_parameters(generator)

    def forward(self, input_ids, labels=None, position_ids=None):
        """logits [B, S, V] (this rank's vocab columns under tensor
        parallelism), or (logits, loss) with ``labels`` [B, S]: the mean
        of ``ParallelCrossEntropy`` over all tokens (JAX
        ``llama.py:244-259``)."""
        input_ids = torch.as_tensor(input_ids, device=self.device)
        logits = self.lm_head(self.llama(input_ids,
                                         position_ids=position_ids))
        if labels is None:
            return logits
        labels = torch.as_tensor(labels, device=self.device)
        per_token = ParallelCrossEntropy(mp_group=self.tp_group or False)(
            logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))
        return logits, _amp_cast("mean", per_token)[0].mean()

    def gather_logits(self, logits):
        """The whole vocab of logits from this rank's columns (a gather
        over the model-parallel group); the logits as they are without
        one."""
        if self.tp_group is None:
            return logits
        return gather_last(logits, self.tp_group)

    # --------------------------------------- GenerationMixin hooks
    def _decode_layer(self):
        return self._decoder

    def _decode_cache_spec(self):
        c = self.config
        return c.num_layers, c.num_kv_heads, c.hidden_size // c.num_heads

    def _decode_validate(self, prompt_len, max_new_tokens):
        """RoPE positions extrapolate: no table to pass."""
