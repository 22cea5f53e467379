"""GPT causal LM — the counterpart of ``paddle_tpu/models/gpt.py``.

This slice covers the default ``GPTConfig`` family: RoPE (neox, base 1e4),
pre-norm RMSNorm, SwiGLU MLP, tied embeddings, any ``num_kv_heads`` that
divides ``num_heads``, on two branches of ``GPTAttention``:

* the cache-free forward (JAX ``gpt.py:177-184``, ``:230-233``,
  ``:280-301``): RoPE at ``arange(S)`` (or the given ``position_ids``), then
  ``F.flash_attention(q, k, v, causal=True)`` — the flash kernels on CUDA;
  ``GPTForCausalLM(ids, labels=...)`` returns ``(logits, loss)`` with the
  loss the mean of ``ParallelCrossEntropy``. This is the training path.
* the paged cache branch (JAX ``gpt.py:108-176``): attention over the paged
  KV pool, for the serving step programs.

Not ported yet, and refused with ``NotImplementedError``: the GPT-2-style
variant (learned positions, LayerNorm, GELU, ``gpt3_1p3b``), dropout,
recompute; dense ``generate()`` and ``verify_step`` are refused in
``generation.py``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from ..distributed.fleet.meta_parallel import (
    ColumnParallelLinear,
    ParallelCrossEntropy,
    RowParallelLinear,
    VocabParallelEmbedding,
)
from ..framework import make_generator, resolve_device
from ..incubate.nn.functional import apply_rope, rope_cos_sin, swiglu
from ..nn import RMSNorm
from ..nn import functional as F
from ..ops.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_ref,
    paged_scatter_,
)
from .generation import GenerationMixin

__all__ = ["GPTConfig", "GPTAttention", "GPTMLP", "GPTBlock", "GPTModel",
           "GPTForCausalLM", "PagedStep", "gpt_tiny", "gpt_350m"]

DECODE_KERNELS = ("kernel", "plain")


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, num_kv_heads=None, intermediate_size=None,
                 max_position=2048, dropout=0.0, use_rope=True,
                 use_rms_norm=True, use_swiglu=True, tie_embeddings=True,
                 dtype="float32", recompute=None):
        if dropout != 0.0:
            raise NotImplementedError(
                "dropout is not ported yet (the JAX package draws its masks "
                "from jax.random); use dropout=0.0")
        if recompute is not None:
            raise NotImplementedError(
                f"recompute={recompute!r} is not ported yet; use None")
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.max_position = max_position
        self.dropout = dropout
        self.use_rope = use_rope
        self.use_rms_norm = use_rms_norm
        self.use_swiglu = use_swiglu
        self.tie_embeddings = tie_embeddings
        self.dtype = dtype
        self.recompute = recompute


def gpt_tiny():
    return GPTConfig(vocab_size=1024, hidden_size=64, num_layers=2,
                     num_heads=4, max_position=128)


def gpt_350m(max_position=1024):
    """GPT-350M at full width — the configuration ``bench.py``
    (``_gpt350m_cfg``) measures for the JAX package: 24 layers, hidden
    1024, 16 heads of 64, SwiGLU 4096, vocab 50304."""
    return GPTConfig(vocab_size=50304, hidden_size=1024, num_layers=24,
                     num_heads=16, max_position=max_position, use_rope=True,
                     use_rms_norm=True, use_swiglu=True)


def _check_supported(c: GPTConfig):
    missing = [name for name, ok in (
        ("learned positions (use_rope=False)", c.use_rope),
        ("LayerNorm (use_rms_norm=False)", c.use_rms_norm),
        ("GELU MLP (use_swiglu=False)", c.use_swiglu),
        ("untied lm_head (tie_embeddings=False)", c.tie_embeddings))
        if not ok]
    if missing:
        raise NotImplementedError(
            "the GPT-2-style variant is not ported yet: "
            + ", ".join(missing))
    if c.num_heads % c.num_kv_heads:
        raise ValueError(f"num_kv_heads {c.num_kv_heads} must divide "
                         f"num_heads {c.num_heads}")


@dataclass
class PagedStep:
    """What every layer of one forward shares: RoPE positions, the pool
    write targets, and the attention's tables and lengths (all on the
    model's device)."""
    positions: torch.Tensor     # [B, S] int64 absolute positions
    write_rows: torch.Tensor    # [N] int64 flat rows b*S+s that write
    write_slots: torch.Tensor   # [N] int64 flat pool targets page*BS+slot
    tables: torch.Tensor        # [B, NB] int32
    lengths: torch.Tensor       # [B] int32 live prefix before this step


class GPTAttention(nn.Module):
    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        c = config
        self.num_heads = c.num_heads
        self.num_kv_heads = c.num_kv_heads
        self.head_dim = c.hidden_size // c.num_heads
        q_size = c.hidden_size
        kv_size = self.num_kv_heads * self.head_dim
        self.qkv_proj = ColumnParallelLinear(c.hidden_size,
                                             q_size + 2 * kv_size,
                                             has_bias=False, device=device,
                                             dtype=dtype)
        self.out_proj = RowParallelLinear(c.hidden_size, c.hidden_size,
                                          has_bias=False, device=device,
                                          dtype=dtype)

    def forward(self, x, rope, k_pool=None, v_pool=None,
                step: PagedStep | None = None, decode_kernel="kernel"):
        """Without ``step``: causal flash attention over the S rows of x.
        With it, the paged cache branch: RoPE at absolute positions, the new
        K/V rows scattered into the pools IN PLACE, attention over the live
        prefix plus the causal new rows."""
        B, S = x.shape[0], x.shape[1]
        H, Hkv, D = self.num_heads, self.num_kv_heads, self.head_dim
        q, k, v = self.qkv_proj(x).split([H * D, Hkv * D, Hkv * D], dim=-1)
        q = apply_rope(q.reshape(B, S, H, D), *rope)
        k = apply_rope(k.reshape(B, S, Hkv, D), *rope)
        v = v.reshape(B, S, Hkv, D)
        if step is None:
            out, _ = F.flash_attention(q, k, v, causal=True)
            return self.out_proj(out.reshape(B, S, H * D))
        paged_scatter_(k_pool, k, step.write_rows, step.write_slots)
        paged_scatter_(v_pool, v, step.write_rows, step.write_slots)
        attend = (paged_decode_attention if decode_kernel == "kernel"
                  else paged_decode_attention_ref)
        out = attend(q, k_pool, v_pool, step.tables, step.lengths,
                     scale=1.0 / math.sqrt(D))
        return self.out_proj(out.reshape(B, S, H * D))


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        c = config
        self.gate_up = ColumnParallelLinear(c.hidden_size,
                                            2 * c.intermediate_size,
                                            has_bias=False, device=device,
                                            dtype=dtype)
        self.down = RowParallelLinear(c.intermediate_size, c.hidden_size,
                                      has_bias=False, device=device,
                                      dtype=dtype)

    def forward(self, x):
        return self.down(swiglu(self.gate_up(x)))


class GPTBlock(nn.Module):
    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        c = config
        self.ln1 = RMSNorm(c.hidden_size, device=device, dtype=dtype)
        self.attn = GPTAttention(c, device=device, dtype=dtype)
        self.ln2 = RMSNorm(c.hidden_size, device=device, dtype=dtype)
        self.mlp = GPTMLP(c, device=device, dtype=dtype)

    def forward(self, x, rope, k_pool=None, v_pool=None, step=None,
                decode_kernel="kernel"):
        x = x + self.attn(self.ln1(x), rope, k_pool, v_pool, step,
                          decode_kernel)
        return x + self.mlp(self.ln2(x))


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        c = config
        self.config = c
        self.embed_tokens = VocabParallelEmbedding(c.vocab_size,
                                                   c.hidden_size,
                                                   device=device, dtype=dtype)
        self.blocks = nn.ModuleList([GPTBlock(c, device=device, dtype=dtype)
                                     for _ in range(c.num_layers)])
        self.ln_f = RMSNorm(c.hidden_size, device=device, dtype=dtype)

    def forward(self, input_ids, k_pools=None, v_pools=None, step=None,
                decode_kernel="kernel", position_ids=None):
        """input_ids [B, S] -> logits [B, S, V]. Without ``step``: the
        cache-free causal forward, RoPE at ``position_ids`` ([S] or [B, S],
        default ``arange(S)``). With it: attends through (and writes into)
        the per-layer pools ``k_pools[i]`` / ``v_pools[i]``."""
        x = self.embed_tokens(input_ids)
        head_dim = self.config.hidden_size // self.config.num_heads
        if step is None:
            B, S = input_ids.shape
            pos = (torch.arange(S, device=x.device) if position_ids is None
                   else torch.as_tensor(position_ids, device=x.device))
            rope = rope_cos_sin(pos.expand(B, S), head_dim, x.dtype)
            for blk in self.blocks:
                x = blk(x, rope)
        else:
            if decode_kernel not in DECODE_KERNELS:
                raise ValueError(
                    f"decode_kernel must be one of {DECODE_KERNELS}")
            rope = rope_cos_sin(step.positions, head_dim, x.dtype)
            for blk, kp, vp in zip(self.blocks, k_pools, v_pools):
                x = blk(x, rope, kp, vp, step, decode_kernel)
        x = self.ln_f(x)
        return x @ self.embed_tokens.weight.T


class GPTForCausalLM(nn.Module, GenerationMixin):
    """GPT causal LM with the paged step programs of ``GenerationMixin``.

    Weights are drawn from a seeded ``torch.Generator`` on ``device``
    (Xavier as in the JAX package; nothing is downloaded). ``device``
    defaults to CUDA and raises on a machine without it unless the caller
    passes ``device="cpu"``."""

    def __init__(self, config: GPTConfig, device="cuda", dtype=None, seed=0):
        super().__init__()
        _check_supported(config)
        dev = resolve_device(device)
        dtype = dtype if dtype is not None else getattr(torch, config.dtype)
        self.config = config
        self.gpt = GPTModel(config, device=dev, dtype=dtype)
        self.reset_parameters(make_generator(seed, dev))
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.gpt.embed_tokens.weight.device

    @torch.no_grad()
    def reset_parameters(self, generator):
        for mod in self.modules():
            if hasattr(mod, "reset_parameters") and mod is not self:
                mod.reset_parameters(generator)

    def forward(self, input_ids, labels=None, position_ids=None):
        """logits [B, S, V], or (logits, loss) with ``labels`` [B, S]: loss
        the mean over all tokens of ``ParallelCrossEntropy`` (ignored labels
        count as 0), in the logits' dtype (JAX ``gpt.py:310-321``)."""
        input_ids = torch.as_tensor(input_ids, device=self.device)
        logits = self.gpt(input_ids, position_ids=position_ids)
        if labels is None:
            return logits
        labels = torch.as_tensor(labels, device=self.device)
        per_token = ParallelCrossEntropy()(
            logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))
        return logits, per_token.mean()

    # --------------------------------------- GenerationMixin hooks
    def _decode_layer(self):
        return self.gpt

    def _decode_cache_spec(self):
        c = self.config
        return c.num_layers, c.num_kv_heads, c.hidden_size // c.num_heads
