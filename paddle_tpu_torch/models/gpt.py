"""GPT causal LM — the counterpart of ``paddle_tpu/models/gpt.py``.

This slice covers the default ``GPTConfig`` family: RoPE (neox, base 1e4),
pre-norm RMSNorm, SwiGLU MLP, tied embeddings, any ``num_kv_heads`` that
divides ``num_heads``, on three branches of ``GPTAttention``:

* the cache-free forward (JAX ``gpt.py:177-184``, ``:230-233``,
  ``:280-301``): RoPE at ``arange(S)`` (or the given ``position_ids``), then
  ``F.flash_attention(q, k, v, causal=True)`` — the flash kernels on CUDA;
  ``GPTForCausalLM(ids, labels=...)`` returns ``(logits, loss)`` with the
  loss the mean of ``ParallelCrossEntropy``. This is the training path.
* the paged cache branch (JAX ``gpt.py:108-153``): attention over the paged
  KV pool, for the serving step programs and ``verify_step``;
* the dense cache branch (JAX ``gpt.py:154-174``): per-request head-leading
  caches ``[B, Hkv, T, D]`` written in place, attention through
  ``decode_attention`` — the path of dense ``generate()``.

Training options, as in JAX: ``dropout`` in the block (after attention and
after the MLP, ``gpt.py:220``, ``:231-232``) and in attention (``:181``),
which puts attention on the plain route in training, as JAX's XLA route;
``recompute`` "block" or "dots" (``:53-58``, ``:282-290``) through
``distributed.fleet.recompute``. Not ported yet, and refused with
``NotImplementedError``: the GPT-2-style variant (learned positions,
LayerNorm, GELU, ``gpt3_1p3b``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from ..amp import _amp_cast
from ..distributed.fleet.meta_parallel import (
    ColumnParallelLinear,
    ParallelCrossEntropy,
    RowParallelLinear,
    VocabParallelEmbedding,
)
from ..distributed.fleet.recompute import recompute
from ..framework import make_generator, resolve_device
from ..incubate.nn.functional import apply_rope, rope_cos_sin, swiglu
from ..nn import Dropout, RMSNorm
from ..nn import functional as F
from ..ops.decode_attention import decode_attention, decode_attention_ref
from ..ops.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_ref,
    paged_scatter_,
)
from .generation import GenerationMixin

__all__ = ["GPTConfig", "GPTAttention", "GPTMLP", "GPTBlock", "GPTModel",
           "GPTForCausalLM", "PagedStep", "DenseStep", "gpt_tiny",
           "gpt_350m"]

DECODE_KERNELS = ("kernel", "plain")


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, num_kv_heads=None, intermediate_size=None,
                 max_position=2048, dropout=0.0, use_rope=True,
                 use_rms_norm=True, use_swiglu=True, tie_embeddings=True,
                 dtype="float32", recompute=None):
        # None | "block" (save only block inputs) | "dots" (save matmul
        # outputs, recompute the rest)
        if recompute not in (None, "block", "dots"):
            raise ValueError(f"recompute must be None, 'block' or 'dots', "
                             f"got {recompute!r}")
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
    write_rows: torch.Tensor | None   # [N] int64 flat rows b*S+s that
                                # write; None: all B*S rows, in order
    write_slots: torch.Tensor   # [N] int64 flat pool targets page*BS+slot
    tables: torch.Tensor        # [B, NB] int32
    lengths: torch.Tensor       # [B] int32 live prefix before this step


@dataclass
class DenseStep:
    """What every layer of one dense-cache forward shares: the cache rows
    present before it, one host int for the whole batch or an int32 [B]
    tensor on the model's device. Request b's new rows sit at
    ``[length[b], length[b] + S)``, which are also their RoPE positions.
    A captured program passes the tensor (its value changes between
    replays); its caller then sizes the cache so that the rows stay
    inside it (``generate()``: P + bucket rows for at most P + n)."""
    length: int | torch.Tensor


class GPTAttention(nn.Module):
    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        c = config
        self.num_heads = c.num_heads
        self.num_kv_heads = c.num_kv_heads
        self.head_dim = c.hidden_size // c.num_heads
        self.dropout = c.dropout
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
                step: PagedStep | DenseStep | None = None,
                decode_kernel="kernel"):
        """Without ``step``: causal flash attention over the S rows of x
        (attention dropout in training: the plain route).
        With a ``PagedStep``, the paged cache branch: RoPE at absolute
        positions, the new K/V rows scattered into the pools IN PLACE,
        attention over the live prefix plus the causal new rows. With a
        ``DenseStep``, the same over the dense caches [B, Hkv, T, D]
        (``k_pool`` / ``v_pool``): the new rows are written in place at
        ``[length, length + S)``."""
        B, S = x.shape[0], x.shape[1]
        H, Hkv, D = self.num_heads, self.num_kv_heads, self.head_dim
        q, k, v = self.qkv_proj(x).split([H * D, Hkv * D, Hkv * D], dim=-1)
        q = apply_rope(q.reshape(B, S, H, D), *rope)
        k = apply_rope(k.reshape(B, S, Hkv, D), *rope)
        v = v.reshape(B, S, Hkv, D)
        if step is None:
            out, _ = F.flash_attention(q, k, v, dropout=self.dropout,
                                       causal=True, training=self.training)
            return self.out_proj(out.reshape(B, S, H * D))
        if isinstance(step, DenseStep):
            return self.out_proj(self._attend_dense(q, k, v, k_pool, v_pool,
                                                    step, decode_kernel)
                                 .reshape(B, S, H * D))
        paged_scatter_(k_pool, k, step.write_rows, step.write_slots)
        paged_scatter_(v_pool, v, step.write_rows, step.write_slots)
        attend = (paged_decode_attention if decode_kernel == "kernel"
                  else paged_decode_attention_ref)
        out = attend(q, k_pool, v_pool, step.tables, step.lengths,
                     scale=1.0 / math.sqrt(D))
        return self.out_proj(out.reshape(B, S, H * D))

    def _attend_dense(self, q, k, v, k_cache, v_cache, step, decode_kernel):
        """Write the S new K/V rows into the dense caches in place, then
        attend. JAX's ``dynamic_update_slice`` clamps a start past the end;
        ``generate()`` never gets there, so a host length whose rows would
        pass T raises here (a device length is its caller's to bound)."""
        B, S, T = k.shape[0], k.shape[1], k_cache.shape[2]
        lo = step.length
        if isinstance(lo, torch.Tensor):
            pos = lo.long()[:, None] + torch.arange(S, device=k.device)
            b = torch.arange(B, device=k.device)[:, None]
            k_cache[b, :, pos] = k.to(k_cache.dtype)      # [B, S, Hkv, D]
            v_cache[b, :, pos] = v.to(v_cache.dtype)
        else:
            if lo + S > T:
                raise ValueError(f"dense cache holds {T} rows; {S} new rows "
                                 f"at {lo} would pass its end")
            k_cache[:, :, lo:lo + S] = k.transpose(1, 2).to(k_cache.dtype)
            v_cache[:, :, lo:lo + S] = v.transpose(1, 2).to(v_cache.dtype)
        attend = (decode_attention if decode_kernel == "kernel"
                  else decode_attention_ref)
        return attend(q, k_cache, v_cache, lo,
                      scale=1.0 / math.sqrt(self.head_dim))


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
        self.dropout = Dropout(c.dropout)

    def forward(self, x, rope, k_pool=None, v_pool=None, step=None,
                decode_kernel="kernel"):
        if step is None:
            x = x + self.dropout(self.attn(self.ln1(x), rope))
            return x + self.dropout(self.mlp(self.ln2(x)))
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
        default ``arange(S)``), each block under ``recompute`` in training
        when the config sets it. With a ``PagedStep`` or ``DenseStep``:
        attends through (and writes into) the per-layer paged pools or
        dense caches ``k_pools[i]`` / ``v_pools[i]``."""
        x = self.embed_tokens(input_ids)
        head_dim = self.config.hidden_size // self.config.num_heads
        B, S = input_ids.shape
        if step is None:
            pos = (torch.arange(S, device=x.device) if position_ids is None
                   else torch.as_tensor(position_ids, device=x.device))
            rope = rope_cos_sin(pos.expand(B, S), head_dim, x.dtype)
            remat = self.config.recompute if self.training else None
            for blk in self.blocks:
                x = (recompute(blk, x, rope, policy=remat) if remat
                     else blk(x, rope))
        else:
            if decode_kernel not in DECODE_KERNELS:
                raise ValueError(
                    f"decode_kernel must be one of {DECODE_KERNELS}")
            if isinstance(step, DenseStep) and isinstance(step.length,
                                                          torch.Tensor):
                pos = (step.length.long()[:, None]
                       + torch.arange(S, device=x.device))
            elif isinstance(step, DenseStep):
                pos = torch.arange(step.length, step.length + S,
                                   device=x.device).expand(B, S)
            else:
                pos = step.positions
            rope = rope_cos_sin(pos, head_dim, x.dtype)
            for blk, kp, vp in zip(self.blocks, k_pools, v_pools):
                x = blk(x, rope, kp, vp, step, decode_kernel)
        x = self.ln_f(x)
        h, w = _amp_cast("lm_head_tied", x, self.embed_tokens.weight)
        return h @ w.T


class GPTForCausalLM(nn.Module, GenerationMixin):
    """GPT causal LM with the paged step programs of ``GenerationMixin``.

    Weights are drawn from a seeded ``torch.Generator`` on ``device``
    (Xavier as in the JAX package; nothing is downloaded). ``device``
    defaults to CUDA and raises on a machine without it unless the caller
    passes ``device="cpu"``. The model starts in training mode, as a JAX
    ``Layer`` does: dropout and recompute apply to the cache-free forward
    until ``eval()``; the cache branches never apply them."""

    def __init__(self, config: GPTConfig, device="cuda", dtype=None, seed=0):
        super().__init__()
        _check_supported(config)
        dev = resolve_device(device)
        dtype = dtype if dtype is not None else getattr(torch, config.dtype)
        self.config = config
        self.gpt = GPTModel(config, device=dev, dtype=dtype)
        self.reset_parameters(make_generator(seed, dev))

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
        return logits, _amp_cast("mean", per_token)[0].mean()

    # --------------------------------------- GenerationMixin hooks
    def _decode_layer(self):
        return self.gpt

    def _decode_cache_spec(self):
        c = self.config
        return c.num_layers, c.num_kv_heads, c.hidden_size // c.num_heads
