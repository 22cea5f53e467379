"""GPT causal LM — the counterpart of ``paddle_tpu/models/gpt.py``.

Both of the JAX package's families: the default ``GPTConfig`` (RoPE,
pre-norm RMSNorm, SwiGLU MLP, tied embeddings, ``gpt_350m``) and the
GPT-2-style variant (``gpt3_1p3b``: learned positions
``embed_positions``, LayerNorm, ``fc1`` -> GELU -> ``down`` with biases,
biased ``qkv_proj`` / ``out_proj``, and an untied ``lm_head`` when
``tie_embeddings=False``); any ``num_kv_heads`` that divides
``num_heads``. ``GPTAttention`` has three branches:

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

Learned positions index ``embed_positions`` at the rows' absolute
positions clipped to ``[0, max_position - 1]``, as JAX clips the paged
branch's (``gpt.py:257-266``): padding and scratch rows reach past the
table, and an index past it is a device-side assert on CUDA.
``_decode_validate`` refuses a request whose prompt and new tokens pass
``max_position`` (JAX ``gpt.py:330-337``), and the cache-free forward a
sequence longer than the table.

Training options, as in JAX: ``dropout`` in the block (after attention and
after the MLP, ``gpt.py:220``, ``:231-232``) and in attention (``:181``),
which puts attention on the plain route in training, as JAX's XLA route;
``recompute`` "block" or "dots" (``:53-58``, ``:282-290``) through
``distributed.fleet.recompute``.

Tensor parallelism: given a model-parallel group of tp ranks
(``mp_group=``, else the hybrid group's mp axis or the serving mesh's
"tp" axis; ``distributed.fleet.mp_ops.mp_group``), each rank holds its
shards, as JAX's GSPMD run holds them on each device: attention on
``num_heads / tp`` query and ``num_kv_heads / tp`` kv heads (``qkv_proj``'s
local columns are ``[q_r | k_r | v_r]``, cut per head group by
``bridge.shard_state``), the MLP on ``intermediate_size / tp``, the
vocab-sharded embedding and (tied) ``lm_head``, the loss through the
vocab-parallel ``ParallelCrossEntropy`` (JAX ``gpt.py:315-317``). The
forward returns the rank's vocab columns of the logits
(``gather_logits`` gathers them); the step programs gather them before
the sampler. tp must divide the heads, the kv heads (GQA groups stay
whole, as JAX's ``decode_attention.py:276`` declines to shard otherwise),
the MLP width and the vocab. The same classes serve tp = 1 unchanged.

Pipeline form (JAX ``gpt.py:350-428``): ``gpt_pipeline(config,
num_stages)`` is the model as a ``distributed.fleet.PipelineLayer`` of
``GPTEmbeddingPipe``, ``GPTBlockPipe`` (a block that makes its RoPE
tables from the sequence length), ``GPTNormPipe`` and ``GPTHeadPipe`` or
the tied head ``_tied_lm_head``, with the loss ``gpt_causal_lm_loss``.
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
    mark_fused,
)
from ..distributed.fleet.mp_ops import (
    gather_last,
    identity_allreduce,
    mp_group as resolve_mp_group,
)
from ..distributed.fleet.recompute import recompute
from ..framework import make_generator, resolve_device
from ..incubate.nn.functional import apply_rope, rope_cos_sin, swiglu
from ..nn import Dropout, Embedding, LayerNorm, RMSNorm
from ..nn import functional as F
from ..ops.decode_attention import decode_attention, decode_attention_ref
from ..ops.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_ref,
)
from .generation import GenerationMixin
from .steps import (
    DECODE_KERNELS,
    DenseStep,
    PagedStep,
    attend_cached,
    kernel_serves,
    step_positions,
)

__all__ = ["GPTConfig", "GPTAttention", "GPTMLP", "GPTBlock", "GPTModel",
           "GPTForCausalLM", "PagedStep", "DenseStep", "gpt_tiny",
           "gpt_350m", "gpt3_1p3b", "GPTEmbeddingPipe", "GPTBlockPipe",
           "GPTNormPipe", "GPTHeadPipe", "gpt_causal_lm_loss",
           "gpt_pipeline"]


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


def gpt3_1p3b():
    """GPT-3 1.3B (BASELINE config 4) at full width, the GPT-2-style
    variant: 24 layers, hidden 2048, 16 heads of 128, learned positions to
    2048, LayerNorm, GELU 8192 with biases, tied embeddings, vocab
    50304."""
    return GPTConfig(vocab_size=50304, hidden_size=2048, num_layers=24,
                     num_heads=16, use_rope=False, use_rms_norm=False,
                     use_swiglu=False)


def _check_supported(c: GPTConfig, group=None):
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


def _norm(c: GPTConfig, device, dtype):
    if c.use_rms_norm:
        return RMSNorm(c.hidden_size, device=device, dtype=dtype)
    return LayerNorm(c.hidden_size, device=device, dtype=dtype)


class GPTAttention(nn.Module):
    def __init__(self, config: GPTConfig, device=None, dtype=None,
                 group=False):
        super().__init__()
        c = config
        tp = 1 if not group else group.nranks
        # this rank's heads (all of them without a group)
        self.num_heads = c.num_heads // tp
        self.num_kv_heads = c.num_kv_heads // tp
        self.head_dim = c.hidden_size // c.num_heads
        self.dropout = c.dropout
        q_size = c.hidden_size
        kv_size = c.num_kv_heads * self.head_dim
        self.qkv_proj = ColumnParallelLinear(c.hidden_size,
                                             q_size + 2 * kv_size,
                                             has_bias=not c.use_rms_norm,
                                             gather_output=False,
                                             mp_group=group, device=device,
                                             dtype=dtype)
        self.out_proj = RowParallelLinear(c.hidden_size, c.hidden_size,
                                          has_bias=not c.use_rms_norm,
                                          input_is_parallel=True,
                                          mp_group=group, device=device,
                                          dtype=dtype)
        parts = [q_size, kv_size, kv_size]
        mark_fused(self.qkv_proj.weight, parts, group or None)
        if self.qkv_proj.bias is not None:
            mark_fused(self.qkv_proj.bias, parts, group or None)

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
        ``[length, length + S)``. ``rope``: the (cos, sin) tables, or None
        with learned positions."""
        B, S = x.shape[0], x.shape[1]
        H, Hkv, D = self.num_heads, self.num_kv_heads, self.head_dim
        (qkv,) = _amp_cast("split_qkv", self.qkv_proj(x))
        q, k, v = qkv.split([H * D, Hkv * D, Hkv * D], dim=-1)
        q = q.reshape(B, S, H, D)
        k = k.reshape(B, S, Hkv, D)
        v = v.reshape(B, S, Hkv, D)
        if rope is not None:
            q, k = apply_rope(q, *rope, k)
        if step is None:
            out, _ = F.flash_attention(q, k, v, dropout=self.dropout,
                                       causal=True, training=self.training)
        else:
            kernel = kernel_serves(decode_kernel, q)
            out = attend_cached(
                q, k, v, k_pool, v_pool, step,
                paged_decode_attention if kernel
                else paged_decode_attention_ref,
                decode_attention if kernel else decode_attention_ref)
        return self.out_proj(out.reshape(B, S, H * D))


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig, device=None, dtype=None,
                 group=False):
        super().__init__()
        c = config
        self.use_swiglu = c.use_swiglu
        inner = c.intermediate_size
        kw = dict(mp_group=group, device=device, dtype=dtype)
        if c.use_swiglu:
            # local columns [gate_r | up_r] (bridge.shard_state)
            self.gate_up = ColumnParallelLinear(c.hidden_size, 2 * inner,
                                                has_bias=False,
                                                gather_output=False, **kw)
            mark_fused(self.gate_up.weight, [inner, inner], group or None)
        else:
            self.fc1 = ColumnParallelLinear(c.hidden_size, inner,
                                            has_bias=True,
                                            gather_output=False, **kw)
        self.down = RowParallelLinear(inner, c.hidden_size,
                                      has_bias=not c.use_swiglu,
                                      input_is_parallel=True, **kw)

    def forward(self, x):
        if self.use_swiglu:
            return self.down(swiglu(self.gate_up(x)))
        return self.down(F.gelu(self.fc1(x)))


class GPTBlock(nn.Module):
    def __init__(self, config: GPTConfig, device=None, dtype=None,
                 group=False):
        super().__init__()
        c = config
        self.ln1 = _norm(c, device, dtype)
        self.attn = GPTAttention(c, device=device, dtype=dtype, group=group)
        self.ln2 = _norm(c, device, dtype)
        self.mlp = GPTMLP(c, device=device, dtype=dtype, group=group)
        self.dropout = Dropout(c.dropout)

    def forward(self, x, rope, k_pool=None, v_pool=None, step=None,
                decode_kernel="kernel"):
        if step is None:
            x = _amp_add(x, self.dropout(self.attn(self.ln1(x), rope)))
            return _amp_add(x, self.dropout(self.mlp(self.ln2(x))))
        x = _amp_add(x, self.attn(self.ln1(x), rope, k_pool, v_pool, step,
                                  decode_kernel))
        return _amp_add(x, self.mlp(self.ln2(x)))


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig, device=None, dtype=None,
                 group=False):
        super().__init__()
        c = config
        self.config = c
        self.group = group or None
        self.embed_tokens = VocabParallelEmbedding(c.vocab_size,
                                                   c.hidden_size,
                                                   mp_group=group,
                                                   device=device, dtype=dtype)
        if not c.use_rope:
            self.embed_positions = Embedding(c.max_position, c.hidden_size,
                                             device=device, dtype=dtype)
        self.blocks = nn.ModuleList([GPTBlock(c, device=device, dtype=dtype,
                                              group=group)
                                     for _ in range(c.num_layers)])
        self.ln_f = _norm(c, device, dtype)
        if not c.tie_embeddings:
            self.lm_head = ColumnParallelLinear(c.hidden_size, c.vocab_size,
                                                has_bias=False,
                                                gather_output=False,
                                                mp_group=group, device=device,
                                                dtype=dtype)

    def forward(self, input_ids, k_pools=None, v_pools=None, step=None,
                decode_kernel="kernel", position_ids=None):
        """input_ids [B, S] -> logits [B, S, V]. Without ``step``: the
        cache-free causal forward at ``position_ids`` ([S] or [B, S],
        default ``arange(S)``), each block under ``recompute`` in training
        when the config sets it. With a ``PagedStep`` or ``DenseStep``:
        attends through (and writes into) the per-layer paged pools or
        dense caches ``k_pools[i]`` / ``v_pools[i]``, at the step's
        positions."""
        c = self.config
        x = self.embed_tokens(input_ids)
        B, S = input_ids.shape
        if step is None:
            if not c.use_rope and position_ids is None and S > c.max_position:
                raise ValueError(f"sequence length {S} exceeds max_position "
                                 f"{c.max_position}")
            pos = (torch.arange(S, device=x.device) if position_ids is None
                   else torch.as_tensor(position_ids, device=x.device))
            pos = pos.expand(B, S)
        else:
            if decode_kernel not in DECODE_KERNELS:
                raise ValueError(
                    f"decode_kernel must be one of {DECODE_KERNELS}")
            pos = step_positions(step, B, S, x.device)
        rope = None
        if c.use_rope:
            rope = rope_cos_sin(pos, c.hidden_size // c.num_heads, x.dtype)
        else:
            x = _amp_add(x, self.embed_positions(
                pos.clamp(0, c.max_position - 1)))
        if step is None:
            remat = c.recompute if self.training else None
            for blk in self.blocks:
                x = (recompute(blk, x, rope, policy=remat) if remat
                     else blk(x, rope))
        else:
            for blk, kp, vp in zip(self.blocks, k_pools, v_pools):
                x = blk(x, rope, kp, vp, step, decode_kernel)
        x = self.ln_f(x)
        if not c.tie_embeddings:
            return self.lm_head(x)
        if self.group is not None:
            # every rank's vocab columns read the same x: sum its gradient
            x = identity_allreduce(x, self.group)
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

    def __init__(self, config: GPTConfig, device="cuda", dtype=None, seed=0,
                 mp_group=None):
        super().__init__()
        group = resolve_mp_group(mp_group)
        _check_supported(config, group)
        dev = resolve_device(device)
        dtype = dtype if dtype is not None else getattr(torch, config.dtype)
        self.config = config
        self.tp_group = group
        self.gpt = GPTModel(config, device=dev, dtype=dtype,
                            group=group or False)
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
        per_token = ParallelCrossEntropy(mp_group=self.tp_group or False)(
            logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))
        return logits, _amp_cast("mean", per_token)[0].mean()

    def gather_logits(self, logits):
        """The whole vocab of logits from this rank's columns (a gather
        over the model-parallel group, differentiable); the logits as
        they are without one."""
        if self.tp_group is None:
            return logits
        return gather_last(logits, self.tp_group)

    # --------------------------------------- GenerationMixin hooks
    def _decode_layer(self):
        return self.gpt

    def _decode_cache_spec(self):
        c = self.config
        return c.num_layers, c.num_kv_heads, c.hidden_size // c.num_heads

    def _decode_validate(self, prompt_len, max_new_tokens):
        """Learned positions end at ``max_position``: refuse a request that
        would pass it (JAX ``gpt.py:330-337``); RoPE extrapolates."""
        c = self.config
        if not c.use_rope and prompt_len + max_new_tokens > c.max_position:
            raise ValueError(
                f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds max_position ({c.max_position})")


# ---------------------------------------------------------- pipeline form
def _seeded(module, seed, device):
    """Draw ``module``'s parameters from a generator seeded with ``seed``
    (each pipeline layer its own: the weights do not depend on the cut)."""
    gen = make_generator(seed, device)
    with torch.no_grad():
        for mod in module.modules():
            if hasattr(mod, "reset_parameters") and mod is not module:
                mod.reset_parameters(gen)
    return module


class GPTEmbeddingPipe(nn.Module):
    """Token (and, without RoPE, learned position) embedding: the first
    pipeline layer (JAX ``gpt.py:353-370``)."""

    def __init__(self, config: GPTConfig, device=None, dtype=None, seed=0,
                 group=None):
        super().__init__()
        c = config
        group = resolve_mp_group(group)
        dev = resolve_device(device or "cuda")
        dtype = dtype if dtype is not None else getattr(torch, c.dtype)
        self.config = c
        self.group = group
        self.embed_tokens = VocabParallelEmbedding(
            c.vocab_size, c.hidden_size, mp_group=group or False,
            device=dev, dtype=dtype)
        if not c.use_rope:
            self.embed_positions = Embedding(c.max_position, c.hidden_size,
                                             device=dev, dtype=dtype)
        _seeded(self, seed, dev)

    def forward(self, input_ids):
        c = self.config
        x = self.embed_tokens(input_ids)
        if not c.use_rope:
            S = input_ids.shape[1]
            if S > c.max_position:
                raise ValueError(f"sequence length {S} exceeds max_position "
                                 f"{c.max_position}")
            x = _amp_add(x, self.embed_positions(
                torch.arange(S, device=x.device)))
        return x


class GPTBlockPipe(GPTBlock):
    """A ``GPTBlock`` that makes its RoPE tables from the sequence length
    (positions ``arange(S)``, JAX ``GPTAttention`` without
    ``position_ids``), so it takes the boundary activation alone."""

    def __init__(self, config: GPTConfig, device=None, dtype=None, seed=0,
                 group=None):
        group = resolve_mp_group(group)
        dev = resolve_device(device or "cuda")
        dtype = dtype if dtype is not None else getattr(torch, config.dtype)
        _check_supported(config, group)
        super().__init__(config, device=dev, dtype=dtype,
                         group=group or False)
        self._head_dim = (config.hidden_size // config.num_heads
                          if config.use_rope else None)
        _seeded(self, seed, dev)

    def forward(self, x):
        rope = None
        if self._head_dim is not None:
            B, S = x.shape[0], x.shape[1]
            pos = torch.arange(S, device=x.device).expand(B, S)
            rope = rope_cos_sin(pos, self._head_dim, x.dtype)
        return super().forward(x, rope)


class GPTNormPipe(nn.Module):
    def __init__(self, config: GPTConfig, device=None, dtype=None, seed=0,
                 group=None):
        super().__init__()
        dev = resolve_device(device or "cuda")
        dtype = dtype if dtype is not None else getattr(torch, config.dtype)
        self.ln_f = _norm(config, dev, dtype)

    def forward(self, x):
        return self.ln_f(x)


class GPTHeadPipe(nn.Module):
    """The untied head; its logits are gathered over the vocab (JAX's
    ``ColumnParallelLinear`` default ``gather_output``)."""

    def __init__(self, config: GPTConfig, device=None, dtype=None, seed=0,
                 group=None):
        super().__init__()
        group = resolve_mp_group(group)
        dev = resolve_device(device or "cuda")
        dtype = dtype if dtype is not None else getattr(torch, config.dtype)
        self.lm_head = ColumnParallelLinear(
            config.hidden_size, config.vocab_size, has_bias=False,
            gather_output=True, mp_group=group or False, device=dev,
            dtype=dtype)
        _seeded(self, seed, dev)

    def forward(self, x):
        return self.lm_head(x)


def _tied_lm_head(embed_layer: GPTEmbeddingPipe, x):
    """The tied head on the last stage: x @ embed_tokens.weight.T, the
    vocab columns of a model-parallel group gathered."""
    g = embed_layer.group
    if g is not None:
        x = identity_allreduce(x, g)
    h, w = _amp_cast("lm_head_tied", x, embed_layer.embed_tokens.weight)
    logits = h @ w.T
    return gather_last(logits, g) if g is not None else logits


def gpt_causal_lm_loss(logits, labels):
    """The mean token cross entropy over the whole vocab (the loss of
    ``GPTForCausalLM``)."""
    per_token = ParallelCrossEntropy(mp_group=False)(
        logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))
    return _amp_cast("mean", per_token)[0].mean()


def gpt_pipeline(config: GPTConfig, num_stages: int, loss_fn=None,
                 device=None, dtype=None, seed=0, **pp_kwargs):
    """``GPTForCausalLM`` as a ``PipelineLayer`` (BASELINE config 4, JAX
    ``gpt.py:402-428``): the tied embedding a ``SharedLayerDesc`` across
    the first and last stage, each ``GPTBlock`` one ``LayerDesc``. Inside
    a stage the blocks are tensor parallel over the hybrid group's mp
    axis. Layer i draws its weights from ``seed + i``."""
    from ..distributed.fleet.pipeline import (
        LayerDesc,
        PipelineLayer,
        SharedLayerDesc,
    )

    c = config
    kw = dict(device=device, dtype=dtype)
    n = c.num_layers
    blocks = [LayerDesc(GPTBlockPipe, c, seed=seed + 1 + i, **kw)
              for i in range(n)]
    if c.tie_embeddings:
        descs = ([SharedLayerDesc("gpt_embed", GPTEmbeddingPipe, None,
                                  "embed_tokens.weight", c, seed=seed, **kw)]
                 + blocks
                 + [LayerDesc(GPTNormPipe, c, seed=seed + n + 1, **kw),
                    SharedLayerDesc("gpt_embed", GPTEmbeddingPipe,
                                    _tied_lm_head, "embed_tokens.weight", c,
                                    seed=seed, **kw)])
    else:
        descs = ([LayerDesc(GPTEmbeddingPipe, c, seed=seed, **kw)] + blocks
                 + [LayerDesc(GPTNormPipe, c, seed=seed + n + 1, **kw),
                    LayerDesc(GPTHeadPipe, c, seed=seed + n + 2, **kw)])
    return PipelineLayer(descs, num_stages=num_stages,
                         loss_fn=loss_fn or gpt_causal_lm_loss, **pp_kwargs)
