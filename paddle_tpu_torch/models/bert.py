"""BERT masked LM — the counterpart of ``paddle_tpu/models/bert.py``.

Post-norm encoder layers (``ln(x + sublayer(x))``) over learned word,
position and token-type embeddings, the MLM head's transform (dense, GELU,
LayerNorm) and the decoder tied to the word embeddings; the JAX package's
parameter names, so ``bridge.py`` maps them by name.

Attention takes JAX's two routes (``bert.py:91-99``): with an
``attention_mask``, the plain ``scaled_dot_product_attention`` (a bool mask
keeps, a float mask adds); without one, non-causal ``F.flash_attention`` —
the flash kernels on CUDA, and the plain route in training when dropout is
above 0, as in JAX. ``bert_mlm_mask`` is JAX's host-side 80/10/10 recipe on
numpy, giving the same arrays for a seed; ``masked_lm_loss`` the mean NLL
over the masked positions, in f32.

Tensor parallelism follows JAX's layer kinds (``bert.py:78-80``,
``:115-117``, ``:154``): given a model-parallel group of tp ranks
(``mp_group=``, else the hybrid group's mp axis; ``fleet.mp_ops``),
``qkv`` (cut per head group: a rank's columns are its heads' queries,
keys, then values), ``fc1`` and ``transform`` (its output gathered) are
column-parallel, ``out`` and ``fc2`` row-parallel, and the word
embeddings vocabulary-parallel. The tied decoder gives a rank its vocab
columns of the logits (``gather_logits``); the masked-LM loss gathers
them first. tp must divide the heads, the MLP width and the vocab.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..amp import _amp_add, _amp_cast
from ..distributed.fleet.meta_parallel import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    mark_fused,
)
from ..distributed.fleet.mp_ops import (
    gather_last,
    identity_allreduce,
    mp_group as resolve_mp_group,
)
from ..framework import make_generator, resolve_device
from ..nn import Dropout, Embedding, LayerNorm
from ..nn import functional as F

__all__ = ["BertConfig", "BertEmbeddings", "BertSelfAttention", "BertLayer",
           "BertModel", "BertForMaskedLM", "masked_lm_loss", "bert_mlm_mask",
           "bert_base", "bert_tiny"]

IGNORE_INDEX = -100


class BertConfig:
    def __init__(self, vocab_size=30522, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=None, max_position=512,
                 type_vocab_size=2, dropout=0.1, layer_norm_eps=1e-12):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.max_position = max_position
        self.type_vocab_size = type_vocab_size
        self.dropout = dropout
        self.layer_norm_eps = layer_norm_eps


def bert_base():
    """BERT-base (BASELINE config 3): 12 layers, hidden 768, 12 heads of
    64, GELU 3072, 512 positions, vocab 30522, dropout 0.1."""
    return BertConfig()


def bert_tiny():
    return BertConfig(vocab_size=512, hidden_size=64, num_layers=2,
                      num_heads=4, max_position=128, dropout=0.0)


class BertEmbeddings(nn.Module):
    def __init__(self, config: BertConfig, device=None, dtype=None,
                 group=False):
        super().__init__()
        c = config
        kw = dict(device=device, dtype=dtype)
        self.word_embeddings = VocabParallelEmbedding(c.vocab_size,
                                                      c.hidden_size,
                                                      mp_group=group, **kw)
        self.position_embeddings = Embedding(c.max_position, c.hidden_size,
                                             **kw)
        self.token_type_embeddings = Embedding(c.type_vocab_size,
                                               c.hidden_size, **kw)
        self.layer_norm = LayerNorm(c.hidden_size, epsilon=c.layer_norm_eps,
                                    **kw)
        self.dropout = Dropout(c.dropout)

    def forward(self, input_ids, token_type_ids=None):
        S = input_ids.shape[1]
        if S > self.position_embeddings.weight.shape[0]:
            raise ValueError(
                f"sequence length {S} exceeds max_position "
                f"{self.position_embeddings.weight.shape[0]}")
        x = self.word_embeddings(input_ids)
        x = _amp_add(x, self.position_embeddings(
            torch.arange(S, device=x.device)))
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = _amp_add(x, self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(x))


class BertSelfAttention(nn.Module):
    def __init__(self, config: BertConfig, device=None, dtype=None,
                 group=False):
        super().__init__()
        c = config
        tp = 1 if not group else group.nranks
        self.num_heads = c.num_heads // tp
        self.head_dim = c.hidden_size // c.num_heads
        self.qkv = ColumnParallelLinear(c.hidden_size, 3 * c.hidden_size,
                                        gather_output=False, mp_group=group,
                                        device=device, dtype=dtype)
        self.out = RowParallelLinear(c.hidden_size, c.hidden_size,
                                     input_is_parallel=True, mp_group=group,
                                     device=device, dtype=dtype)
        parts = [c.hidden_size] * 3
        mark_fused(self.qkv.weight, parts, group or None)
        mark_fused(self.qkv.bias, parts, group or None)
        self.dropout = c.dropout

    def forward(self, x, attention_mask=None):
        B, S = x.shape[0], x.shape[1]
        H, D = self.num_heads, self.head_dim
        (qkv,) = _amp_cast("split_qkv", self.qkv(x))
        q, k, v = (t.reshape(B, S, H, D) for t in qkv.split(H * D, dim=-1))
        if attention_mask is not None:
            out = F.scaled_dot_product_attention(
                q, k, v, attn_mask=attention_mask, is_causal=False,
                dropout_p=self.dropout if self.training else 0.0)
        else:
            out, _ = F.flash_attention(q, k, v, dropout=self.dropout,
                                       causal=False, training=self.training)
        return self.out(out.reshape(B, S, H * D))


class BertLayer(nn.Module):
    """Post-norm (original BERT): ln(x + sublayer(x))."""

    def __init__(self, config: BertConfig, device=None, dtype=None,
                 group=False):
        super().__init__()
        c = config
        kw = dict(device=device, dtype=dtype)
        self.attention = BertSelfAttention(c, group=group, **kw)
        self.ln1 = LayerNorm(c.hidden_size, epsilon=c.layer_norm_eps, **kw)
        self.fc1 = ColumnParallelLinear(c.hidden_size, c.intermediate_size,
                                        gather_output=False, mp_group=group,
                                        **kw)
        self.fc2 = RowParallelLinear(c.intermediate_size, c.hidden_size,
                                     input_is_parallel=True, mp_group=group,
                                     **kw)
        self.ln2 = LayerNorm(c.hidden_size, epsilon=c.layer_norm_eps, **kw)
        self.dropout = Dropout(c.dropout)

    def forward(self, x, attention_mask=None):
        x = self.ln1(_amp_add(x, self.dropout(self.attention(
            x, attention_mask))))
        return self.ln2(_amp_add(x, self.dropout(self.fc2(F.gelu(
            self.fc1(x))))))


class BertModel(nn.Module):
    def __init__(self, config: BertConfig, device=None, dtype=None,
                 group=False):
        super().__init__()
        self.config = config
        self.embeddings = BertEmbeddings(config, device=device, dtype=dtype,
                                         group=group)
        self.layers = nn.ModuleList([
            BertLayer(config, device=device, dtype=dtype, group=group)
            for _ in range(config.num_layers)])

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        x = self.embeddings(input_ids, token_type_ids)
        for blk in self.layers:
            x = blk(x, attention_mask)
        return x


class BertForMaskedLM(nn.Module):
    """The encoder and the MLM head: transform (dense, GELU, LayerNorm),
    then the decoder tied to the word embeddings. The loss ignores labels
    equal to ``ignore_index`` (-100). Weights are drawn from a seeded
    ``torch.Generator`` on ``device`` (Xavier, as in the JAX package);
    ``device`` defaults to CUDA and raises without it unless the caller
    passes ``device="cpu"``. The model starts in training mode."""

    ignore_index = IGNORE_INDEX

    def __init__(self, config: BertConfig, device="cuda", dtype=None,
                 seed=0, mp_group=None):
        super().__init__()
        c = config
        group = resolve_mp_group(mp_group)
        tp = 1 if group is None else group.nranks
        for what, n in (("num_heads", c.num_heads),
                        ("intermediate_size", c.intermediate_size),
                        ("vocab_size", c.vocab_size),
                        ("hidden_size", c.hidden_size)):
            if n % tp:
                raise ValueError(f"tensor parallelism over {tp} ranks needs "
                                 f"tp to divide {what} ({n})")
        dev = resolve_device(device)
        self.config = c
        self.tp_group = group
        self.bert = BertModel(c, device=dev, dtype=dtype,
                              group=group or False)
        self.transform = ColumnParallelLinear(c.hidden_size, c.hidden_size,
                                              mp_group=group or False,
                                              device=dev, dtype=dtype)
        self.transform_ln = LayerNorm(c.hidden_size,
                                      epsilon=c.layer_norm_eps, device=dev,
                                      dtype=dtype)
        self.reset_parameters(make_generator(seed, dev))

    @property
    def device(self) -> torch.device:
        return self.transform.weight.device

    @torch.no_grad()
    def reset_parameters(self, generator):
        for mod in self.modules():
            if hasattr(mod, "reset_parameters") and mod is not self:
                mod.reset_parameters(generator)

    def forward(self, input_ids, labels=None, token_type_ids=None,
                attention_mask=None):
        """logits [B, S, V] (this rank's vocab columns under tensor
        parallelism), or (logits, loss) with ``labels``."""
        dev = self.device
        input_ids = torch.as_tensor(input_ids, device=dev)
        if token_type_ids is not None:
            token_type_ids = torch.as_tensor(token_type_ids, device=dev)
        if attention_mask is not None:
            attention_mask = torch.as_tensor(attention_mask, device=dev)
        h = self.bert(input_ids, token_type_ids, attention_mask)
        h = self.transform_ln(F.gelu(self.transform(h)))
        if self.tp_group is not None:
            # every rank's vocab columns read the same h: sum its gradient
            h = identity_allreduce(h, self.tp_group)
        h, w = _amp_cast("mlm_decoder", h,
                         self.bert.embeddings.word_embeddings.weight)
        logits = h @ w.T
        if labels is None:
            return logits
        return logits, masked_lm_loss(self.gather_logits(logits),
                                      torch.as_tensor(labels, device=dev))

    def gather_logits(self, logits):
        """The whole vocab of logits from this rank's columns (a gather
        over the model-parallel group); as they are without one."""
        if self.tp_group is None:
            return logits
        return gather_last(logits, self.tp_group)


def masked_lm_loss(logits, labels, ignore_index=IGNORE_INDEX):
    """Mean NLL in f32 over the positions whose label is not
    ``ignore_index``; 0 (not NaN) when nothing is masked (JAX
    ``bert.py:154-171``; the op ``mlm_loss`` under AMP)."""
    (logits,) = _amp_cast("mlm_loss", logits)
    lg = logits.reshape(-1, logits.shape[-1]).float()
    lab = labels.reshape(-1)
    valid = lab != ignore_index
    lp = torch.log_softmax(lg, dim=-1)
    nll = -lp.gather(1, torch.where(valid, lab, 0)[:, None])[:, 0]
    nll = torch.where(valid, nll, torch.zeros((), device=nll.device))
    return nll.sum() / valid.sum().clamp(min=1)


def bert_mlm_mask(input_ids, vocab_size, mask_token_id, seed=0,
                  mlm_prob=0.15, special_ids=()):
    """Host-side BERT masking (JAX ``bert.py:174-192``): select
    ``mlm_prob`` of the tokens that are not ``special_ids``; of those 80%
    become ``mask_token_id``, 10% a random token, 10% stay. Returns numpy
    (masked_ids, labels), labels -100 where unselected. The same draws
    from ``np.random.RandomState(seed)`` in the same order as JAX's, so
    the same arrays for a seed."""
    ids = np.asarray(input_ids.cpu() if isinstance(input_ids, torch.Tensor)
                     else input_ids)
    rs = np.random.RandomState(seed)
    selectable = ~np.isin(ids, list(special_ids))
    sel = (rs.rand(*ids.shape) < mlm_prob) & selectable
    labels = np.where(sel, ids, IGNORE_INDEX)
    out = ids.copy()
    r = rs.rand(*ids.shape)
    out[sel & (r < 0.8)] = mask_token_id
    rand_pos = sel & (r >= 0.8) & (r < 0.9)
    out[rand_pos] = rs.randint(0, vocab_size, rand_pos.sum())
    return out, labels
