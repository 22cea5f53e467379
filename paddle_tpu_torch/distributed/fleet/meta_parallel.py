"""Single-device forms of the tensor-parallel layers and of
``ParallelCrossEntropy`` — the counterpart of
``paddle_tpu/distributed/fleet/meta_parallel.py:67-168``.

Weights keep paddle's ``[in, out]`` layout, so ``bridge.py`` copies the JAX
package's arrays without transposing them. The products are plain
``torch.matmul``: the JAX package left them to XLA outside any Pallas
kernel. Sharding over ranks waits for the distributed slice.
"""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy"]


class VocabParallelEmbedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, device=None,
                 dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=device, dtype=dtype))

    def reset_parameters(self, generator=None):
        nn.init.xavier_normal_(self.weight, generator=generator)

    def forward(self, ids):
        return self.weight[ids]


class _Linear(nn.Module):
    def __init__(self, in_features, out_features, has_bias=True, device=None,
                 dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            in_features, out_features, device=device, dtype=dtype))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device,
                                              dtype=dtype))
                     if has_bias else None)

    def reset_parameters(self, generator=None):
        nn.init.xavier_uniform_(self.weight, generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        out = x @ self.weight
        return out + self.bias if self.bias is not None else out


class ParallelCrossEntropy(nn.Module):
    """Softmax cross entropy per token over the vocab axis, in the logits'
    dtype (bf16 under O2): lse = max + log(sum(exp(logits - max))) with the
    max detached, minus the target logit; 0 where the label is
    ``ignore_index`` (JAX :132-168). The JAX package sums a one-hot mask to
    pick the target; a gather of the same entry is the same value (a sum of
    one logit and zeros) without a [tokens, vocab] mask, and labels outside
    the vocab give 0 there too."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, input, label):
        vocab = input.shape[-1]
        squeeze = label.dim() == input.dim() and label.shape[-1] == 1
        lab = label.squeeze(-1) if squeeze else label
        m = input.amax(dim=-1, keepdim=True).detach()
        lse = torch.log(torch.exp(input - m).sum(dim=-1)) + m.squeeze(-1)
        in_vocab = (lab >= 0) & (lab < vocab)
        tgt = input.gather(-1, lab.clamp(0, vocab - 1).unsqueeze(-1))
        tgt = torch.where(in_vocab, tgt.squeeze(-1), torch.zeros_like(lse))
        loss = lse - tgt
        loss = torch.where(lab == self.ignore_index, torch.zeros_like(loss),
                           loss)
        return loss.unsqueeze(-1) if squeeze else loss


class ColumnParallelLinear(_Linear):
    """y = x @ W (+ b), W [in, out]; the out axis is the one a later slice
    shards over ranks."""


class RowParallelLinear(_Linear):
    """y = x @ W (+ b), W [in, out]; the in axis is the one a later slice
    shards over ranks (with a sum across them)."""
