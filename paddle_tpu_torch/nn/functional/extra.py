"""Functional fill-ins — the counterpart of
``paddle_tpu/nn/functional/extra.py``: the in-place activations, distance,
the LP, fractional max and max-unpool pools, the loss variants
(multi-margin, N-pair, hierarchical sigmoid, adaptive log-softmax,
combined-margin cross entropy, RNN-T), the packed attention forms,
``sparse_attention`` (dense scores under the CSR mask; no kernel stands
behind it in JAX either), ``gather_tree``, ``class_center_sample`` and
``feature_alpha_dropout``.

Each function is JAX's formula in torch through ``ops.apply_like`` under
JAX's op name, so AMP casts it as JAX does and it returns the kind it is
given. Where JAX computes on the host (``class_center_sample``, the
fractional pools' region bounds, ``hsigmoid_loss``'s default tree), the
port runs the same numpy. ``fractional_max_pool2d`` / ``3d`` take
``random_u = 0.5`` when none is given, as JAX's do (the reference draws
it: ROADMAP C). ``feature_alpha_dropout`` draws its channel mask from the
port's default generator (``keep_mask``), so it matches JAX in law, not in
values. (The JAX package's packed attention forms import the name
``flash_attention`` from their package, where it is the function and not
the module, and raise AttributeError; the port's compute what they mean.)
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...ops import apply_like
from .activation import _inplace, hardtanh, leaky_relu, tanh, thresholded_relu
from .common import keep_mask
from .flash_attention import flash_attention, flash_attn_unpadded

__all__ = [
    "adaptive_log_softmax_with_loss", "class_center_sample",
    "feature_alpha_dropout", "flash_attn_qkvpacked",
    "flash_attn_varlen_qkvpacked", "fractional_max_pool2d",
    "fractional_max_pool3d", "gather_tree", "hardtanh_", "hsigmoid_loss",
    "leaky_relu_", "lp_pool1d", "lp_pool2d", "margin_cross_entropy",
    "max_unpool1d", "max_unpool2d", "max_unpool3d", "multi_margin_loss",
    "npair_loss", "pairwise_distance", "rnnt_loss", "sparse_attention",
    "tanh_", "thresholded_relu_",
]


def _v(x):
    return x._value if hasattr(x, "_value") else x


# ------------------------------------------------------------ in-place acts
def hardtanh_(x, min=-1.0, max=1.0, name=None):
    return _inplace(x, hardtanh(x, min, max))


def leaky_relu_(x, negative_slope=0.01, name=None):
    return _inplace(x, leaky_relu(x, negative_slope))


def tanh_(x, name=None):
    return _inplace(x, tanh(x))


def thresholded_relu_(x, threshold=1.0, value=0.0, name=None):
    return _inplace(x, thresholded_relu(x, threshold, value))


# ---------------------------------------------------------------- distance
def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    """The p-norm of (x - y + epsilon) over the last axis."""
    return apply_like(
        lambda a, b: torch.linalg.vector_norm(a - b + epsilon, ord=p, dim=-1,
                                              keepdim=keepdim),
        "pairwise_distance", x, y)


# ----------------------------------------------------------------- pooling
def _lp_pool(x, norm_type, kernel_size, stride, padding, ceil_mode, pool,
             n):
    p = float(norm_type)
    xp = apply_like(lambda v: v.abs() ** p, "lp_pow", x)
    pooled = pool(xp, kernel_size, stride, padding, ceil_mode=ceil_mode)
    k = (kernel_size ** n if isinstance(kernel_size, int)
         else int(np.prod(kernel_size)))
    return apply_like(lambda v: (v * k) ** (1.0 / p), "lp_root", pooled)


def lp_pool1d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCL", name=None):
    """(sum over each window of |x|^p)^(1/p), as k · the average pool of
    |x|^p (JAX :68-81)."""
    from .pooling import avg_pool1d

    return _lp_pool(x, norm_type, kernel_size, stride, padding, ceil_mode,
                    avg_pool1d, 1)


def lp_pool2d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCHW", name=None):
    from .pooling import avg_pool2d

    return _lp_pool(x, norm_type, kernel_size, stride, padding, ceil_mode,
                    avg_pool2d, 2)


def _fractional_bounds(in_size, out_size, u):
    """Region boundaries for a sample u in [0, 1) (JAX :98-107)."""
    alpha = in_size / out_size
    idx = np.arange(out_size + 1)
    b = np.ceil(alpha * (idx + u)) - np.ceil(alpha * u)
    b = np.clip(b.astype(np.int64), 0, in_size)
    b[-1] = in_size
    return b


def _fractional_pool(x, out_sizes, spatial_axes, random_u):
    shape = _v(x).shape
    bounds = [_fractional_bounds(shape[ax], o, random_u)
              for ax, o in zip(spatial_axes, out_sizes)]

    def f(v):
        out = v
        for ax, bnd in zip(spatial_axes, bounds):
            moved = out.movedim(ax, 0)
            pieces = [moved[bnd[i]:max(bnd[i + 1], bnd[i] + 1)].amax(0)
                      for i in range(len(bnd) - 1)]
            out = torch.stack(pieces, 0).movedim(0, ax)
        return out

    return apply_like(f, "fractional_max_pool", x)


def fractional_max_pool2d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None):
    """NCHW; ``random_u`` 0.5 when None, as JAX's. With ``return_mask``,
    (out, None), as JAX's."""
    os = ((output_size, output_size) if isinstance(output_size, int)
          else tuple(output_size))
    u = 0.5 if random_u is None else float(random_u)
    out = _fractional_pool(x, os, (2, 3), u)
    return (out, None) if return_mask else out


def fractional_max_pool3d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None):
    os = ((output_size,) * 3 if isinstance(output_size, int)
          else tuple(output_size))
    u = 0.5 if random_u is None else float(random_u)
    out = _fractional_pool(x, os, (2, 3, 4), u)
    return (out, None) if return_mask else out


def _max_unpool(x, indices, n, kernel_size, stride, padding, output_size):
    """Values scattered to the flat per-plane positions ``indices`` that a
    max pool with ``return_mask`` recorded (JAX :142-169; ``padding`` is
    not read, as in JAX)."""
    ks = (kernel_size,) * n if isinstance(kernel_size, int) \
        else tuple(kernel_size)
    st = ks if stride is None else (
        (stride,) * n if isinstance(stride, int) else tuple(stride))
    in_sp = _v(x).shape[2:]
    out_sp = (tuple((s - 1) * st[i] + ks[i] for i, s in enumerate(in_sp))
              if output_size is None else tuple(output_size[-n:]))

    def f(v, idx):
        B, C = v.shape[:2]
        flat = torch.zeros((B, C, int(np.prod(out_sp))), dtype=v.dtype,
                           device=v.device)
        flat = flat.scatter(2, idx.reshape(B, C, -1).long(),
                            v.reshape(B, C, -1))
        return flat.reshape((B, C) + out_sp)

    return apply_like(f, "max_unpool", x, indices)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    return _max_unpool(x, indices, 1, kernel_size, stride, padding,
                       output_size)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    return _max_unpool(x, indices, 2, kernel_size, stride, padding,
                       output_size)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    return _max_unpool(x, indices, 3, kernel_size, stride, padding,
                       output_size)


# ------------------------------------------------------------------ losses
def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    return loss.sum() if reduction == "sum" else loss


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean", name=None):
    """sum over j != y of max(0, margin - x_y + x_j)^p (times weight[y]),
    over C."""
    def f(x, y, w):
        c = x.shape[1]
        y = y.long()
        tgt = x.gather(1, y[:, None])
        m = torch.clamp(margin - tgt + x, min=0.0) ** p
        if w is not None:
            m = m * w[y][:, None]
        mask = torch.nn.functional.one_hot(y, c).to(x.dtype)
        return _reduce((m * (1 - mask)).sum(1) / c, reduction)

    return apply_like(f, "multi_margin_loss", input, label, weight)


def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    """Cross entropy of the anchor-positive similarities against the
    same-label targets, plus l2_reg / 4 of the mean squared norms."""
    def f(a, p, y):
        reg = l2_reg * (a.square().sum(1).mean()
                        + p.square().sum(1).mean()) * 0.25
        sim = a @ p.T
        eq = (y[:, None] == y[None, :]).to(sim.dtype)
        tgt = eq / eq.sum(1, keepdim=True).clamp(min=1.0)
        ce = -(tgt * torch.log_softmax(sim, 1)).sum(1).mean()
        return ce + reg

    return apply_like(f, "npair_loss", anchor, positive, labels)


def _default_paths(num_classes, depth):
    """The complete binary tree in heap layout (JAX :253-265): class c is
    leaf c + C; its ancestors are the successive halvings (internal node
    n at row n - 1); the code bit is the child's parity."""
    table = np.zeros((num_classes, depth), np.int64)
    code = np.zeros((num_classes, depth), np.float32)
    for c in range(num_classes):
        node = c + num_classes
        for d in range(depth):
            code[c, d] = float(node % 2)
            node //= 2
            table[c, d] = node - 1
    return table, code


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Sum over the label's path of softplus(-(1 - 2·code)·logit), [N, 1]."""
    depth = int(math.ceil(math.log2(max(num_classes, 2))))
    dev = _v(input).device
    if path_table is None:
        tbl, code = (torch.from_numpy(a).to(dev)
                     for a in _default_paths(num_classes, depth))
    else:
        tbl, code = _v(path_table).long(), _v(path_code).float()

    def f(x, y, w, b):
        y = y.reshape(-1).long()
        t, cde = tbl[y], code[y]
        logits = torch.einsum("nd,nkd->nk", x, w[t])
        if b is not None:
            logits = logits + b.reshape(-1)[t]
        sgn = 1.0 - 2.0 * cde
        return torch.nn.functional.softplus(-sgn * logits).sum(
            1, keepdim=True)

    return apply_like(f, "hsigmoid_loss", input, label, weight, bias)


def adaptive_log_softmax_with_loss(input, label, head_weight, tail_weights,
                                   cutoffs, head_bias=None, name=None):
    """(per-row log-probability of the label, -its mean). ``cutoffs`` ends
    with the class count; ``tail_weights`` pairs (w1 [D, h], w2 [h, size])
    per cluster."""
    n_clusters = len(cutoffs) - 1

    def f(x, y, hw, hb, *tails):
        y = y.reshape(-1).long()
        head_logits = x @ hw
        if hb is not None:
            head_logits = head_logits + hb
        head_logp = torch.log_softmax(head_logits, -1)
        out = torch.zeros(y.shape, dtype=x.dtype, device=x.device)
        head_part = head_logp.gather(
            1, y.clamp(0, cutoffs[0] - 1)[:, None])[:, 0]
        out = torch.where(y < cutoffs[0], head_part, out)
        for i in range(n_clusters):
            lo, hi = cutoffs[i], cutoffs[i + 1]
            tail_logp = torch.log_softmax((x @ tails[2 * i])
                                          @ tails[2 * i + 1], -1)
            rel = (y - lo).clamp(0, hi - lo - 1)
            part = (head_logp[:, cutoffs[0] + i]
                    + tail_logp.gather(1, rel[:, None])[:, 0])
            out = torch.where((y >= lo) & (y < hi), part, out)
        return out, -out.mean()

    tails = [w for pair in tail_weights for w in pair]
    return apply_like(f, "adaptive_log_softmax_with_loss", input, label,
                      head_weight, head_bias, *tails)


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean"):
    """Cross entropy over scale · the cosines with the target's replaced by
    cos(m1·θ + m2) - m3, in f32 (the ArcFace family)."""
    def f(lg, y):
        y = y.reshape(-1).long()
        lg32 = lg.float().clamp(-1.0, 1.0)
        theta = torch.arccos(lg32.gather(1, y[:, None])[:, 0])
        tgt = torch.cos(margin1 * theta + margin2) - margin3
        onehot = torch.nn.functional.one_hot(y, lg.shape[-1]).to(lg32.dtype)
        adjusted = (lg32 * (1 - onehot) + tgt[:, None] * onehot) * scale
        logp = torch.log_softmax(adjusted, -1)
        loss = _reduce(-logp.gather(1, y[:, None]), reduction)
        return (loss, logp.exp()) if return_softmax else loss

    return apply_like(f, "margin_cross_entropy", logits, label)


def rnnt_loss(logits, labels, logit_lengths, label_lengths, blank=0,
              fastemit_lambda=0.001, reduction="mean", name=None):
    """RNN-Transducer loss, f32: the forward variables over the (T, U+1)
    lattice row by row, columns past each label length masked (JAX
    :353-413, its scans as loops). logits [B, T, U+1, V].
    ``fastemit_lambda`` is not read, as in JAX."""
    def f(lg, lab, tlen, ulen):
        logp = torch.log_softmax(lg.float(), -1)
        B, T, U1, _ = logp.shape
        U = U1 - 1
        blank_lp = logp[..., blank]                            # [B, T, U+1]
        emit_lp = logp[:, :, :U, :].gather(
            3, lab.long()[:, None, :, None].expand(B, T, U, 1))[..., 0]
        neg = torch.full((), -1e30, dtype=torch.float32, device=lg.device)
        live = torch.arange(U1, device=lg.device)[None, :] <= ulen[:, None]
        cols = [torch.zeros((B,), dtype=torch.float32, device=lg.device)]
        for u in range(U):
            cols.append(cols[-1] + emit_lp[:, 0, u])
        rows = [torch.where(live, torch.stack(cols, 1), neg)]
        for t in range(1, T):
            top = rows[-1] + blank_lp[:, t - 1, :]
            cols = [top[:, 0]]
            for u in range(U):
                cols.append(torch.logaddexp(top[:, u + 1],
                                            cols[-1] + emit_lp[:, t, u]))
            rows.append(torch.where(live, torch.stack(cols, 1), neg))
        alpha = torch.stack(rows, 0)                           # [T, B, U+1]
        t_idx = (tlen.long() - 1).clamp(0, T - 1)
        bi = torch.arange(B, device=lg.device)
        u_idx = ulen.long()
        nll = -(alpha[t_idx, bi, u_idx] + blank_lp[bi, t_idx, u_idx])
        return _reduce(nll, reduction)

    return apply_like(f, "rnnt_loss", logits, labels, logit_lengths,
                      label_lengths)


# --------------------------------------------------------------- attention
def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False, return_softmax=False,
                         training=True, name=None):
    """qkv: [B, S, 3, H, D] packed; ``flash_attention`` on its three
    parts. Returns ``(out, None)``."""
    return flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                           dropout=dropout, causal=causal,
                           return_softmax=return_softmax, training=training)


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
                                max_seqlen_k, scale=None, dropout=0.0,
                                causal=False, return_softmax=False,
                                training=True, name=None):
    """qkv: [total, 3, H, D] packed documents; ``flash_attn_unpadded`` on
    its three parts, scale 1/sqrt(D) by default. Returns ``(out, None)``."""
    if scale is None:
        scale = 1.0 / math.sqrt(qkv.shape[-1])
    return flash_attn_unpadded(qkv[:, 0], qkv[:, 1], qkv[:, 2], cu_seqlens_q,
                               cu_seqlens_k, max_seqlen_q, max_seqlen_k,
                               scale, dropout=dropout, causal=causal,
                               training=training)


def sparse_attention(query, key, value, sparse_csr_offset, sparse_csr_columns,
                     key_padding_mask=None, attn_mask=None, name=None):
    """Attention over [B, H, S, D] where query row s of head (b, h) sees
    the key columns ``cols[b, h, offs[b, h, s]:offs[b, h, s + 1]]``: dense
    scores, -1e30 elsewhere, softmax, probabilities in v's dtype (JAX
    :448-481). The CSR mask is built on the device without a host read.
    ``key_padding_mask`` / ``attn_mask`` are not read, as in JAX."""
    def f(q, k, v, offs, cols):
        S, D = q.shape[2], q.shape[3]
        scores = torch.einsum("bhsd,bhtd->bhst", q, k) / math.sqrt(D)
        i = torch.arange(cols.shape[-1], device=q.device)
        sel = ((i >= offs[..., :-1, None])
               & (i < offs[..., 1:, None]))                 # [B, H, S, nnz]
        hit = torch.nn.functional.one_hot(cols.long().clamp(0, S - 1), S)
        mask = (sel.float() @ hit.float()) > 0               # [B, H, S, S]
        scores = scores.to(torch.promote_types(scores.dtype, torch.float32))
        scores = torch.where(mask, scores, torch.full(
            (), -1e30, dtype=scores.dtype, device=q.device))
        probs = torch.softmax(scores, -1)
        return torch.einsum("bhst,bhtd->bhsd", probs.to(v.dtype), v)

    return apply_like(f, "sparse_attention", query, key, value,
                      sparse_csr_offset, sparse_csr_columns)


# --------------------------------------------------------------- utilities
def gather_tree(ids, parents):
    """Full beam-search sequences from the per-step ids and parent beams
    [T, B, W], walking the parents back from the last step."""
    def f(ids, par):
        T, B, W = ids.shape
        beams = torch.arange(W, device=ids.device).expand(B, W)
        toks = []
        for t in range(T - 1, -1, -1):
            toks.append(ids[t].gather(-1, beams))
            beams = par[t].gather(-1, beams)
        return torch.stack(toks[::-1], 0)

    return apply_like(f, "gather_tree", ids, parents)


def class_center_sample(label, num_classes, num_samples, group=None):
    """(label remapped into the sampled centers, the sampled class ids):
    every positive class, plus negatives drawn without replacement from
    ``np.random.default_rng(sum of the positives + num_classes)``, sorted
    (JAX :507-525, host numpy: one read of the labels)."""
    from ...tensor import Tensor

    lab = np.asarray(_v(label).cpu()).astype(np.int64)
    pos = np.unique(lab)
    if len(pos) >= num_samples:
        sampled = pos
    else:
        rest = np.setdiff1d(np.arange(num_classes), pos)
        rng = np.random.default_rng(int(pos.sum()) + num_classes)
        extra = rng.choice(rest, size=num_samples - len(pos), replace=False)
        sampled = np.sort(np.concatenate([pos, extra]))
    remap = -np.ones(num_classes, np.int64)
    remap[sampled] = np.arange(len(sampled))
    dev = _v(label).device
    return (Tensor(torch.from_numpy(remap[lab]).to(dev)),
            Tensor(torch.from_numpy(sampled).to(dev)))


def feature_alpha_dropout(x, p=0.5, training=True, name=None):
    """Alpha dropout over whole channel maps: a channel is kept with
    probability 1 - p, else set to alpha' = -1.7581; then a·x + b restores
    SELU's mean and variance (JAX :528-546)."""
    if not training or p == 0.0:
        return x
    alpha = -1.7580993408473766
    keep = 1.0 - p

    def f(v):
        mask = keep_mask(v.shape[:2] + (1,) * (v.dim() - 2), keep, v.device)
        a = (keep + alpha ** 2 * keep * (1 - keep)) ** -0.5
        b = -a * alpha * (1 - keep)
        return a * torch.where(mask, v, torch.full(
            (), alpha, dtype=v.dtype, device=v.device)) + b

    return apply_like(f, "feature_alpha_dropout", x)
