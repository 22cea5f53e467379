"""Loss functionals — the counterpart of
``paddle_tpu/nn/functional/loss.py``, JAX's formulas in torch, each under
its JAX op name and of the kind it is given (``ops.apply_like``).

Where paddle and torch differ: ``cross_entropy``'s mean with ``weight``
divides by the summed weights of the kept labels (not their count);
``ignore_index`` labels count neither; ``soft_label`` (or a label of the
logits' shape) takes a distribution; ``use_softmax=False`` takes
probabilities.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as tF

from ...ops import apply_like

__all__ = [
    "cross_entropy", "softmax_with_cross_entropy", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "mse_loss", "l1_loss", "nll_loss",
    "kl_div", "smooth_l1_loss", "margin_ranking_loss",
    "hinge_embedding_loss", "cosine_embedding_loss", "triplet_margin_loss",
    "triplet_margin_with_distance_loss", "multi_label_soft_margin_loss",
    "soft_margin_loss", "sigmoid_focal_loss", "square_error_cost",
    "ctc_loss", "poisson_nll_loss", "gaussian_nll_loss", "log_loss",
]


def _reduce(v, reduction):
    if reduction == "mean":
        return v.mean()
    if reduction == "sum":
        return v.sum()
    return v


def _zero(v):
    return torch.zeros((), dtype=v.dtype, device=v.device)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    def f(logits, lbl, w):
        if use_softmax:
            logp = torch.log_softmax(logits, axis)
        else:
            logp = torch.log(torch.clamp(logits, min=1e-30))
        n_classes = logits.shape[axis]
        if soft_label or (lbl.dim() == logits.dim()
                          and lbl.shape == logits.shape):
            soft = lbl
            if label_smoothing > 0:
                soft = soft * (1 - label_smoothing) + label_smoothing / \
                    n_classes
            loss = -torch.sum(soft * logp, dim=axis)
            return _reduce(loss, reduction)
        lbl_i = lbl.long()
        if lbl_i.dim() == logits.dim():
            lbl_i = lbl_i.squeeze(axis)
        mask = lbl_i != ignore_index
        safe = torch.where(mask, lbl_i, torch.zeros_like(lbl_i))
        picked = torch.gather(logp.movedim(axis, -1), -1,
                              safe[..., None])[..., 0]
        if label_smoothing > 0:
            loss = (-(1 - label_smoothing) * picked
                    - label_smoothing * logp.mean(axis))
        else:
            loss = -picked
        wt = None if w is None else w[safe]
        if wt is not None:
            loss = loss * wt
        loss = torch.where(mask, loss, _zero(loss))
        if reduction == "mean":
            if wt is not None:
                denom = torch.where(mask, wt, _zero(wt)).sum()
            else:
                denom = torch.clamp(mask.to(loss.dtype).sum(), min=1.0)
            return loss.sum() / denom
        return _reduce(loss, reduction)

    return apply_like(f, "cross_entropy", input, label, weight)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """The unreduced cross entropy with the class axis kept (size 1)."""
    from .activation import softmax

    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    loss = apply_like(lambda v: v.unsqueeze(axis), "unsqueeze", loss)
    if return_softmax:
        return loss, softmax(logits, axis=axis)
    return loss


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    def f(p, y, w):
        loss = -(y * torch.log(torch.clamp(p, min=1e-12))
                 + (1 - y) * torch.log(torch.clamp(1 - p, min=1e-12)))
        if w is not None:
            loss = loss * w
        return _reduce(loss, reduction)

    return apply_like(f, "binary_cross_entropy", input, label, weight)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    def f(z, y, w, pw):
        if pw is not None:
            base = -(pw * y * tF.logsigmoid(z) + (1 - y) * tF.logsigmoid(-z))
        else:
            base = (torch.clamp(z, min=0) - z * y
                    + torch.log1p(torch.exp(-z.abs())))
        if w is not None:
            base = base * w
        return _reduce(base, reduction)

    return apply_like(f, "bce_with_logits", logit, label, weight, pos_weight)


def mse_loss(input, label, reduction="mean", name=None):
    return apply_like(lambda a, b: _reduce(torch.square(a - b), reduction),
                      "mse_loss", input, label)


def l1_loss(input, label, reduction="mean", name=None):
    return apply_like(lambda a, b: _reduce((a - b).abs(), reduction),
                      "l1_loss", input, label)


def square_error_cost(input, label):
    return apply_like(lambda a, b: torch.square(a - b), "square_error_cost",
                      input, label)


def log_loss(input, label, epsilon=1e-4, name=None):
    return apply_like(
        lambda p, y: (-y * torch.log(p + epsilon)
                      - (1 - y) * torch.log(1 - p + epsilon)),
        "log_loss", input, label)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """-logp[label] over [N, C] or [N, C, d...]; the mean with ``weight``
    divides by the summed weights of the kept labels."""
    def f(logp, y, w):
        y = y.long()
        mask = y != ignore_index
        safe = torch.where(mask, y, torch.zeros_like(y))
        lp = logp.movedim(1, -1) if logp.dim() > 2 else logp
        loss = -torch.gather(lp, -1, safe[..., None])[..., 0]
        if w is not None:
            loss = loss * w[safe]
        loss = torch.where(mask, loss, _zero(loss))
        if reduction == "mean":
            denom = ((w[safe] * mask).sum() if w is not None else
                     torch.clamp(mask.to(loss.dtype).sum(), min=1.0))
            return loss.sum() / denom
        return _reduce(loss, reduction)

    return apply_like(f, "nll_loss", input, label, weight)


def kl_div(input, label, reduction="mean", log_target=False, name=None):
    def f(logq, p):
        if log_target:
            loss = torch.exp(p) * (p - logq)
        else:
            loss = p * (torch.log(torch.clamp(p, min=1e-30)) - logq)
        if reduction == "batchmean":
            return loss.sum() / logq.shape[0]
        return _reduce(loss, reduction)

    return apply_like(f, "kl_div", input, label)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    def f(a, b):
        d = (a - b).abs()
        loss = torch.where(d < delta, 0.5 * d * d, delta * (d - 0.5 * delta))
        return _reduce(loss, reduction)

    return apply_like(f, "smooth_l1_loss", input, label)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return apply_like(
        lambda a, b, y: _reduce(torch.clamp(-y * (a - b) + margin, min=0.0),
                                reduction),
        "margin_ranking_loss", input, other, label)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    return apply_like(
        lambda x, y: _reduce(torch.where(
            y == 1, x, torch.clamp(margin - x, min=0.0)), reduction),
        "hinge_embedding_loss", input, label)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    def f(a, b, y):
        cos = (a * b).sum(-1) / torch.clamp(
            torch.linalg.vector_norm(a, dim=-1)
            * torch.linalg.vector_norm(b, dim=-1), min=1e-12)
        loss = torch.where(y == 1, 1 - cos, torch.clamp(cos - margin,
                                                        min=0.0))
        return _reduce(loss, reduction)

    return apply_like(f, "cosine_embedding_loss", input1, input2, label)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    def f(a, pos, neg):
        def dist(u, v):
            return torch.pow(torch.pow((u - v).abs() + epsilon, p).sum(-1),
                             1.0 / p)

        dp, dn = dist(a, pos), dist(a, neg)
        if swap:
            dn = torch.minimum(dn, dist(pos, neg))
        return _reduce(torch.clamp(dp - dn + margin, min=0.0), reduction)

    return apply_like(f, "triplet_margin_loss", input, positive, negative)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    if distance_function is None:
        return triplet_margin_loss(input, positive, negative, margin=margin,
                                   swap=swap, reduction=reduction)
    dp = distance_function(input, positive)
    dn = distance_function(input, negative)
    if swap:
        from ...ops.math import minimum

        dn = minimum(dn, distance_function(positive, negative))
    return apply_like(
        lambda a, b: _reduce(torch.clamp(a - b + margin, min=0.0),
                             reduction), "triplet_reduce", dp, dn)


def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean", name=None):
    def f(x, y, w):
        loss = -(y * tF.logsigmoid(x) + (1 - y) * tF.logsigmoid(-x))
        loss = loss.mean(-1)
        if w is not None:
            loss = loss * w
        return _reduce(loss, reduction)

    return apply_like(f, "multi_label_soft_margin_loss", input, label,
                      weight)


def soft_margin_loss(input, label, reduction="mean", name=None):
    return apply_like(
        lambda x, y: _reduce(torch.log1p(torch.exp(-y * x)), reduction),
        "soft_margin_loss", input, label)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    def f(z, y, nrm):
        p = torch.sigmoid(z)
        ce = torch.clamp(z, min=0) - z * y + torch.log1p(torch.exp(-z.abs()))
        p_t = p * y + (1 - p) * (1 - y)
        a_t = alpha * y + (1 - alpha) * (1 - y)
        loss = a_t * torch.pow(1 - p_t, gamma) * ce
        if nrm is not None:
            loss = loss / nrm
        return _reduce(loss, reduction)

    return apply_like(f, "sigmoid_focal_loss", logit, label, normalizer)


def poisson_nll_loss(input, label, log_input=True, full=False, epsilon=1e-8,
                     reduction="mean", name=None):
    def f(x, y):
        if log_input:
            loss = torch.exp(x) - y * x
        else:
            loss = x - y * torch.log(x + epsilon)
        if full:
            stirling = (y * torch.log(y + epsilon) - y
                        + 0.5 * torch.log(2 * math.pi * (y + epsilon)))
            loss = loss + torch.where(y > 1, stirling, _zero(stirling))
        return _reduce(loss, reduction)

    return apply_like(f, "poisson_nll_loss", input, label)


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean", name=None):
    def f(mu, y, var):
        var = torch.clamp(var, min=epsilon)
        loss = 0.5 * (torch.log(var) + torch.square(y - mu) / var)
        if full:
            loss = loss + 0.5 * math.log(2 * math.pi)
        return _reduce(loss, reduction)

    return apply_like(f, "gaussian_nll_loss", input, label, variance)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC over logits [T, B, C] (normalised here by log_softmax, as
    ``optax.ctc_loss`` does in JAX); ``mean`` averages each sequence's loss
    over its label length."""
    def f(lp, lbl, il, ll):
        per_seq = tF.ctc_loss(torch.log_softmax(lp, -1), lbl.long(),
                              il.long(), ll.long(), blank=blank,
                              reduction="none")
        if reduction == "mean":
            return (per_seq / torch.clamp(ll.to(per_seq.dtype),
                                          min=1.0)).mean()
        return _reduce(per_seq, reduction)

    return apply_like(f, "ctc_loss", log_probs, labels, input_lengths,
                      label_lengths)

