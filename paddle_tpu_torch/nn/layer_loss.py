"""Loss layers — the counterpart of ``paddle_tpu/nn/layer_loss.py``: each
a ``Layer`` over the functional loss of the same name."""
from __future__ import annotations

from . import functional as F
from .layer import Layer

__all__ = ["CrossEntropyLoss", "MSELoss", "L1Loss", "BCELoss",
           "BCEWithLogitsLoss", "NLLLoss", "KLDivLoss", "SmoothL1Loss",
           "MarginRankingLoss", "HingeEmbeddingLoss", "CosineEmbeddingLoss",
           "TripletMarginLoss", "MultiLabelSoftMarginLoss", "SoftMarginLoss",
           "CTCLoss", "PoissonNLLLoss", "GaussianNLLLoss"]


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self._args = dict(weight=weight, ignore_index=ignore_index,
                          reduction=reduction, soft_label=soft_label,
                          axis=axis, use_softmax=use_softmax,
                          label_smoothing=label_smoothing)

    def forward(self, input, label):
        return F.cross_entropy(input, label, **self._args)


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, self.reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.l1_loss(input, label, self.reduction)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight, self.reduction = weight, reduction

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, self.weight,
                                      self.reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__()
        self.weight, self.reduction = weight, reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(
            logit, label, self.weight, self.reduction, self.pos_weight)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__()
        self._args = dict(weight=weight, ignore_index=ignore_index,
                          reduction=reduction)

    def forward(self, input, label):
        return F.nll_loss(input, label, **self._args)


class KLDivLoss(Layer):
    def __init__(self, reduction="mean", log_target=False):
        super().__init__()
        self.reduction, self.log_target = reduction, log_target

    def forward(self, input, label):
        return F.kl_div(input, label, self.reduction, self.log_target)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self.reduction, self.delta = reduction, delta

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, self.reduction, self.delta)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input, other, label):
        return F.margin_ranking_loss(input, other, label, self.margin,
                                     self.reduction)


class HingeEmbeddingLoss(Layer):
    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input, label):
        return F.hinge_embedding_loss(input, label, self.margin,
                                      self.reduction)


class CosineEmbeddingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label, self.margin,
                                       self.reduction)


class TripletMarginLoss(Layer):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self._args = dict(margin=margin, p=p, epsilon=epsilon, swap=swap,
                          reduction=reduction)

    def forward(self, input, positive, negative):
        return F.triplet_margin_loss(input, positive, negative, **self._args)


class MultiLabelSoftMarginLoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight, self.reduction = weight, reduction

    def forward(self, input, label):
        return F.multi_label_soft_margin_loss(input, label, self.weight,
                                              self.reduction)


class SoftMarginLoss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.soft_margin_loss(input, label, self.reduction)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank, self.reduction = blank, reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          self.blank, self.reduction, norm_by_times)


class PoissonNLLLoss(Layer):
    def __init__(self, log_input=True, full=False, epsilon=1e-8,
                 reduction="mean", name=None):
        super().__init__()
        self._args = dict(log_input=log_input, full=full, epsilon=epsilon,
                          reduction=reduction)

    def forward(self, input, label):
        return F.poisson_nll_loss(input, label, **self._args)


class GaussianNLLLoss(Layer):
    def __init__(self, full=False, epsilon=1e-6, reduction="mean", name=None):
        super().__init__()
        self._args = dict(full=full, epsilon=epsilon, reduction=reduction)

    def forward(self, input, label, variance):
        return F.gaussian_nll_loss(input, label, variance, **self._args)
