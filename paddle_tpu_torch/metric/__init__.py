"""Metrics — the counterpart of ``paddle_tpu/metric/__init__.py``.
Reference: python/paddle/metric/metrics.py (Accuracy / Precision / Recall /
Auc).

``compute`` runs on the predictions' device (``Accuracy.compute``: the
top-k hit table, a torch ``topk`` there) and returns a Tensor; ``update``
reads its input to the host and accumulates there in Python numbers, as
in JAX. Ties in ``topk`` break by index (JAX's ``argsort`` of the negated
scores does the same for distinct scores).
"""
from __future__ import annotations

import numpy as np
import torch

from ..tensor import Tensor

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _torch(x):
    """A Tensor, torch tensor or array as a torch tensor."""
    if isinstance(x, Tensor):
        return x._value
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def _host(x):
    """A Tensor, torch tensor or array as a numpy array."""
    return _torch(x).detach().cpu().numpy()


class Metric:
    def __init__(self):
        pass

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None, *args, **kwargs):
        super().__init__()
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        """[..., maxk] f32: 1 where the k-th best score is the label."""
        p, lab = _torch(pred), _torch(label).to(_torch(pred).device)
        if lab.dim() == p.dim() and lab.shape[-1] == 1:
            lab = lab[..., 0]
        top = torch.topk(p, self.maxk, dim=-1, sorted=True).indices
        return Tensor((top == lab[..., None].long()).float())

    def update(self, correct, *args):
        c = _host(correct)
        accs = []
        num = c.shape[0] if c.ndim else 1
        for i, k in enumerate(self.topk):
            corr_k = c[..., :k].sum(-1).sum()
            self.total[i] += corr_k
            self.count[i] += num
            accs.append(float(corr_k) / max(num, 1))
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) > 1:
            return [f"{self._name}_top{k}" for k in self.topk]
        return [self._name]


class Precision(Metric):
    def __init__(self, name="precision", *args, **kwargs):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = _host(preds).round()
        lab = _host(labels)
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fp += int(((p == 1) & (lab == 0)).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall", *args, **kwargs):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = _host(preds).round()
        lab = _host(labels)
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fn += int(((p == 0) & (lab == 1)).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name="auc", *args,
                 **kwargs):
        super().__init__()
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def update(self, preds, labels):
        p = _host(preds)
        lab = _host(labels).reshape(-1)
        p = p[:, 1] if p.ndim == 2 else p.reshape(-1)
        bins = np.clip((p * self.num_thresholds).astype(int), 0,
                       self.num_thresholds)
        pos = lab.astype(bool)
        self._stat_pos += np.bincount(bins[pos],
                                      minlength=self.num_thresholds + 1)
        self._stat_neg += np.bincount(bins[~pos],
                                      minlength=self.num_thresholds + 1)

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if not tot_pos or not tot_neg:
            return 0.0
        area = 0.0
        pos = neg = 0.0
        for i in range(self.num_thresholds, -1, -1):
            new_pos = pos + self._stat_pos[i]
            new_neg = neg + self._stat_neg[i]
            area += (new_neg - neg) * (pos + new_pos) / 2
            pos, neg = new_pos, new_neg
        return area / (tot_pos * tot_neg)

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """Top-k accuracy of a batch as a 0-d f32 Tensor on the input's
    device."""
    p = _torch(input)
    lab = _torch(label).to(p.device).reshape(-1).long()
    top = torch.topk(p, k, dim=-1).indices
    return Tensor((top == lab[:, None]).any(-1).float().mean())
