"""Layer fill-ins — the counterpart of ``paddle_tpu/nn/layer_extra.py``:
thin layers over the functionals (``ChannelShuffle``, ``PixelUnshuffle``,
``Softmax2D``, ``Unflatten``, ``ZeroPad1D`` / ``3D``, ``Fold``,
``Unfold``, ``FeatureAlphaDropout``, ``PairwiseDistance``,
``ParameterDict``, the LP, max-unpool and fractional max pools), the
losses (``MultiMarginLoss``, ``TripletMarginWithDistanceLoss``,
``HSigmoidLoss``, ``RNNTLoss``, ``AdaptiveLogSoftmaxWithLoss``),
``SpectralNorm``, ``BiRNN``, and the seq2seq decode (``BeamSearchDecoder``,
``dynamic_decode``).

* ``SpectralNorm`` divides the weight by its largest singular value from
  a power iteration that starts at the stored ``weight_u`` / ``weight_v``
  on every call and never writes them back, as JAX's (:397-435; ROADMAP
  C); gradients flow through the iteration.
* ``dynamic_decode`` is JAX's host loop (:486-525): log-softmax in f32,
  the first step keeping one beam (the others at -1e9), finished beams
  emitting only ``end_token``, the top K of the flat ``[B, K·V]`` scores
  (sums in f64, as JAX's numpy promotes them), the beam states reordered,
  stopping when every beam has finished. The tensors stay on the cell's
  device; the stop test reads one bool back per step. It returns ids
  ``[B, K, T]`` (int64) and scores ``[B, K]`` (f64).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import apply_like
from . import functional as F
from . import initializer as I
from .functional import extra as FX
from .layer import Layer
from .layer_rnn import RNN, RNNCellBase

__all__ = [
    "AdaptiveLogSoftmaxWithLoss", "BeamSearchDecoder", "BiRNN",
    "ChannelShuffle", "FeatureAlphaDropout", "Fold", "FractionalMaxPool2D",
    "FractionalMaxPool3D", "HSigmoidLoss", "LPPool1D", "LPPool2D",
    "MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D", "MultiMarginLoss",
    "PairwiseDistance", "ParameterDict", "PixelUnshuffle", "RNNCellBase",
    "RNNTLoss", "Softmax2D", "SpectralNorm", "TripletMarginWithDistanceLoss",
    "Unflatten", "Unfold", "ZeroPad1D", "ZeroPad3D", "dynamic_decode",
]


# ------------------------------------------------------------- thin layers
class ChannelShuffle(Layer):
    """NCHW channel groups interleaved (JAX ignores ``data_format``)."""

    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups = groups

    def forward(self, x):
        return F.channel_shuffle(x, self.groups)


class PixelUnshuffle(Layer):
    """The inverse of PixelShuffle, NCHW (JAX ignores ``data_format``)."""

    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.r = downscale_factor

    def forward(self, x):
        return F.pixel_unshuffle(x, self.r)


class Softmax2D(Layer):
    """Softmax over the channel axis (-3)."""

    def forward(self, x):
        return apply_like(lambda v: torch.softmax(v, -3), "softmax2d", x)


class Unflatten(Layer):
    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis, self.shape = axis, shape

    def forward(self, x):
        return apply_like(lambda v: torch.unflatten(v, self.axis,
                                                    tuple(self.shape)),
                          "unflatten", x)


class ZeroPad1D(Layer):
    def __init__(self, padding, data_format="NCL", name=None):
        super().__init__()
        self.padding = ([padding] * 2 if isinstance(padding, int)
                        else list(padding))

    def forward(self, x):
        return F.pad(x, self.padding, mode="constant", value=0.0,
                     data_format="NCL")


class ZeroPad3D(Layer):
    def __init__(self, padding, data_format="NCDHW", name=None):
        super().__init__()
        self.padding = ([padding] * 6 if isinstance(padding, int)
                        else list(padding))

    def forward(self, x):
        return F.pad(x, self.padding, mode="constant", value=0.0,
                     data_format="NCDHW")


class Fold(Layer):
    """col2im."""

    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.a = (output_sizes, kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        o, k, s, p, d = self.a
        return F.fold(x, o, k, strides=s, paddings=p, dilations=d)


class Unfold(Layer):
    """im2col."""

    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.a = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        k, s, p, d = self.a
        return F.unfold(x, k, strides=s, paddings=p, dilations=d)


class FeatureAlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return FX.feature_alpha_dropout(x, self.p, training=self.training)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.args = (p, epsilon, keepdim)

    def forward(self, x, y):
        return FX.pairwise_distance(x, y, *self.args)


class ParameterDict(Layer):
    """Parameters by name; items are the paddle ``Parameter`` wrappers."""

    def __init__(self, parameters=None):
        super().__init__()
        if parameters:
            self.update(parameters)

    def __getitem__(self, key):
        return getattr(self, key)

    def __setitem__(self, key, param):
        self.add_parameter(key, param)

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters)

    def keys(self):
        return self._parameters.keys()

    def items(self):
        return [(k, self[k]) for k in self._parameters]

    def values(self):
        return [self[k] for k in self._parameters]

    def update(self, parameters):
        for k, v in (parameters.items() if isinstance(parameters, dict)
                     else parameters):
            self.add_parameter(k, v)


# ---------------------------------------------------------------- pooling
class LPPool1D(Layer):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCL", name=None):
        super().__init__()
        self.a = (norm_type, kernel_size, stride, padding, ceil_mode)

    def forward(self, x):
        return FX.lp_pool1d(x, *self.a)


class LPPool2D(Layer):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__()
        self.a = (norm_type, kernel_size, stride, padding, ceil_mode)

    def forward(self, x):
        return FX.lp_pool2d(x, *self.a)


class _MaxUnPoolNd(Layer):
    _fn = None

    def __init__(self, kernel_size, stride=None, padding=0, data_format=None,
                 output_size=None, name=None):
        super().__init__()
        self.a = (kernel_size, stride, padding, output_size)

    def forward(self, x, indices):
        k, s, p, o = self.a
        return getattr(FX, self._fn)(x, indices, k, stride=s, padding=p,
                                     output_size=o)


class MaxUnPool1D(_MaxUnPoolNd):
    _fn = "max_unpool1d"


class MaxUnPool2D(_MaxUnPoolNd):
    _fn = "max_unpool2d"


class MaxUnPool3D(_MaxUnPoolNd):
    _fn = "max_unpool3d"


class FractionalMaxPool2D(Layer):
    def __init__(self, output_size, kernel_size=None, random_u=None,
                 return_mask=False, name=None):
        super().__init__()
        self.a = (output_size, kernel_size, random_u, return_mask)

    def forward(self, x):
        return FX.fractional_max_pool2d(x, *self.a)


class FractionalMaxPool3D(Layer):
    def __init__(self, output_size, kernel_size=None, random_u=None,
                 return_mask=False, name=None):
        super().__init__()
        self.a = (output_size, kernel_size, random_u, return_mask)

    def forward(self, x):
        return FX.fractional_max_pool3d(x, *self.a)


# ----------------------------------------------------------------- losses
class MultiMarginLoss(Layer):
    def __init__(self, p=1, margin=1.0, weight=None, reduction="mean",
                 name=None):
        super().__init__()
        self.a = (p, margin, weight, reduction)

    def forward(self, input, label):
        return FX.multi_margin_loss(input, label, *self.a)


class TripletMarginWithDistanceLoss(Layer):
    """max(d(a, p) - d(a, n) + margin, 0) with a custom distance (default:
    the 2-norm ``pairwise_distance``); ``swap`` takes the smaller of d(a, n)
    and d(p, n)."""

    def __init__(self, distance_function=None, margin=1.0, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.distance_function = distance_function
        self.margin = margin
        self.swap = swap
        self.reduction = reduction

    def forward(self, input, positive, negative):
        dist = self.distance_function or (
            lambda a, b: FX.pairwise_distance(a, b, 2.0))
        dp = dist(input, positive)
        dn = dist(input, negative)
        if self.swap:
            dn = apply_like(torch.minimum, "minimum", dn,
                            dist(positive, negative))
        margin, reduction = self.margin, self.reduction

        def f(a, b):
            loss = torch.clamp(a - b + margin, min=0.0)
            if reduction == "mean":
                return loss.mean()
            return loss.sum() if reduction == "sum" else loss

        return apply_like(f, "triplet_margin_with_distance", dp, dn)


class HSigmoidLoss(Layer):
    """Hierarchical sigmoid with learned internal-node weights
    ``[2·max(C - 1, 1), D]`` (Uniform(±1/√D)) and bias (0)."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False, name=None):
        super().__init__()
        self.num_classes = num_classes
        n_nodes = max(num_classes - 1, 1)
        std = 1.0 / math.sqrt(feature_size)
        self.weight = self.create_parameter(
            [n_nodes * 2, feature_size], attr=weight_attr,
            default_initializer=I.Uniform(-std, std))
        self.bias = self.create_parameter([n_nodes * 2], attr=bias_attr,
                                          is_bias=True)

    def forward(self, input, label, path_table=None, path_code=None):
        return FX.hsigmoid_loss(input, label, self.num_classes, self.weight,
                                self.bias, path_table, path_code)


class RNNTLoss(Layer):
    def __init__(self, blank=0, fastemit_lambda=0.001, reduction="mean",
                 name=None):
        super().__init__()
        self.a = (blank, fastemit_lambda, reduction)

    def forward(self, input, label, input_lengths, label_lengths):
        return FX.rnnt_loss(input, label, input_lengths, label_lengths,
                            *self.a)


class AdaptiveLogSoftmaxWithLoss(Layer):
    """Frequency-clustered softmax: ``head_weight`` ``[D, c0 + n]``
    (``head_bias`` optional) and per cluster ``tail_{i}_0`` ``[D, h_i]``,
    ``tail_{i}_1`` ``[h_i, size_i]``, h_i = max(1, int(D / div^(i+1)));
    all Uniform(±1/√D), the bias 0. ``forward`` returns (output, loss)."""

    def __init__(self, in_features, n_classes, cutoffs, div_value=4.0,
                 head_bias=False, name=None):
        super().__init__()
        cutoffs = list(cutoffs)
        self.cutoffs = cutoffs + [n_classes]
        self.n_clusters = len(cutoffs)
        self.head_size = cutoffs[0] + self.n_clusters
        u = I.Uniform(-1.0 / math.sqrt(in_features),
                      1.0 / math.sqrt(in_features))
        self.head_weight = self.create_parameter(
            [in_features, self.head_size], default_initializer=u)
        self.head_bias = (self.create_parameter([self.head_size],
                                                is_bias=True)
                          if head_bias else None)
        self.tail_weights = []
        for i in range(self.n_clusters):
            hsz = max(1, int(in_features / (div_value ** (i + 1))))
            osz = self.cutoffs[i + 1] - self.cutoffs[i]
            w1 = self.create_parameter([in_features, hsz],
                                       default_initializer=u)
            w2 = self.create_parameter([hsz, osz], default_initializer=u)
            self.add_parameter(f"tail_{i}_0", w1)
            self.add_parameter(f"tail_{i}_1", w2)
            self.tail_weights.append((w1, w2))

    def forward(self, input, label):
        return FX.adaptive_log_softmax_with_loss(
            input, label, self.head_weight, self.tail_weights, self.cutoffs,
            self.head_bias)


# ------------------------------------------------------------------- norm
class SpectralNorm(Layer):
    """weight / sigma_max(weight), sigma from ``power_iters`` power-iteration
    steps over the weight reshaped to ``[shape[dim], -1]``, from the stored
    ``weight_u`` ``[shape[dim]]`` and ``weight_v`` ``[rest]`` (Normal(0, 1),
    no gradient), which are never updated (JAX :397-435)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, epsilon=1e-12,
                 dtype="float32"):
        super().__init__()
        self.dim = dim
        self.power_iters = power_iters
        self.epsilon = epsilon
        h = weight_shape[dim]
        w = int(np.prod(weight_shape)) // h
        self.weight_u = self.create_parameter(
            [h], default_initializer=I.Normal(0.0, 1.0))
        self.weight_v = self.create_parameter(
            [w], default_initializer=I.Normal(0.0, 1.0))
        self.weight_u.stop_gradient = True
        self.weight_v.stop_gradient = True

    def forward(self, x):
        eps, iters, dim = self.epsilon, max(self.power_iters, 1), self.dim

        def f(w, u, v):
            mat = w.movedim(dim, 0).reshape(w.shape[dim], -1)
            for _ in range(iters):
                v = mat.T @ u
                v = v / (torch.linalg.vector_norm(v) + eps)
                u = mat @ v
                u = u / (torch.linalg.vector_norm(u) + eps)
            return w / (u @ mat @ v)

        return apply_like(f, "spectral_norm", x, self.weight_u,
                          self.weight_v)


# -------------------------------------------------------- seq2seq decode
class BiRNN(Layer):
    """A forward and a backward cell over the sequence, features
    concatenated; the backward cell runs over the time-reversed input and
    its output is reversed back. Returns (outputs, (fw state, bw
    state))."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.cell_fw = cell_fw
        self.cell_bw = cell_bw
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        from .layer_rnn import _refuse

        _refuse("BiRNN", sequence_length=sequence_length)
        axis = 0 if self.time_major else 1
        s_fw, s_bw = (initial_states if initial_states is not None
                      else (None, None))
        out_fw, st_fw = RNN(self.cell_fw, time_major=self.time_major)(
            inputs, s_fw)

        def rev(t):
            return apply_like(lambda v: torch.flip(v, [axis]), "reverse", t)

        out_bw, st_bw = RNN(self.cell_bw, time_major=self.time_major)(
            rev(inputs), s_bw)
        out = apply_like(lambda a, b: torch.cat([a, b], -1), "concat",
                         out_fw, rev(out_bw))
        return out, (st_fw, st_bw)


class BeamSearchDecoder:
    """Beam search over an RNN cell, with an embedding function for the
    fed-back tokens and an output projection to the vocabulary."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn


def _value(t):
    return t._value if hasattr(t, "_value") else t


def _reorder_beam(state, src):
    """A state [B·K, ...] with each batch's beams taken from ``src`` [B, K]
    (flat row indices b·K + k)."""
    if isinstance(state, (tuple, list)):
        return type(state)(_reorder_beam(s, src) for s in state)
    if not isinstance(_value(state), torch.Tensor):
        return state
    from ..tensor import Tensor

    out = _value(state).index_select(0, src.reshape(-1))
    return Tensor(out) if isinstance(state, Tensor) else out


def dynamic_decode(decoder, inits=None, max_step_num=None, **kwargs):
    """Beam search with ``decoder`` (a ``BeamSearchDecoder``) for at most
    ``max_step_num`` steps (16 by default) over ``batch_size`` rows (1 by
    default; a keyword argument, as JAX's). Returns (ids [B, K, T] int64,
    scores [B, K] f64) as Tensors (see the module docstring)."""
    from ..tensor import Tensor

    cell = decoder.cell
    B = kwargs.get("batch_size", 1)
    K = decoder.beam_size
    T = max_step_num or 16
    dev = next(torch.nn.Module.parameters(cell)).device
    tok = torch.full((B * K,), decoder.start_token, dtype=torch.int64,
                     device=dev)
    scores = torch.zeros((B, K), dtype=torch.float64, device=dev)
    scores[:, 1:] = -1e9            # first step: all beams alike, keep one
    states = inits
    ids = torch.zeros((B, K, 0), dtype=torch.int64, device=dev)
    finished = torch.zeros((B, K), dtype=torch.bool, device=dev)
    base = torch.arange(B, device=dev)[:, None] * K
    for _ in range(T):
        emb = (decoder.embedding_fn(Tensor(tok)) if decoder.embedding_fn
               else Tensor(tok))
        out, states = cell(emb, states)
        logits = decoder.output_fn(out) if decoder.output_fn else out
        logp = torch.log_softmax(_value(logits).float(), -1).reshape(B, K, -1)
        V = logp.shape[-1]
        only_end = torch.full((V,), -1e9, dtype=torch.float64, device=dev)
        only_end[decoder.end_token] = 0.0
        logp = torch.where(finished[..., None], only_end, logp.double())
        flat = (scores[..., None] + logp).reshape(B, -1)
        scores, top = flat.topk(K, dim=1)
        beam_src = top // V
        tok2d = top % V
        ids = torch.cat([ids.gather(1, beam_src[..., None].expand(
            B, K, ids.shape[-1])), tok2d[..., None]], -1)
        finished = finished.gather(1, beam_src) | (tok2d == decoder.end_token)
        tok = tok2d.reshape(-1)
        states = _reorder_beam(states, base + beam_src)
        if bool(finished.all()):
            break
    return Tensor(ids), Tensor(scores)
