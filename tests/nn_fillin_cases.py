"""The nn pieces of the recurrent layers, the layer and functional fill-ins
and grid sampling, as cases that run on any device: ``run_cases`` builds
each case on the CPU and on ``device`` with the same weights (the CPU
layers' state dicts loaded into the device's), in f64 and f32, and holds
the device's outputs, and the gradients of a weighted sum of its
differentiable outputs with respect to its floating inputs, to the
CPU's; with
``capture``, each case that needs no host read is captured in a CUDA
graph and replayed, bit-equal to eager.

This module imports numpy only and takes the port as an argument (no
JAX):
``chip_smoke.py``'s ``core`` phase and ``tests/test_torch_cuda_nn.py`` run
it on the card, ``tests/test_torch_chip_smoke.py`` rehearses it on the
CPU.

Limits: the largest |device - CPU| over the largest |CPU value| (or 1,
where the values are smaller), ``TOL`` per dtype: other summation orders
in f32 (cuBLAS and the CPU's BLAS), reassociation only in f64; f32's for
the cases JAX computes in f32 inside (``limit``).
"""
import numpy as np

TOL = {"float64": 1e-10, "float32": 1e-4}

IN, HID, B, T = 5, 6, 3, 4


def _r(shape, seed, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape)


# Each case: make(P) -> (fn, arrays, layers); fn takes the arrays as
# Tensors, in the order given, and returns a Tensor or a tuple of them.
def simple_rnn(P):
    layer = P.nn.SimpleRNN(IN, HID, num_layers=2, direction="bidirect")
    return (lambda x: layer(x)), [_r((B, T, IN), 1)], [layer]


def lstm(P):
    layer = P.nn.LSTM(IN, HID, num_layers=2, direction="bidirect",
                      time_major=True)
    return ((lambda x, h, c: layer(x, (h, c))),
            [_r((T, B, IN), 2), _r((4, B, HID), 3), _r((4, B, HID), 4)],
            [layer])


def gru(P):
    layer = P.nn.GRU(IN, HID, num_layers=2)
    return (lambda x: layer(x)), [_r((B, T, IN), 5)], [layer]


def cells(P):
    s, l, g = (P.nn.SimpleRNNCell(IN, HID, activation="relu"),
               P.nn.LSTMCell(IN, HID), P.nn.GRUCell(IN, HID))

    def fn(x, h, c):
        return s(x, h)[0], l(x, (h, c))[1], g(x, h)[0]

    return fn, [_r((B, IN), 6), _r((B, HID), 7), _r((B, HID), 8)], [s, l, g]


def birnn(P):
    layer = P.nn.BiRNN(P.nn.GRUCell(IN, HID), P.nn.LSTMCell(IN, HID))
    return (lambda x: layer(x)), [_r((B, T, IN), 9)], [layer]


def thin_layers(P):
    nn = P.nn

    def fn(x, a, b, cols):
        return (nn.ChannelShuffle(2)(x), nn.PixelUnshuffle(2)(x),
                nn.Softmax2D()(x), nn.Unflatten(1, [2, 2])(x),
                nn.ZeroPad1D([1, 2])(a), nn.ZeroPad3D(1)(x[None]),
                nn.Fold([4, 4], 2, strides=1)(cols),
                nn.Unfold(2, strides=1, paddings=1)(x),
                nn.PairwiseDistance(p=3.0)(a[0], b[0]),
                P.nn.functional.pairwise_distance(a[0], b[0], keepdim=True))

    return fn, [_r((2, 4, 4, 4), 10), _r((2, 3, 5), 11), _r((2, 3, 5), 12),
                _r((2, 16, 9), 13)], []


def pools(P):
    nn, F = P.nn, P.nn.functional

    def fn(x, x1, x3):
        out, idx = F.max_pool2d(x, 2, return_mask=True)
        o1, i1 = F.max_pool1d(x1, 2, return_mask=True)
        o3, i3 = F.max_pool3d(x3, 2, return_mask=True)
        return (nn.LPPool2D(2, 2)(x.abs()), nn.LPPool1D(3, 2, 1)(x1.abs()),
                nn.FractionalMaxPool2D([3, 2])(x),
                F.fractional_max_pool2d(x, 3, random_u=0.2),
                nn.FractionalMaxPool3D(2, random_u=0.7)(x3),
                nn.MaxUnPool2D(2)(out, idx), F.max_unpool1d(o1, i1, 2),
                F.max_unpool3d(o3, i3, 2))

    return fn, [_r((2, 3, 6, 4), 14), _r((2, 3, 8), 15),
                _r((1, 2, 4, 4, 4), 16)], []


def losses(P):
    nn, F = P.nn, P.nn.functional
    alsm = nn.AdaptiveLogSoftmaxWithLoss(8, 12, [4, 9], div_value=2.0,
                                         head_bias=True)
    y = P.to_tensor(np.array([0, 3, 5, 11, 7]))
    y3 = P.to_tensor(np.array([0, 2, 1, 2, 0]))
    lab = P.to_tensor(np.array([[1, 2], [3, 0]]))
    tl, ul = (P.to_tensor(np.array([4, 3])), P.to_tensor(np.array([2, 1])))

    def fn(x, a, p, n):
        return (alsm(x, y)[1],
                nn.MultiMarginLoss(p=2, margin=0.5)(a[:, :3], y3),
                nn.TripletMarginWithDistanceLoss(swap=True)(a, p, n),
                F.npair_loss(a, p, y3))

    return fn, [_r((5, 8), 17), _r((5, 6), 18), _r((5, 6), 19),
                _r((5, 6), 20)], [alsm]


def f32_losses(P):
    """The losses JAX computes in f32 whatever their inputs' dtype."""
    nn, F = P.nn, P.nn.functional
    y = P.to_tensor(np.array([0, 3, 5, 11, 7]))
    lab = P.to_tensor(np.array([[1, 2], [3, 0]]))
    tl, ul = (P.to_tensor(np.array([4, 3])), P.to_tensor(np.array([2, 1])))

    def fn(lg, cos):
        return (nn.RNNTLoss(blank=0, reduction="none")(lg, lab, tl, ul),
                F.margin_cross_entropy(cos, y, return_softmax=True,
                                       reduction="none"))

    return fn, [_r((2, 4, 3, 5), 21), _r((5, 12), 22, -0.3, 0.3)], []


def hsigmoid(P):
    layer = P.nn.HSigmoidLoss(8, 7)
    y = P.to_tensor(np.array([0, 3, 5, 6]))
    return (lambda x: layer(x, y)), [_r((4, 8), 23)], [layer]


def spectral_norm(P):
    layer = P.nn.SpectralNorm([3, 5, 2], dim=1, power_iters=3)
    return (lambda w: layer(w)), [_r((3, 5, 2), 24)], [layer]


def sparse_attention(P):
    S = 6
    mask = np.random.default_rng(25).random((1, 2, S, S)) < 0.5
    mask[..., np.arange(S), np.arange(S)] = True
    offs = np.concatenate([np.zeros((1, 2, 1), np.int64),
                           np.cumsum(mask.sum(-1), -1)], -1)
    cols = np.zeros((1, 2, int(mask.sum((-1, -2)).max())), np.int64)
    for h in range(2):
        c = np.nonzero(mask[0, h])[1]
        cols[0, h, :len(c)] = c
    o, c = P.to_tensor(offs), P.to_tensor(cols)
    return ((lambda q, k, v: P.nn.functional.sparse_attention(q, k, v, o, c)),
            [_r((1, 2, S, 4), 26), _r((1, 2, S, 4), 27),
             _r((1, 2, S, 4), 28)], [])


def gather_and_inplace(P):
    F = P.nn.functional
    ids = P.to_tensor(np.random.default_rng(29).integers(0, 9, (5, 2, 3)))
    par = P.to_tensor(np.random.default_rng(30).integers(0, 3, (5, 2, 3)))

    def fn(x):
        return (F.hardtanh_(x.clone(), -0.5, 0.5),
                F.leaky_relu_(x.clone(), 0.2), F.tanh_(x.clone()),
                F.thresholded_relu_(x.clone(), 0.3),
                F.feature_alpha_dropout(x, 0.5, training=False),
                F.gather_tree(ids, par))

    return fn, [_r((3, 4), 31)], []


def vision(P):
    F = P.nn.functional

    def fn(theta, x, g):
        outs = [F.affine_grid(theta, [2, 3, 5, 4], align_corners=a)
                for a in (True, False)]
        for mode in ("bilinear", "nearest"):
            for pad in ("zeros", "border", "reflection"):
                for a in (True, False):
                    outs.append(F.grid_sample(x, g, mode=mode,
                                              padding_mode=pad,
                                              align_corners=a))
        return tuple(outs)

    return fn, [_r((2, 2, 3), 32), _r((2, 3, 4, 5), 33),
                _r((2, 5, 6, 2), 34, -1.4, 1.4)], []


def class_center_sample(P):
    y = P.to_tensor(np.array([2, 5, 5, 9]))
    return ((lambda x: P.nn.functional.class_center_sample(y, 20, 6)
             + (x * 1.0,)), [_r((2,), 35)], [])


def dynamic_decode(P):
    emb, cell, proj = (P.nn.Embedding(11, 4), P.nn.LSTMCell(4, HID),
                       P.nn.Linear(HID, 11))
    dec = P.nn.BeamSearchDecoder(cell, 0, 1, 3, emb, proj)

    def fn(x):
        ids, scores = P.nn.dynamic_decode(dec, max_step_num=6, batch_size=2)
        return ids, scores, x * 1.0

    return fn, [_r((2,), 36)], [emb, cell, proj]


# name -> (make, capturable, differentiable, computed in f32): not
# capturable where a host read stands in the way (the default tree's and
# class_center_sample's numpy, the decode loop's stop test); "computed in
# f32" where JAX's formula casts to f32 inside (the RNN-T and
# combined-margin losses, the decode's log-softmax), so f64 inputs meet
# f32's limit there
CASES = {
    "simple_rnn": (simple_rnn, True, True, False),
    "lstm": (lstm, True, True, False), "gru": (gru, True, True, False),
    "cells": (cells, True, True, False),
    "birnn": (birnn, True, True, False),
    "thin_layers": (thin_layers, True, True, False),
    "pools": (pools, True, True, False),
    "losses": (losses, True, True, False),
    "f32_losses": (f32_losses, True, True, True),
    "hsigmoid": (hsigmoid, False, True, False),
    "spectral_norm": (spectral_norm, True, True, False),
    "sparse_attention": (sparse_attention, True, True, False),
    "gather_and_inplace": (gather_and_inplace, True, True, False),
    "vision": (vision, True, True, False),
    "class_center_sample": (class_center_sample, False, False, False),
    "dynamic_decode": (dynamic_decode, False, False, True),
}


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [e for item in x for e in _leaves(item)]
    return [x]


def _run(P, make, dtype, states=None, grad=True):
    """(outputs as numpy, gradients as numpy, fn, Tensors, layers)."""
    P.seed(0)
    fn, arrays, layers = make(P)
    for layer, st in zip(layers, states or [None] * len(layers)):
        layer.astype(dtype)
        if st is not None:
            layer.set_state_dict(st)
    ins = [P.to_tensor(a.astype(dtype), stop_gradient=not grad)
           for a in arrays]
    out = _leaves(fn(*ins))
    grads = []
    if grad:
        loss = sum((o * P.to_tensor(_r(o.shape, 99 + i).astype(dtype))).sum()
                   for i, o in enumerate(out) if not o.stop_gradient)
        loss.backward()
        grads = [t.grad.numpy() if t.grad is not None else None
                 for t in ins]
    return [o.numpy() for o in out], grads, fn, ins, layers


def _err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    if not want.size:
        return 0.0
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1.0))


def run_cases(P, device, capture_case=None, dtypes=("float64", "float32"),
              names=None):
    """Every case (or ``names``) on the CPU and on ``device`` (a place
    ``P.set_device`` takes), per dtype: {dtype: {case: worst relative
    error of the outputs and gradients}}, plus {dtype: [cases captured
    bit-equal]} under "captured" when ``capture_case(fn, ins, eager)`` is
    given. Raises past ``TOL``, or when a capture is not bit-equal; the
    integer outputs (ids, indices, the sampled classes) must be equal."""
    from paddle_tpu_torch.framework import device as pdev

    prev = pdev._current["place"]
    res, captured = {}, {}
    try:
        for dtype in dtypes:
            res[dtype], captured[dtype] = {}, []
            for name in names or CASES:
                make, capturable, differentiable, in_f32 = CASES[name]
                limit = TOL["float32" if in_f32 else dtype]
                P.set_device("cpu")
                want, wgrads, _, _, layers = _run(P, make, dtype,
                                                  grad=differentiable)
                states = [{k: v.numpy() for k, v in layer.state_dict()
                           .items()} for layer in layers]
                P.set_device(device)
                got, grads, fn, ins, _ = _run(P, make, dtype, states,
                                              grad=differentiable)
                worst = 0.0
                for g, w in zip(got + grads, want + wgrads):
                    if w is None:
                        assert g is None, name
                    elif w.dtype.kind in "iub":
                        np.testing.assert_array_equal(g, w, err_msg=name)
                    else:
                        worst = max(worst, _err(g, w))
                res[dtype][name] = worst
                if worst > limit:
                    raise AssertionError(f"{name} {dtype}: device against "
                                         f"CPU {worst} > {limit}")
                if capture_case is not None and capturable:
                    plain = [P.to_tensor(t.numpy()) for t in ins]
                    if not capture_case(fn, plain, _leaves(fn(*plain))):
                        raise AssertionError(f"{name} {dtype}: the replay "
                                             f"differs from eager")
                    captured[dtype].append(name)
    finally:
        pdev._current["place"] = prev
    if capture_case is not None:
        res["captured"] = captured
    return res
