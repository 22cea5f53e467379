"""The nn fill-ins of the port (``nn/layer_extra.py``,
``nn/functional/extra.py``) on both packages (``port_bodies.run``: the
port's results held to the JAX package's within 1e-5 relative and 1e-5
absolute, f32 sums in other orders; integers and dtypes exactly).

The bodies of ``tests/test_export_parity_fillins.py:156-340`` run here on
either package, with their torch golden checks, and return what they
computed so the two packages are compared too; further bodies cover the
options, the layers and the gradients. The sampled pieces are pinned by
law where the draw is the port's own: ``feature_alpha_dropout``'s channel
mask (keep rate within 5 binomial sigmas, channel-constant maps, SELU's
mean and variance kept). ``class_center_sample`` and the fractional pools
without ``random_u`` are deterministic in JAX (a seeded numpy draw, u =
0.5) and are held to it exactly, with the law pinned beside.
"""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from port_bodies import npy, on_cpu, run  # noqa: F401

PKG = pytest.mark.parametrize("pkg", ["jax", "torch"])


def _r(shape, seed=0, lo=-2.0, hi=2.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _t(paddle, a, grad=False):
    return paddle.to_tensor(a, stop_gradient=not grad)


def t2n(x):
    return x.detach().numpy()


def _grad_of(paddle, fn, *arrays, seed=99):
    """fn's output and the gradient of sum(fn · w) for each input."""
    ts = [_t(paddle, a, grad=True) for a in arrays]
    out = fn(*ts)
    w = _r(out.shape, seed=seed)
    (out * _t(paddle, w)).sum().backward()
    return {"out": npy(out), **{f"g{i}": npy(t.grad)
                                for i, t in enumerate(ts)}}


# ------------------------------------------------- JAX's fill-in bodies
def pairwise_distance_and_losses(paddle):
    F = paddle.nn.functional
    rs = np.random.RandomState(0)
    a, b = rs.randn(5, 8).astype("float32"), rs.randn(5, 8).astype("float32")
    pd = npy(F.pairwise_distance(_t(paddle, a), _t(paddle, b)))
    np.testing.assert_allclose(pd, t2n(torch.nn.functional.pairwise_distance(
        torch.tensor(a), torch.tensor(b))), rtol=1e-4)
    logits = rs.randn(6, 4).astype("float32")
    y = rs.randint(0, 4, 6)
    mm = npy(F.multi_margin_loss(_t(paddle, logits), _t(paddle, y)))
    np.testing.assert_allclose(float(mm), float(t2n(
        torch.nn.functional.multi_margin_loss(torch.tensor(logits),
                                              torch.tensor(y)))), rtol=1e-5)
    res = {"pd": pd, "mm": mm}
    for p in (1.0, 3.0, float("inf")):
        got = npy(F.pairwise_distance(_t(paddle, a), _t(paddle, b), p=p,
                                      keepdim=True))
        np.testing.assert_allclose(got, t2n(
            torch.nn.functional.pairwise_distance(
                torch.tensor(a), torch.tensor(b), p=p, keepdim=True)),
            rtol=1e-4)
        res[f"pd{p}"] = got
    w = np.abs(rs.randn(4)).astype("float32")
    for red in ("none", "sum"):
        got = npy(F.multi_margin_loss(_t(paddle, logits), _t(paddle, y), p=2,
                                      margin=0.5, weight=_t(paddle, w),
                                      reduction=red))
        np.testing.assert_allclose(got, t2n(
            torch.nn.functional.multi_margin_loss(
                torch.tensor(logits), torch.tensor(y), p=2, margin=0.5,
                weight=torch.tensor(w), reduction=red)), rtol=1e-5)
        res[f"mm_{red}"] = got
    return res


def adaptive_log_softmax(paddle):
    rs = np.random.RandomState(0)
    B, D, C = 16, 12, 20
    cutoffs = [8, 14]
    x = rs.randn(B, D).astype("float32")
    y = rs.randint(0, C, B)
    torch.manual_seed(0)
    tm = torch.nn.AdaptiveLogSoftmaxWithLoss(D, C, cutoffs, div_value=2.0,
                                             head_bias=True)
    pm = paddle.nn.AdaptiveLogSoftmaxWithLoss(D, C, cutoffs, div_value=2.0,
                                              head_bias=True)
    state = {"head_weight": t2n(tm.head.weight).T.copy(),
             "head_bias": t2n(tm.head.bias).copy()}
    for i, tail in enumerate(tm.tail):
        state[f"tail_{i}_0"] = t2n(tail[0].weight).T.copy()
        state[f"tail_{i}_1"] = t2n(tail[1].weight).T.copy()
    pm.set_state_dict(state)
    t_out = tm(torch.tensor(x), torch.tensor(y))
    xt = _t(paddle, x, grad=True)
    p_out, p_loss = pm(xt, _t(paddle, y))
    np.testing.assert_allclose(npy(p_out), t2n(t_out.output), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(npy(p_loss)), float(t2n(t_out.loss)),
                               rtol=1e-4)
    p_loss.backward()
    return {"out": npy(p_out), "loss": npy(p_loss), "gx": npy(xt.grad),
            "g_head": npy(pm.head_weight.grad),
            "g_tail": npy(pm.tail_weights[1][1].grad)}


def max_unpool(paddle):
    F = paddle.nn.functional
    rs = np.random.RandomState(0)
    x = rs.randn(2, 3, 8, 8).astype("float32")
    t_out, t_idx = torch.nn.functional.max_pool2d(torch.tensor(x), 2,
                                                  return_indices=True)
    p_out, p_idx = F.max_pool2d(_t(paddle, x), 2, return_mask=True)
    np.testing.assert_allclose(npy(p_out), t2n(t_out), rtol=1e-6)
    p_un = F.max_unpool2d(p_out, p_idx, 2)
    np.testing.assert_allclose(npy(p_un), t2n(
        torch.nn.functional.max_unpool2d(t_out, t_idx, 2)), rtol=1e-6)
    res = {"un2": npy(p_un)}
    x1 = rs.randn(2, 3, 10).astype("float32")
    o1, i1 = F.max_pool1d(_t(paddle, x1), 2, return_mask=True)
    res["un1"] = npy(paddle.nn.MaxUnPool1D(2)(o1, i1))
    x3 = rs.randn(1, 2, 4, 4, 4).astype("float32")
    o3, i3 = F.max_pool3d(_t(paddle, x3), 2, return_mask=True)
    res["un3"] = npy(paddle.nn.MaxUnPool3D(2)(o3, i3))
    res["un2_size"] = npy(paddle.nn.MaxUnPool2D(2, output_size=[9, 9])(
        p_out, p_idx))
    return res


def lp_pool(paddle):
    F = paddle.nn.functional
    rs = np.random.RandomState(0)
    x = np.abs(rs.randn(2, 3, 8, 8)).astype("float32")
    res = {"p2": npy(F.lp_pool2d(_t(paddle, x), 2, 2))}
    np.testing.assert_allclose(res["p2"], t2n(torch.nn.functional.lp_pool2d(
        torch.tensor(x), 2, 2)), rtol=1e-4)
    x1 = np.abs(rs.randn(2, 3, 8)).astype("float32")
    res["p1"] = npy(F.lp_pool1d(_t(paddle, x1), 2, 2))
    np.testing.assert_allclose(res["p1"], t2n(torch.nn.functional.lp_pool1d(
        torch.tensor(x1), 2, 2)), rtol=1e-4)
    res["p3s1"] = npy(paddle.nn.LPPool2D(3, [2, 3], stride=1)(_t(paddle, x)))
    np.testing.assert_allclose(res["p3s1"], t2n(
        torch.nn.functional.lp_pool2d(torch.tensor(x), 3, (2, 3), 1)),
        rtol=1e-4)
    res["layer1"] = npy(paddle.nn.LPPool1D(2, 3, stride=2)(_t(paddle, x1)))
    return res


def shuffles_and_pads(paddle):
    nn = paddle.nn
    rs = np.random.RandomState(0)
    x = rs.randn(1, 4, 4, 4).astype("float32")
    res = {"unshuffle": npy(nn.PixelUnshuffle(2)(_t(paddle, x))),
           "shuffle": npy(nn.ChannelShuffle(2)(_t(paddle, x))),
           "softmax2d": npy(nn.Softmax2D()(_t(paddle, x)))}
    np.testing.assert_allclose(res["unshuffle"], t2n(
        torch.nn.PixelUnshuffle(2)(torch.tensor(x))), rtol=1e-6)
    np.testing.assert_allclose(res["shuffle"], t2n(
        torch.nn.ChannelShuffle(2)(torch.tensor(x))), rtol=1e-6)
    np.testing.assert_allclose(res["softmax2d"], t2n(
        torch.nn.Softmax2d()(torch.tensor(x))), rtol=1e-5)
    res["unflatten"] = npy(nn.Unflatten(1, [2, 2])(_t(paddle, x)))
    assert list(res["unflatten"].shape) == [1, 2, 2, 4, 4]
    x1 = rs.randn(2, 3, 5).astype("float32")
    res["zp1"] = npy(nn.ZeroPad1D([1, 2])(_t(paddle, x1)))
    res["zp3"] = npy(nn.ZeroPad3D(1)(_t(paddle, x[None])))
    xf = rs.randn(1, 2, 6, 6).astype("float32")
    cols = nn.Unfold(kernel_sizes=2, strides=2)(_t(paddle, xf))
    back = nn.Fold(output_sizes=[6, 6], kernel_sizes=2, strides=2)(cols)
    np.testing.assert_allclose(npy(back), xf, rtol=1e-5)
    res["cols"] = npy(cols)
    res["fold_overlap"] = npy(nn.Fold([5, 5], 3, strides=1, paddings=1)(
        nn.Unfold(3, strides=1, paddings=1)(_t(paddle, xf[..., :5, :5]))))
    return res


def rnnt(paddle):
    F = paddle.nn.functional
    logits = _t(paddle, np.zeros((1, 2, 2, 2), "float32"))  # uniform
    lab = _t(paddle, np.array([[1]], "int64"))
    tl = _t(paddle, np.array([2], "int64"))
    ul = _t(paddle, np.array([1], "int64"))
    loss = float(npy(F.rnnt_loss(logits, lab, tl, ul, blank=0)))
    np.testing.assert_allclose(loss, -np.log(0.5 ** 3 + 0.5 ** 3),
                               rtol=1e-5)
    return {"tiny": np.float32(loss), **_rnnt_random(paddle, "mean")}


_RNNT_LABELS = np.array([[1, 2], [3, 0]], "int64")
_RNNT_LENS = (np.array([5, 3], "int64"), np.array([2, 1], "int64"))


def _rnnt_random(paddle, red):
    """B 2, T 5, U 2, V 4 with per-row lengths: the loss and its logits
    gradient."""
    F = paddle.nn.functional
    lg = np.random.RandomState(3).randn(2, 5, 3, 4).astype("float32")
    return {f"{red}:{k}": v for k, v in _grad_of(
        paddle, lambda a: F.rnnt_loss(
            a, _t(paddle, _RNNT_LABELS), _t(paddle, _RNNT_LENS[0]),
            _t(paddle, _RNNT_LENS[1]), blank=0, reduction=red),
        lg).items()}


def rnnt_layer(paddle):
    lg = np.random.RandomState(3).randn(2, 5, 3, 4).astype("float32")
    res = _rnnt_random(paddle, "none")
    res["layer"] = npy(paddle.nn.RNNTLoss(blank=3, reduction="sum")(
        _t(paddle, lg), _t(paddle, _RNNT_LABELS), _t(paddle, _RNNT_LENS[0]),
        _t(paddle, _RNNT_LENS[1])))
    return res


def gather_tree(paddle):
    F = paddle.nn.functional
    ids = np.array([[[1, 2]], [[3, 4]], [[5, 6]]], "int64")      # T3 B1 W2
    par = np.array([[[0, 0]], [[1, 0]], [[0, 1]]], "int64")
    out = npy(F.gather_tree(_t(paddle, ids), _t(paddle, par)))
    assert out.shape == (3, 1, 2)
    assert out[2, 0, 0] == 5 and out[2, 0, 1] == 6
    rs = np.random.RandomState(1)
    T, B, W = 5, 2, 3
    ids2 = rs.randint(0, 9, (T, B, W))
    par2 = rs.randint(0, W, (T, B, W))
    got = npy(F.gather_tree(_t(paddle, ids2), _t(paddle, par2)))
    want = np.zeros_like(ids2)
    for b in range(B):
        for w in range(W):
            beam = w
            for t in range(T - 1, -1, -1):
                want[t, b, w] = ids2[t, b, beam]
                beam = par2[t, b, beam]
    np.testing.assert_array_equal(got, want)
    return {"small": out, "random": got}


def spectral_norm(paddle):
    rs = np.random.RandomState(0)
    w = rs.randn(6, 4).astype("float32")
    sn = paddle.nn.SpectralNorm([6, 4], power_iters=30)
    out = npy(sn(_t(paddle, w)))
    assert abs(np.linalg.svd(out, compute_uv=False)[0] - 1.0) < 1e-3
    # one iteration from given u, v on a 4-d weight over dim 1: the
    # values and gradients depend on u and v, which stay as they were
    w4 = rs.randn(3, 5, 2, 2).astype("float32")
    sn1 = paddle.nn.SpectralNorm([3, 5, 2, 2], dim=1, power_iters=1)
    u, v = rs.randn(5).astype("float32"), rs.randn(12).astype("float32")
    sn1.set_state_dict({"weight_u": u, "weight_v": v})
    res = _grad_of(paddle, sn1, w4)
    np.testing.assert_array_equal(npy(sn1.weight_u), u)
    np.testing.assert_array_equal(npy(sn1.weight_v), v)
    assert sn1.weight_u.stop_gradient and sn1.weight_v.stop_gradient
    return {"sigma30": out, **res}


def hsigmoid_and_margin_ce(paddle):
    F = paddle.nn.functional
    x = np.random.RandomState(0).randn(4, 8).astype("float32")
    y = np.array([0, 3, 5, 6], "int64")
    layer = paddle.nn.HSigmoidLoss(8, 7)
    assert [list(t.shape) for t in layer.state_dict().values()] == [
        [12, 8], [12]]
    layer.set_state_dict({"weight": _r((12, 8), 4), "bias": _r((12,), 5)})
    xt = _t(paddle, x, grad=True)
    loss = layer(xt, _t(paddle, y))
    assert list(loss.shape) == [4, 1] and np.isfinite(npy(loss)).all()
    loss.sum().backward()
    res = {"hs": npy(loss), "hs_gx": npy(xt.grad),
           "hs_gw": npy(layer.weight.grad)}
    table = np.array([[0, 1, -1], [0, 2, 3], [0, 2, 4], [0, 1, 5]], "int64")
    code = np.array([[0, 1, 0], [1, 0, 1], [1, 1, 0], [0, 0, 1]], "int64")
    res["hs_custom"] = npy(F.hsigmoid_loss(
        _t(paddle, x), _t(paddle, np.array([0, 1, 2, 3])), 4,
        _t(paddle, _r((6, 8), 6)), None, _t(paddle, table.clip(0)),
        _t(paddle, code)))
    logits = (np.random.RandomState(1).randn(4, 10) * 0.1).astype("float32")
    out = F.margin_cross_entropy(_t(paddle, logits), _t(paddle, y),
                                 return_softmax=False)
    assert np.isfinite(float(npy(out)))
    res["mce"] = npy(out)
    loss, sm = F.margin_cross_entropy(_t(paddle, logits), _t(paddle, y),
                                      margin1=0.9, margin2=0.3, margin3=0.1,
                                      scale=16.0, return_softmax=True,
                                      reduction="none")
    res.update(mce_none=npy(loss), mce_sm=npy(sm))
    res.update({f"mce_{k}": v for k, v in _grad_of(
        paddle, lambda a: F.margin_cross_entropy(a, _t(paddle, y)),
        logits).items()})
    return res


def losses_and_distance_layers(paddle):
    nn, F = paddle.nn, paddle.nn.functional
    rs = np.random.RandomState(2)
    a, p, n = (rs.randn(5, 6).astype("float32") for _ in range(3))
    res = {"pd_layer": npy(nn.PairwiseDistance(p=1.0, keepdim=True)(
        _t(paddle, a), _t(paddle, p)))}
    for swap in (False, True):
        res[f"trip{swap}"] = npy(nn.TripletMarginWithDistanceLoss(
            margin=0.5, swap=swap)(_t(paddle, a), _t(paddle, p),
                                   _t(paddle, n)))
        np.testing.assert_allclose(res[f"trip{swap}"], t2n(
            torch.nn.TripletMarginWithDistanceLoss(margin=0.5, swap=swap)(
                torch.tensor(a), torch.tensor(p), torch.tensor(n))),
            rtol=1e-5)
    res["trip_custom"] = npy(nn.TripletMarginWithDistanceLoss(
        distance_function=lambda u, v: F.pairwise_distance(u, v, 1.0),
        reduction="none")(_t(paddle, a), _t(paddle, p), _t(paddle, n)))
    y = rs.randint(0, 3, 5)
    res["mm_layer"] = npy(nn.MultiMarginLoss(p=2, margin=0.7)(
        _t(paddle, rs.randn(5, 3).astype("float32")), _t(paddle, y)))
    labels = np.array([0, 1, 0, 2, 1], "int64")
    res.update({f"npair_{k}": v for k, v in _grad_of(
        paddle, lambda u, v: F.npair_loss(u, v, _t(paddle, labels)),
        a, p).items()})
    return res


def fractional_pools(paddle):
    nn, F = paddle.nn, paddle.nn.functional
    x = _r((2, 3, 9, 11), 7)
    x3 = _r((1, 2, 7, 6, 5), 8)
    res = {}
    for u in (None, 0.1, 0.85):
        res[f"2d{u}"] = npy(F.fractional_max_pool2d(_t(paddle, x), [4, 5],
                                                    random_u=u))
        res[f"3d{u}"] = npy(F.fractional_max_pool3d(_t(paddle, x3), 3,
                                                    random_u=u))
    out, mask = nn.FractionalMaxPool2D(3, return_mask=True)(_t(paddle, x))
    assert mask is None
    res["layer2"] = npy(out)
    res["layer3"] = npy(nn.FractionalMaxPool3D([2, 3, 2], random_u=0.3)(
        _t(paddle, x3)))
    res.update({f"g_{k}": v for k, v in _grad_of(
        paddle, lambda v: F.fractional_max_pool2d(v, 4), x).items()})
    return res


def sparse_attention(paddle):
    F = paddle.nn.functional
    B, H, S, D = 1, 2, 6, 4
    rs = np.random.RandomState(5)
    q, k, v = (rs.randn(B, H, S, D).astype("float32") for _ in range(3))
    mask = rs.rand(B, H, S, S) < 0.5
    mask[..., np.arange(S), np.arange(S)] = True
    offs = np.concatenate([np.zeros((B, H, 1), "int64"), np.cumsum(
        mask.sum(-1), -1)], -1).astype("int32")
    nnz = int(mask.sum(axis=(-1, -2)).max())
    cols = np.zeros((B, H, nnz), "int32")
    for b in range(B):
        for h in range(H):
            c = np.nonzero(mask[b, h])[1]
            cols[b, h, :len(c)] = c
    out = npy(F.sparse_attention(*(_t(paddle, t) for t in (q, k, v, offs,
                                                           cols))))
    s = np.einsum("bhsd,bhtd->bhst", q, k) / np.sqrt(D)
    s = np.where(mask, s, -1e30)
    pr = np.exp(s - s.max(-1, keepdims=True))
    pr /= pr.sum(-1, keepdims=True)
    np.testing.assert_allclose(out, np.einsum("bhst,bhtd->bhsd", pr, v),
                               rtol=1e-5, atol=1e-6)
    return {"out": out}


def inplace_activations(paddle):
    F = paddle.nn.functional
    res = {}
    for name, args in (("hardtanh_", (-0.5, 0.7)), ("leaky_relu_", (0.2,)),
                       ("tanh_", ()), ("thresholded_relu_", (0.3,))):
        x = _t(paddle, _r((3, 4), 11))
        out = getattr(F, name)(x, *args)
        assert out is x
        res[name] = npy(x)
        want = npy(getattr(F, name[:-1])(_t(paddle, _r((3, 4), 11)), *args))
        np.testing.assert_array_equal(res[name], want)
    return res


def parameter_dict(paddle):
    nn = paddle.nn
    pd = nn.ParameterDict({"a": paddle.create_parameter([2, 3], "float32"),
                           "b": paddle.create_parameter([4], "float32")})
    pd["c"] = paddle.create_parameter([1], "float32")
    pd.update([("d", paddle.create_parameter([2], "float32"))])
    assert len(pd) == 4 and list(pd) == ["a", "b", "c", "d"]
    assert list(pd.keys()) == ["a", "b", "c", "d"]
    assert [list(v.shape) for v in pd.values()] == [[2, 3], [4], [1], [2]]
    assert pd["b"] is dict(pd.items())["b"]
    return {"names": sorted(k for k, _ in pd.named_parameters())}


def class_center_sample(paddle):
    F = paddle.nn.functional
    y = _t(paddle, np.array([2, 5, 5, 9], "int64"))
    remapped, sampled = F.class_center_sample(y, num_classes=20,
                                              num_samples=6)
    s = npy(sampled)
    assert len(s) == 6 and {2, 5, 9} <= set(s.tolist())
    r = npy(remapped)
    assert (r >= 0).all() and (r < 6).all()
    np.testing.assert_array_equal(s[r], npy(y))
    assert (np.diff(s) > 0).all()
    res = {"s": s, "r": r}
    rs = np.random.RandomState(4)
    y2 = rs.randint(0, 50, 30)
    r2, s2 = F.class_center_sample(_t(paddle, y2), 50, 12)
    # more positives than samples: every positive, nothing drawn
    np.testing.assert_array_equal(npy(s2), np.unique(y2))
    res.update(s2=npy(s2), r2=npy(r2))
    return res


BODIES = [pairwise_distance_and_losses, adaptive_log_softmax, max_unpool,
          lp_pool, shuffles_and_pads, rnnt, rnnt_layer, gather_tree, spectral_norm,
          hsigmoid_and_margin_ce, losses_and_distance_layers,
          fractional_pools, sparse_attention, inplace_activations,
          parameter_dict, class_center_sample]


@pytest.fixture(scope="module")
def jax_answers():
    """The JAX package's answers to every body, computed once before the
    tests (``port_bodies.jax_results`` keeps them): the JAX legs' eager
    programs compile per op, which belongs to setup, not to a test's
    call."""
    from port_bodies import jax_results

    return {b: jax_results(b) for b in BODIES}


@PKG
@pytest.mark.parametrize("body", BODIES, ids=[b.__name__ for b in BODIES])
def test_extra_body(on_cpu, jax_answers, body, pkg):
    run(body, pkg, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ law pins
def test_feature_alpha_dropout_law(on_cpu):
    """JAX's body (channel-constant maps on ones, eval the identity), and
    on a SELU-normal input: keep rate within 5 binomial sigmas of 1 - p,
    dropped channels at a·alpha' + b, mean 0 and variance 1 kept within 5
    standard errors."""
    tp = paddle_tpu_torch
    F = tp.nn.functional
    x = tp.to_tensor(np.ones((8, 16, 4, 4), "float32"))
    out = F.feature_alpha_dropout(x, p=0.5, training=True).numpy()
    assert (np.ptp(out.reshape(8, 16, -1), axis=2) < 1e-6).all()
    np.testing.assert_array_equal(
        F.feature_alpha_dropout(x, p=0.5, training=False).numpy(), x.numpy())
    assert F.feature_alpha_dropout(x, p=0.0) is x
    p, n_ch = 0.3, 200 * 64
    z = np.random.default_rng(0).standard_normal((200, 64, 8, 8)).astype(
        np.float32)
    tp.seed(3)
    got = tp.nn.FeatureAlphaDropout(p)(tp.to_tensor(z)).numpy()
    alpha = -1.7580993408473766
    a = ((1 - p) + alpha ** 2 * (1 - p) * p) ** -0.5
    dropped = np.isclose(got, a * alpha + (-a * alpha * p), atol=1e-5).all(
        axis=(2, 3))
    keep = 1 - dropped.mean()
    assert abs(keep - (1 - p)) < 5 * np.sqrt(p * (1 - p) / n_ch)
    assert abs(got.mean()) < 5 * np.sqrt(1 / 200 / 64)
    assert abs(got.var() - 1) < 0.05
    layer = tp.nn.FeatureAlphaDropout(p)
    layer.eval()
    np.testing.assert_array_equal(layer(tp.to_tensor(z)).numpy(), z)


def test_fractional_pool_regions_cover_the_input(on_cpu):
    """For any u, the regions of each axis tile it in order and each
    output is the max of its region (u = 0.5 when none is given)."""
    from paddle_tpu_torch.nn.functional.extra import _fractional_bounds

    for u in (0.0, 0.3, 0.5, 0.99):
        for n_in, n_out in ((9, 4), (11, 5), (7, 7), (6, 3)):
            b = _fractional_bounds(n_in, n_out, u)
            assert b[0] == 0 and b[-1] == n_in and (np.diff(b) >= 0).all()
    x = _r((1, 1, 9, 11), 1)
    got = paddle_tpu_torch.nn.functional.fractional_max_pool2d(
        paddle_tpu_torch.to_tensor(x), [4, 5]).numpy()
    bh, bw = _fractional_bounds(9, 4, 0.5), _fractional_bounds(11, 5, 0.5)
    want = np.array([[x[0, 0, bh[i]:max(bh[i + 1], bh[i] + 1),
                        bw[j]:max(bw[j + 1], bw[j] + 1)].max()
                      for j in range(5)] for i in range(4)])
    np.testing.assert_array_equal(got[0, 0], want)


def test_extra_layers_keep_the_kind_they_are_given(on_cpu):
    """A bare torch tensor in, a torch tensor out (the torch-level models
    call the layers so)."""
    tp = paddle_tpu_torch
    x = torch.from_numpy(_r((2, 4, 4, 4), 2))
    for layer in (tp.nn.Softmax2D(), tp.nn.PixelUnshuffle(2),
                  tp.nn.SpectralNorm([2, 4, 4, 4])):
        out = layer(x)
        assert isinstance(out, torch.Tensor) and not isinstance(
            out, tp.Tensor)


def test_nn_exports_every_name_of_the_jax_package():
    """``paddle_tpu_torch.nn`` and ``.nn.functional`` export every public
    name that ``paddle_tpu.nn`` and ``.nn.functional`` export."""
    def pub(m):
        return {n for n in dir(m) if not n.startswith("_")}

    for jm, tm in ((paddle_tpu.nn, paddle_tpu_torch.nn),
                   (paddle_tpu.nn.functional, paddle_tpu_torch.nn.functional)):
        assert not pub(jm) - set(dir(tm)), sorted(pub(jm) - set(dir(tm)))
        assert set(tm.__all__) <= set(dir(tm))


def _bridge_layers(pkg):
    nn = pkg.nn
    return {"lstm": nn.LSTM(4, 5, num_layers=2, direction="bidirect"),
            "gru": nn.GRU(4, 5, time_major=True),
            "spectral": nn.SpectralNorm([6, 4], dim=1),
            "hsigmoid": nn.HSigmoidLoss(4, 6),
            "alsm": nn.AdaptiveLogSoftmaxWithLoss(8, 10, [3, 6],
                                                  head_bias=True)}


@pytest.mark.parametrize("name", ["lstm", "gru", "spectral", "hsigmoid",
                                  "alsm"])
def test_bridge_carries_the_new_layers_parameters(name, on_cpu):
    """``from_paddle_tpu_state`` loads JAX's numpy state of each new layer
    into the port's by JAX's names (every cell per layer and direction,
    u and v, the tree's weight, the head and tails), and
    ``to_paddle_tpu_state`` gives the same arrays back."""
    from paddle_tpu_torch import from_paddle_tpu_state, to_paddle_tpu_state

    with paddle_tpu.utils.unique_name.guard():
        paddle_tpu.seed(17)
        jl = _bridge_layers(paddle_tpu)[name]
    state = {k: np.asarray(v._value) for k, v in jl.state_dict().items()}
    tl = from_paddle_tpu_state(state, _bridge_layers(paddle_tpu_torch)[name])
    back = to_paddle_tpu_state(tl)
    assert list(back) == list(state)
    for k in state:
        np.testing.assert_array_equal(back[k], state[k], err_msg=k)
    if name == "lstm":
        assert "cells.3.weight_hh" in state and state[
            "cells.3.weight_hh"].shape == (20, 5)
    with pytest.raises(ValueError, match="missing"):
        from_paddle_tpu_state(dict(list(state.items())[1:]),
                              _bridge_layers(paddle_tpu_torch)[name])
