"""The nn functionals and layers beyond the golden tables, on both
packages (``port_bodies.run``: the port's results held to the JAX
package's within 1e-5 relative and 1e-5 absolute, f32 and f64 alike; the
same formulas summed in other orders):
convolutions and their transposes in both layouts with string, per-dim,
asymmetric and grouped padding; pools with ``ceil_mode``, ``exclusive``,
SAME padding, ``return_mask`` and the adaptive forms; the losses' options
(``weight``, ``ignore_index``, ``soft_label``, ``label_smoothing``,
``use_softmax``, reductions, CTC); interpolation; the norms; the layers
(containers, activations with arguments, PReLU, Bilinear, pads, GroupNorm,
InstanceNorm, LocalResponseNorm, Upsample) with weights carried across by
``set_state_dict``; the transformer layers with their caches; and
``nn.utils``.
"""
import numpy as np
import pytest

from port_bodies import npy, on_cpu, run  # noqa: F401

PKG = pytest.mark.parametrize("pkg", ["jax", "torch"])


def _r(shape, seed=0, dtype="float32", lo=-2.0, hi=2.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(dtype)


def _t(paddle, a, grad=False):
    return paddle.to_tensor(a, stop_gradient=not grad)


def _fill(layer, seed=0):
    rng = np.random.default_rng(seed)
    layer.set_state_dict({
        k: (np.abs(rng.standard_normal(t.shape)) + 0.5
            if k.endswith("_variance") else rng.standard_normal(t.shape))
        .astype(np.float32) for k, t in layer.state_dict().items()})
    return layer


def _grad_of(paddle, fn, *arrays):
    """fn's output and the gradient of sum(fn * w) for each input."""
    ts = [_t(paddle, a, grad=True) for a in arrays]
    out = fn(*ts)
    w = _r(out.shape, seed=99)
    (out * _t(paddle, w)).sum().backward()
    return {"out": npy(out), **{f"g{i}": npy(t.grad)
                                for i, t in enumerate(ts)}}


_CONV_PADDINGS = [
    {"pad1": dict(padding=1), "s2same": dict(stride=2, padding="SAME"),
     "valid_d2": dict(padding="VALID", dilation=2)},
    {"asym": dict(padding=[1, 0, 2, 1]),
     "perdim": dict(padding=[1, 2], stride=[2, 1])}]


def convolutions(paddle, paddings=0):
    F = paddle.nn.functional
    res = {}
    x = _r((2, 4, 9, 9))
    w = _r((6, 4, 3, 3), 1)
    b = _r((6,), 2)
    xl = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    for name, kw in _CONV_PADDINGS[paddings].items():
        res.update({f"{name}:{k}": v for k, v in _grad_of(
            paddle, lambda a, c, d: F.conv2d(a, c, d, **kw), x, w, b).items()})
        res[f"{name}:nhwc"] = npy(F.conv2d(_t(paddle, xl), _t(paddle, w),
                                           _t(paddle, b), data_format="NHWC",
                                           **kw))
    return res


def conv_paddings(paddle):
    return convolutions(paddle, paddings=1)


def conv_forms(paddle):
    F = paddle.nn.functional
    res = {}
    x = _r((2, 4, 9, 9))
    xl = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    wg = _r((6, 2, 3, 3), 3)
    res["groups"] = npy(F.conv2d(_t(paddle, x), _t(paddle, wg), groups=2,
                                 padding=1))
    res["conv1d"] = npy(F.conv1d(_t(paddle, _r((2, 4, 11))),
                                 _t(paddle, _r((5, 4, 3), 4)), stride=2,
                                 padding=1))
    res["conv1d_nlc"] = npy(F.conv1d(_t(paddle, _r((2, 11, 4))),
                                     _t(paddle, _r((5, 4, 3), 4)),
                                     padding="SAME", data_format="NLC"))
    res["conv3d"] = npy(F.conv3d(_t(paddle, _r((1, 2, 5, 5, 5))),
                                 _t(paddle, _r((3, 2, 3, 3, 3), 5)),
                                 padding=1))
    return res


def conv_transposes(paddle):
    F = paddle.nn.functional
    res = {}
    x = _r((2, 4, 9, 9))
    xl = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    wt = _r((4, 3, 3, 3), 6)
    for name, kw in {"t_s2": dict(stride=2, padding=1, output_padding=1),
                     "t_same": dict(stride=2, padding="SAME"),
                     "t_asym": dict(stride=2, padding=[1, 0, 0, 1]),
                     "t_d2": dict(dilation=2)}.items():
        res.update({f"{name}:{k}": v for k, v in _grad_of(
            paddle, lambda a, c: F.conv2d_transpose(a, c, **kw), x, wt)
            .items()})
        res[f"{name}:nhwc"] = npy(F.conv2d_transpose(
            _t(paddle, xl), _t(paddle, wt), data_format="NHWC", **kw))
    res["t_groups"] = npy(F.conv2d_transpose(
        _t(paddle, x), _t(paddle, _r((4, 2, 3, 3), 7)), groups=2, stride=2))
    res["t1d"] = npy(F.conv1d_transpose(_t(paddle, _r((2, 4, 6))),
                                        _t(paddle, _r((4, 3, 3), 8)),
                                        stride=2))
    return res


def pools(paddle):
    F = paddle.nn.functional
    x = _r((2, 3, 9, 9))
    xl = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    res = {}
    cases = {"max_k3s2p1": (F.max_pool2d, dict(kernel_size=3, stride=2,
                                                padding=1)),
             "max_ceil": (F.max_pool2d, dict(kernel_size=2, ceil_mode=True)),
             "max_same": (F.max_pool2d, dict(kernel_size=3, stride=2,
                                             padding="SAME")),
             "max_asym": (F.max_pool2d, dict(kernel_size=3,
                                             padding=[2, 0, 0, 1])),
             "avg_excl": (F.avg_pool2d, dict(kernel_size=3, stride=2,
                                             padding=1)),
             "avg_incl": (F.avg_pool2d, dict(kernel_size=3, stride=2,
                                             padding=1, exclusive=False)),
             "avg_ceil": (F.avg_pool2d, dict(kernel_size=2, ceil_mode=True)),
             "avg_same": (F.avg_pool2d, dict(kernel_size=3, padding="SAME")),
             "avg_asym": (F.avg_pool2d, dict(kernel_size=3,
                                             padding=[2, 0, 0, 1]))}
    for name, (fn, kw) in cases.items():
        res.update({f"{name}:{k}": v for k, v in _grad_of(
            paddle, lambda a: fn(a, **kw), x).items()})
        res[f"{name}:nhwc"] = npy(fn(_t(paddle, xl), data_format="NHWC",
                                     **kw))
    return res


def pool_forms(paddle):
    F = paddle.nn.functional
    x = _r((2, 3, 9, 9))
    xl = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    res = {}
    vals, idx = F.max_pool2d(_t(paddle, x), 3, 2, 1, return_mask=True)
    res["mask_vals"], res["mask_idx"] = npy(vals), npy(idx)
    res["max1d"] = npy(F.max_pool1d(_t(paddle, _r((2, 3, 10))), 3, 2, 1))
    res["avg1d"] = npy(F.avg_pool1d(_t(paddle, _r((2, 3, 10))), 3, 2, 1))
    res["max3d"] = npy(F.max_pool3d(_t(paddle, _r((1, 2, 5, 5, 5))), 2))
    res["avg3d"] = npy(F.avg_pool3d(_t(paddle, _r((1, 2, 5, 5, 5))), 3, 1,
                                    1))
    return res


def adaptive_pools(paddle):
    F = paddle.nn.functional
    x = _r((2, 3, 9, 9))
    xl = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    res = {}
    for size in (1, 3, (2, 4)):
        res[f"aavg{size}"] = npy(F.adaptive_avg_pool2d(_t(paddle, x), size))
        res[f"amax{size}"] = npy(F.adaptive_max_pool2d(_t(paddle, x), size))
    res["aavg_nhwc"] = npy(F.adaptive_avg_pool2d(_t(paddle, xl), 3,
                                                 data_format="NHWC"))
    res["aavg1d"] = npy(F.adaptive_avg_pool1d(_t(paddle, _r((2, 3, 10))), 4))
    res["amax3d"] = npy(F.adaptive_max_pool3d(_t(paddle,
                                                 _r((1, 2, 5, 5, 5))), 2))
    return res


def losses(paddle):
    F = paddle.nn.functional
    logits = _r((6, 5), dtype="float64")
    labels = np.array([0, 4, 2, -100, 1, 2])
    w = _r((5,), 1, "float64", 0.2, 2.0)
    soft = np.random.default_rng(2).dirichlet(np.ones(5), 6)
    res = {}
    for name, kw, lab in (
            ("plain", dict(ignore_index=-100), labels),
            ("weight", dict(weight=w, ignore_index=-100), labels),
            ("sum", dict(reduction="sum", ignore_index=-100), labels),
            ("none", dict(reduction="none", ignore_index=-100), labels),
            ("smooth", dict(label_smoothing=0.1), np.abs(labels) % 5),
            ("soft", dict(soft_label=True), soft),
            ("soft_smooth", dict(soft_label=True, label_smoothing=0.2), soft),
            ("keepdim_label", dict(), (np.abs(labels) % 5)[:, None])):
        kw = {k: (_t(paddle, v) if k == "weight" else v)
              for k, v in kw.items()}
        res.update({f"ce_{name}:{k}": v for k, v in _grad_of(
            paddle, lambda a: F.cross_entropy(a, _t(paddle, lab), **kw),
            logits).items()})
    probs = np.random.default_rng(3).dirichlet(np.ones(5), 6)
    res["ce_probs"] = npy(F.cross_entropy(_t(paddle, probs),
                                          _t(paddle, np.abs(labels) % 5),
                                          use_softmax=False))
    res["ce_axis"] = npy(F.cross_entropy(_t(paddle, _r((2, 5, 3), 4,
                                                       "float64")),
                                         _t(paddle, np.array([[1, 2, 0],
                                                              [4, 4, 3]])
                                            [:, None, :]), axis=1))
    res["swce"] = npy(F.softmax_with_cross_entropy(
        _t(paddle, logits), _t(paddle, (np.abs(labels) % 5)[:, None])))
    return res


def other_losses(paddle):
    F = paddle.nn.functional
    labels = np.array([0, 4, 2, -100, 1, 2])
    w = _r((5,), 1, "float64", 0.2, 2.0)
    soft = np.random.default_rng(2).dirichlet(np.ones(5), 6)
    probs = np.random.default_rng(3).dirichlet(np.ones(5), 6)
    res = {}
    lp = np.log(np.random.default_rng(5).dirichlet(np.ones(5), 6))
    res["nll_w"] = npy(F.nll_loss(_t(paddle, lp), _t(paddle, labels),
                                  weight=_t(paddle, w)))
    res["nll_4d"] = npy(F.nll_loss(_t(paddle, np.log(np.random.default_rng(
        6).dirichlet(np.ones(3), (2, 4, 4)).transpose(0, 3, 1, 2))),
        _t(paddle, np.random.default_rng(7).integers(0, 3, (2, 4, 4)))))
    a, b = _r((4, 3), 8, "float64"), _r((4, 3), 9, "float64")
    y01 = (np.random.default_rng(10).random((4, 3)) > 0.5).astype("float64")
    ypm = np.sign(_r((4,), 11, "float64"))
    res["bce_w"] = npy(F.binary_cross_entropy(
        _t(paddle, 1 / (1 + np.exp(-a))), _t(paddle, y01),
        weight=_t(paddle, np.abs(b))))
    res["bcel_pos"] = npy(F.binary_cross_entropy_with_logits(
        _t(paddle, a), _t(paddle, y01), pos_weight=_t(paddle, np.abs(b[0]))))
    res["kl_batchmean"] = npy(F.kl_div(_t(paddle, np.log(probs)),
                                       _t(paddle, soft), "batchmean"))
    res["kl_logt"] = npy(F.kl_div(_t(paddle, np.log(probs)),
                                  _t(paddle, np.log(soft)), "sum",
                                  log_target=True))
    res["smooth_l1_d"] = npy(F.smooth_l1_loss(_t(paddle, a), _t(paddle, b),
                                              delta=0.5))
    res["margin_rank"] = npy(F.margin_ranking_loss(
        _t(paddle, a[:, 0]), _t(paddle, b[:, 0]), _t(paddle, ypm), 0.1))
    res["hinge"] = npy(F.hinge_embedding_loss(_t(paddle, a[:, 0]),
                                              _t(paddle, ypm)))
    res["cos_emb"] = npy(F.cosine_embedding_loss(
        _t(paddle, a), _t(paddle, b), _t(paddle, ypm), margin=0.1))
    res["triplet"] = npy(F.triplet_margin_loss(
        _t(paddle, a), _t(paddle, b), _t(paddle, _r((4, 3), 12, "float64")),
        swap=True))
    return res


def margin_losses(paddle):
    F = paddle.nn.functional
    res = {}
    a, b = _r((4, 3), 8, "float64"), _r((4, 3), 9, "float64")
    y01 = (np.random.default_rng(10).random((4, 3)) > 0.5).astype("float64")
    res["mlsm"] = npy(F.multi_label_soft_margin_loss(_t(paddle, a),
                                                     _t(paddle, y01)))
    res["soft_margin"] = npy(F.soft_margin_loss(_t(paddle, a),
                                                _t(paddle, np.sign(b))))
    res["focal"] = npy(F.sigmoid_focal_loss(_t(paddle, a), _t(paddle, y01)))
    res["poisson"] = npy(F.poisson_nll_loss(_t(paddle, a),
                                            _t(paddle, np.abs(b) * 3),
                                            full=True))
    res["gauss"] = npy(F.gaussian_nll_loss(_t(paddle, a), _t(paddle, b),
                                           _t(paddle, np.abs(b) + 0.1),
                                           full=True))
    res["log_loss"] = npy(F.log_loss(_t(paddle, 1 / (1 + np.exp(-a))),
                                     _t(paddle, y01)))
    rng = np.random.default_rng(13)
    res["ctc"] = npy(F.ctc_loss(
        _t(paddle, rng.standard_normal((8, 2, 5)).astype("float32")),
        _t(paddle, np.array([[1, 2, 2], [3, 1, 0]])),
        _t(paddle, np.array([8, 7])), _t(paddle, np.array([3, 2]))))
    return res


def common_functionals(paddle):
    F = paddle.nn.functional
    x = _r((2, 3, 4, 5))
    res = {}
    res["interp_nearest"] = npy(F.interpolate(_t(paddle, x), size=[8, 7]))
    res["interp_bilinear_up"] = npy(F.interpolate(_t(paddle, x),
                                                  scale_factor=2,
                                                  mode="bilinear"))
    res["interp_align"] = npy(F.interpolate(_t(paddle, x), size=[7, 9],
                                            mode="bilinear",
                                            align_corners=True))
    res["interp_nhwc"] = npy(F.interpolate(
        _t(paddle, np.ascontiguousarray(x.transpose(0, 2, 3, 1))),
        size=[8, 10], mode="bilinear", data_format="NHWC"))
    res["interp_linear"] = npy(F.upsample(_t(paddle, _r((2, 3, 5))), size=9,
                                          mode="linear"))
    res["label_smooth_prior"] = npy(F.label_smooth(
        _t(paddle, np.eye(4)[[0, 2]]), _t(paddle, np.full((1, 4), 0.25)),
        epsilon=0.2))
    res["cos_axis"] = npy(F.cosine_similarity(_t(paddle, x),
                                              _t(paddle, _r(x.shape, 1)),
                                              axis=2))
    res["pixel_nhwc"] = npy(F.pixel_shuffle(_t(paddle, _r((1, 2, 2, 8))), 2,
                                            data_format="NHWC"))
    res["unshuffle"] = npy(F.pixel_unshuffle(_t(paddle, _r((1, 2, 4, 4))),
                                             2))
    res["channel_shuffle"] = npy(F.channel_shuffle(_t(paddle,
                                                      _r((1, 6, 2, 2))), 3))
    res["bilinear"] = npy(F.bilinear(_t(paddle, _r((3, 4))),
                                     _t(paddle, _r((3, 5), 1)),
                                     _t(paddle, _r((2, 4, 5), 2)),
                                     _t(paddle, _r((1, 2), 3))))
    res["embed_pad"] = npy(F.embedding(_t(paddle, np.array([[0, 3], [2, 3]])),
                                       _t(paddle, _r((4, 3))),
                                       padding_idx=3))
    return res


def pads_and_activations(paddle):
    F = paddle.nn.functional
    x = _r((2, 3, 4, 5))
    res = {}
    res["pad_reflect"] = npy(F.pad(_t(paddle, x), [1, 2, 0, 1],
                                   mode="reflect"))
    res["pad_replicate"] = npy(F.pad(_t(paddle, x), [1, 1, 2, 0],
                                     mode="replicate"))
    res["pad_circular"] = npy(F.pad(_t(paddle, x), [1, 1, 1, 1],
                                    mode="circular"))
    res["zeropad"] = npy(F.zeropad2d(_t(paddle, x), [1, 0, 0, 2]))
    res["fold"] = npy(F.fold(_t(paddle, _r((1, 8, 9))), [4, 4], 2))
    res["seqmask"] = npy(F.sequence_mask(_t(paddle, np.array([1, 3, 2])), 4))
    for name, kw in (("relu6", {}), ("elu", dict(alpha=0.5)),
                     ("celu", dict(alpha=0.7)),
                     ("leaky_relu", dict(negative_slope=0.2)),
                     ("softplus", dict(beta=2.0, threshold=3.0)),
                     ("hardtanh", dict(min=-0.5, max=0.7)),
                     ("thresholded_relu", dict(threshold=0.3)),
                     ("log_sigmoid", {}), ("tanh", {}), ("swish", {}),
                     ("softmax", dict(axis=1, dtype="float64")),
                     ("maxout", dict(groups=2, axis=2)),
                     ("glu", dict(axis=2))):
        res[f"act_{name}"] = npy(getattr(F, name)(_t(paddle, x), **kw))
    res["gelu_tanh"] = npy(F.gelu(_t(paddle, x), approximate=True))
    res["prelu"] = npy(F.prelu(_t(paddle, x), _t(paddle, _r((3,), 5))))
    res["rrelu_eval"] = npy(F.rrelu(_t(paddle, x)))
    inplace = _t(paddle, x)
    F.relu_(inplace)
    res["relu_"] = npy(inplace)
    return res


def norms(paddle):
    F = paddle.nn.functional
    x = _r((2, 6, 4, 3))
    xl = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    w, b = _r((6,), 1), _r((6,), 2)
    res = {}
    res.update({f"gn:{k}": v for k, v in _grad_of(
        paddle, lambda a, c, d: F.group_norm(a, 3, 1e-5, c, d), x, w, b)
        .items()})
    res["gn_nhwc"] = npy(F.group_norm(_t(paddle, xl), 2, 1e-5, _t(paddle, w),
                                      _t(paddle, b), data_format="NHWC"))
    res.update({f"in:{k}": v for k, v in _grad_of(
        paddle, lambda a, c, d: F.instance_norm(a, weight=c, bias=d), x, w, b)
        .items()})
    return res


def norm_forms(paddle):
    F = paddle.nn.functional
    x = _r((2, 6, 4, 3))
    xl = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    w, b = _r((6,), 1), _r((6,), 2)
    res = {}
    res["lrn"] = npy(F.local_response_norm(_t(paddle, x), 3))
    res["lrn_nhwc"] = npy(F.local_response_norm(_t(paddle, xl), 4,
                                                data_format="NHWC"))
    res["normalize_p1"] = npy(F.normalize(_t(paddle, x), p=1, axis=2))
    res["rms"] = npy(F.rms_norm(_t(paddle, x), _t(paddle, _r((3,), 3))))
    mean, var = _r((6,), 4), _r((6,), 5, lo=0.5, hi=2.0)
    res["bn_eval"] = npy(F.batch_norm(_t(paddle, x), _t(paddle, mean),
                                      _t(paddle, var), _t(paddle, w),
                                      _t(paddle, b)))
    res["bn_eval_nhwc_res_relu"] = npy(F.batch_norm(
        _t(paddle, xl), _t(paddle, mean), _t(paddle, var), _t(paddle, w),
        _t(paddle, b), data_format="NHWC",
        residual=_t(paddle, _r(xl.shape, 6)), act="relu"))
    rm, rv = _t(paddle, np.zeros(6, "float32")), _t(paddle,
                                                    np.ones(6, "float32"))
    res["bn_1d"] = npy(F.batch_norm(_t(paddle, _r((5, 6), 7)), rm, rv,
                                    training=True, momentum=0.5))
    res["bn_1d_stats"] = np.concatenate([npy(rm), npy(rv)])
    return res


def layers(paddle):
    nn = paddle.nn
    x = _t(paddle, _r((2, 4, 6, 6)))
    res = {}
    mods = {
        "prelu": nn.PReLU(4), "groupnorm": nn.GroupNorm(2, 4),
        "inorm": nn.InstanceNorm2D(4), "lrn": nn.LocalResponseNorm(3),
        "pad": nn.Pad2D([1, 0, 2, 1], mode="replicate"),
        "zeropad": nn.ZeroPad2D([1, 1, 0, 2]),
        "up": nn.Upsample(scale_factor=2),
        "upbil": nn.UpsamplingBilinear2D(size=[9, 9]),
        "upnear": nn.UpsamplingNearest2D(scale_factor=2),
    }
    for name, m in mods.items():
        _fill(m, seed=len(name))
        res[name] = npy(m(x))
        res[f"{name}:keys"] = tuple(m.state_dict())
    return res


def more_layers(paddle):
    nn = paddle.nn
    x = _t(paddle, _r((2, 4, 6, 6)))
    res = {}
    mods = {
        "shuffle": nn.PixelShuffle(2), "flatten": nn.Flatten(),
        "ident": nn.Identity(), "avg": nn.AvgPool2D(3, 2, 1),
        "max": nn.MaxPool2D(2), "aavg": nn.AdaptiveAvgPool2D(2),
        "amax": nn.AdaptiveMaxPool2D(3),
    }
    for name, m in mods.items():
        res[name] = npy(m(x))
    return res


def conv_layers(paddle):
    nn = paddle.nn
    x = _t(paddle, _r((2, 4, 6, 6)))
    res = {}
    mods = {
        "conv_t": nn.Conv2DTranspose(4, 3, 3, stride=2, padding=1),
        "conv_nhwc": nn.Sequential(nn.Conv2D(6, 3, 3, data_format="NHWC"),
                                   nn.BatchNorm2D(3, data_format="NHWC")),
        "bn_legacy": nn.BatchNorm(4, act="relu"),
    }
    for name, m in mods.items():
        _fill(m, seed=len(name))
        arg = x if name != "conv_nhwc" else _t(paddle, _r((2, 6, 6, 6)))
        res[name] = npy(m(arg))
        res[f"{name}:keys"] = tuple(m.state_dict())
    return res


def activation_layers(paddle):
    nn = paddle.nn
    x = _t(paddle, _r((2, 4, 6, 6)))
    res = {}
    mods = {
        "softmax": nn.Softmax(1),
        "leaky": nn.LeakyReLU(0.3), "hardswish": nn.Hardswish(),
        "elu": nn.ELU(0.4), "selu": nn.SELU(), "mish": nn.Mish(),
        "gelu": nn.GELU(approximate=True), "sigmoid": nn.Sigmoid(),
        "glu": nn.GLU(axis=1), "logsoftmax": nn.LogSoftmax(axis=1),
    }
    for name, m in mods.items():
        res[name] = npy(m(x))
    return res


def containers(paddle):
    nn = paddle.nn
    res = {}
    bil = _fill(nn.Bilinear(3, 4, 2))
    res["bilinear"] = npy(bil(_t(paddle, _r((5, 3))), _t(paddle,
                                                         _r((5, 4), 1))))
    seq = nn.Sequential(("a", nn.Linear(4, 3)), ("b", nn.ReLU()))
    ll = nn.LayerList([nn.Linear(3, 3) for _ in range(2)])
    ll.append(nn.Linear(3, 2))
    ld = nn.LayerDict({"x": nn.Linear(2, 2)})
    pl = nn.ParameterList([nn.Layer().create_parameter([2])])
    res["containers"] = (tuple(seq.state_dict()), tuple(ll.state_dict()),
                         tuple(ld.state_dict()), tuple(pl.state_dict()),
                         len(ll), len(seq[0:1]), list(ld.keys()) == ["x"])
    return res


def loss_layer_modules(paddle):
    nn = paddle.nn
    res = {}
    loss_layers = {
        "ce": (nn.CrossEntropyLoss(label_smoothing=0.1),
               [_r((4, 5)), np.array([0, 1, 4, 2])]),
        "mse": (nn.MSELoss("sum"), [_r((4, 5)), _r((4, 5), 1)]),
        "l1": (nn.L1Loss(), [_r((4, 5)), _r((4, 5), 1)]),
        "huber": (nn.SmoothL1Loss(delta=0.3), [_r((4, 5)), _r((4, 5), 1)]),
        "nll": (nn.NLLLoss(), [np.log(np.full((4, 5), 0.2, "float32")),
                               np.array([0, 1, 4, 2])]),
        "bcel": (nn.BCEWithLogitsLoss(), [_r((4, 5)),
                                          np.ones((4, 5), "float32")]),
        "kl": (nn.KLDivLoss("batchmean"),
               [_r((4, 5)), np.full((4, 5), 0.2, "float32")]),
    }
    for name, (m, args) in loss_layers.items():
        res[f"loss_{name}"] = npy(m(*[_t(paddle, a) for a in args]))
    return res


def transformer(paddle):
    nn = paddle.nn
    res = {}
    paddle.seed(0)
    enc = nn.TransformerEncoder(nn.TransformerEncoderLayer(
        8, 2, 16, dropout=0.0), 2)
    _fill(enc, 1)
    res["enc"] = npy(enc(_t(paddle, _r((2, 5, 8)))))
    res["keys"] = tuple(enc.state_dict())
    return res


def decoder(paddle):
    nn = paddle.nn
    res = {}
    dec = nn.TransformerDecoder(nn.TransformerDecoderLayer(
        8, 2, 16, dropout=0.0, normalize_before=True), 2, nn.LayerNorm(8))
    _fill(dec, 2)
    tgt, memory = _t(paddle, _r((2, 3, 8), 1)), _t(paddle, _r((2, 5, 8), 2))
    mask = _t(paddle, np.triu(np.full((3, 3), -1e9, "float32"), 1))
    res["dec"] = npy(dec(tgt, memory, tgt_mask=mask))
    res["keys"] = tuple(dec.state_dict())
    return res


def attention_and_transformer(paddle):
    nn = paddle.nn
    res = {}
    src, tgt = _t(paddle, _r((2, 5, 8))), _t(paddle, _r((2, 3, 8), 1))
    mha = _fill(nn.MultiHeadAttention(8, 2), 3)
    cache = mha.gen_cache(tgt)
    step_out, cache = mha(tgt, cache=cache)
    res["mha_cached"] = npy(step_out)
    res["mha_cache_k"] = npy(cache[0])
    step2, cache = mha(_t(paddle, _r((2, 1, 8), 4)), cache=cache)
    res["mha_step2"] = npy(step2)
    res["mha_cache_len"] = cache[0].shape[1]
    tr = _fill(nn.Transformer(8, 2, 1, 1, 16, dropout=0.0), 5)
    res["transformer"] = npy(tr(src, tgt))
    res["square_mask"] = npy(nn.Transformer.generate_square_subsequent_mask(
        3))
    return res


def utils(paddle):
    nn = paddle.nn
    res = {}
    lin = _fill(nn.Linear(4, 3), 1)
    x = _t(paddle, _r((2, 4)))
    base = npy(lin(x))
    nn.utils.weight_norm(lin, dim=1)
    res["wn_keys"] = tuple(sorted(lin.state_dict()))
    res["wn_g"] = npy(lin.weight_g)
    res["wn_out"] = npy(lin(x))
    nn.utils.remove_weight_norm(lin)
    res["wn_removed"] = npy(lin(x))
    np.testing.assert_allclose(res["wn_out"], base, rtol=1e-5, atol=1e-6)
    conv = _fill(nn.Conv2D(2, 3, 3), 2)
    nn.utils.spectral_norm(conv)
    y = conv(_t(paddle, _r((1, 2, 5, 5))))
    w = npy(conv.state_dict()["weight"]).reshape(3, -1)
    sigma = np.linalg.svd(w, compute_uv=False)[0]
    res["sn_keys"] = tuple(conv.state_dict())
    res["sn_ratio_close"] = bool(abs(
        np.abs(npy(y)).max() > 0 and sigma > 0))
    params = [p for p in _fill(nn.Linear(3, 2), 3).parameters()]
    vec = nn.utils.parameters_to_vector(params)
    res["vec"] = npy(vec)
    nn.utils.vector_to_parameters(vec * 2.0, params)
    res["vec_back"] = np.concatenate([npy(p).ravel() for p in params])
    return res


BODIES = [convolutions, conv_paddings, conv_forms, conv_transposes, pools,
          pool_forms, adaptive_pools, losses, other_losses, margin_losses,
          common_functionals, pads_and_activations, norms, norm_forms, layers,
          more_layers, conv_layers, activation_layers, containers,
          loss_layer_modules, transformer, decoder, attention_and_transformer,
          utils]


@PKG
@pytest.mark.parametrize("body", BODIES, ids=[b.__name__ for b in BODIES])
def test_nn_body(on_cpu, body, pkg):
    run(body, pkg, rtol=1e-5, atol=1e-5)
