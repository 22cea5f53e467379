"""ASP (``incubate.asp``) of the port against the JAX package on the CPU:
``tests/test_incubate_sparse_quant.py``'s ASP bodies on both packages with
the same weights: the masks (compared exactly: no ties among random
magnitudes), the pruned weights, the density, the 2:4 pattern kept by a
decorated optimizer's step (weights after the step within 1e-6 of JAX's),
the excluded layers, and the raises (another mask algorithm; a decorated
optimizer under ``TrainStep``, whose masks JAX's step drops: ROADMAP C).
"""
import numpy as np
import pytest

import paddle_tpu_torch
from port_bodies import npy, on_cpu, run  # noqa: F401

PKG = pytest.mark.parametrize("pkg", ["jax", "torch"])


def _model(P):
    nn = P.nn
    model = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))
    rng = np.random.default_rng(0)
    model.set_state_dict({k: rng.standard_normal(tuple(v.shape))
                          .astype("float32")
                          for k, v in sorted(model.state_dict().items())})
    return model


def _prune_body(P):
    asp = P.incubate.asp
    model = _model(P)
    opt = asp.decorate(P.optimizer.SGD(learning_rate=0.1,
                                       parameters=model.parameters()))
    masks = asp.prune_model(model, n=2, m=4)
    assert sorted(masks) == ["0.weight", "2.weight"]
    out = {f"mask_{k}": np.asarray(v) for k, v in masks.items()}
    for i in (0, 2):
        w = npy(model[i].weight)
        assert asp.check_sparsity(w, n=2, m=4)
        assert abs(asp.calculate_density(model[i].weight) - 0.5) < 1e-6
        out[f"pruned_{i}"] = w.copy()
    rs = np.random.RandomState(0)
    x = P.to_tensor(rs.randn(4, 8).astype("float32"))
    y = P.to_tensor(np.random.RandomState(1).randn(4, 4).astype("float32"))
    ((model(x) - y) ** 2).mean().backward()
    opt.step()
    opt.clear_grad()
    for i in (0, 2):
        w = npy(model[i].weight)
        assert asp.check_sparsity(w, n=2, m=4)
        out[f"stepped_{i}"] = w.copy()
    assert not asp.check_sparsity(np.ones((2, 4)), n=2, m=4)
    assert not asp.check_sparsity(np.ones(6), n=2, m=4)
    return out


@PKG
def test_asp_prune_and_guarantee(pkg, on_cpu):
    run(_prune_body, pkg, rtol=1e-6, atol=1e-7)


def _excluded_body(P):
    asp = P.incubate.asp
    model = P.nn.Sequential(P.nn.Linear(8, 8))
    asp.set_excluded_layers(["0.weight"])
    try:
        masks = asp.prune_model(model)
        assert "0.weight" not in masks
        assert asp.calculate_density(model[0].weight) == 1.0
    finally:
        asp.reset_excluded_layers()
    masks = asp.prune_model(model, with_mask=False)
    return {"names": ",".join(sorted(masks)),
            "density": asp.calculate_density(model[0].weight)}


@PKG
def test_asp_excluded_layers(pkg, on_cpu):
    run(_excluded_body, pkg)


def test_asp_raises(on_cpu):
    from paddle_tpu_torch.jit import TrainStep

    P = paddle_tpu_torch
    asp = P.incubate.asp
    model = _model(P)
    with pytest.raises(NotImplementedError, match="mask_2d_greedy"):
        asp.prune_model(model, mask_algo="mask_2d_greedy")
    opt = asp.decorate(P.optimizer.SGD(0.1, parameters=model.parameters()))
    with pytest.raises(NotImplementedError,
                       match="OptimizerWithSparsityGuarantee"):
        TrainStep(model, lambda o, y: ((o - y) ** 2).mean(), opt)
    assert opt.get_lr() == 0.1          # the rest forwards to the inner one
