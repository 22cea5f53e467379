"""The incubate tail and ``geometric`` of the port against the JAX package
on the CPU: ``identity_loss``, both ``softmax_mask_fuse`` forms,
``graph_send_recv`` and ``tests/test_geometric.py``'s bodies on both
packages (values within 1e-6, gradients too); ``LookAhead`` and
``ModelAverage`` over eager steps equal to JAX's on the same weights and
batches (1e-6 relative: the same f32 updates); the raises of the arguments
JAX accepts and never reads and of the optimizer wrappers under
``TrainStep`` (ROADMAP C). Sampling: JAX draws from an unseeded generator,
so the port's samples are held to invariants (counts, membership, no
repeats, a seed repeats its draw) and to a chi-square pin of the weighted
sampler's frequencies (p > 1e-4 over 4000 draws), never to JAX's samples.
"""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from port_bodies import npy, on_cpu, run  # noqa: F401

PKG = pytest.mark.parametrize("pkg", ["jax", "torch"])
TOL = dict(rtol=1e-6, atol=1e-6)

SRC = np.array([0, 1, 2, 0], "int64")
DST = np.array([1, 2, 1, 0], "int64")
X = np.array([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]], "float32")


# ------------------------------------------------------------- geometric
def _send_u_recv_body(P):
    G, T = P.geometric, P.to_tensor
    out = {}
    for pool in ("sum", "mean", "max", "min"):
        out[pool] = npy(G.send_u_recv(T(X), T(SRC), T(DST), pool))
    want = np.zeros_like(X)
    for s, d in zip(SRC, DST):
        want[d] += X[s]
    np.testing.assert_allclose(out["sum"], want)
    np.testing.assert_allclose(out["mean"][1], (X[0] + X[2]) / 2)
    np.testing.assert_allclose(out["max"][1], np.maximum(X[0], X[2]))
    ints = G.send_u_recv(T(X.astype("int32")), T(SRC), T(DST), "max",
                         out_size=5)
    out["int_max"] = npy(ints)
    out["int_dtype"] = str(npy(ints).dtype)
    out["graph_send_recv"] = npy(P.incubate.graph_send_recv(
        T(X), T(SRC), T(DST), pool_type="mean"))
    return out


@PKG
def test_send_u_recv_sum_mean_max_min(pkg, on_cpu):
    run(_send_u_recv_body, pkg, **TOL)


def _grad_body(P):
    G = P.geometric
    t = P.to_tensor(X.copy(), stop_gradient=False)
    out = G.send_u_recv(t, P.to_tensor(SRC), P.to_tensor(DST), "sum",
                        out_size=5)
    assert tuple(out.shape) == (5, 2)
    (out * out).sum().backward()
    g = npy(t.grad)
    return {"g": g}


@PKG
def test_send_u_recv_out_size_and_grad(pkg, on_cpu):
    run(_grad_body, pkg, **TOL)


def _ue_uv_body(P):
    G, T = P.geometric, P.to_tensor
    E = np.array([[0.1, 0.1], [0.2, 0.2], [0.3, 0.3], [0.4, 0.4]],
                 "float32")
    out = {}
    for op in ("add", "sub", "mul", "div"):
        out["ue_" + op] = npy(G.send_ue_recv(T(X), T(E), T(SRC), T(DST), op,
                                             "sum"))
        out["uv_" + op] = npy(G.send_uv(T(X), T(X), T(SRC), T(DST), op))
    want = np.zeros_like(X)
    for i, (s, d) in enumerate(zip(SRC, DST)):
        want[d] += X[s] + E[i]
    np.testing.assert_allclose(out["ue_add"], want, rtol=1e-6)
    np.testing.assert_allclose(out["uv_add"], X[SRC] + X[DST])
    return out


@PKG
def test_send_ue_recv_and_send_uv(pkg, on_cpu):
    run(_ue_uv_body, pkg, **TOL)


def _segment_body(P):
    G, T = P.geometric, P.to_tensor
    data = np.array([[1.0], [2.0], [3.0], [4.0], [-1.0]], "float32")
    seg = np.array([0, 0, 1, 1, 3], "int64")
    out = {n: npy(getattr(G, f"segment_{n}")(T(data), T(seg)))
           for n in ("sum", "mean", "max", "min")}
    np.testing.assert_allclose(out["sum"][:2], [[3.0], [7.0]])
    np.testing.assert_allclose(out["max"][2], [0.0])     # empty segment
    for n in ("sum", "mean", "max", "min"):
        out["inc_" + n] = npy(getattr(P.incubate, f"segment_{n}")(
            T(data), T(seg)))
    return out


@PKG
def test_segment_ops(pkg, on_cpu):
    run(_segment_body, pkg, **TOL)


def _reindex_body(P):
    G, T = P.geometric, P.to_tensor
    x = np.array([0, 5, 9], "int64")
    neigh = np.array([5, 7, 9, 3, 7], "int64")
    count = np.array([2, 1, 2], "int64")
    src, dst, nodes = G.reindex_graph(T(x), T(neigh), T(count))
    hs, hd, hn = G.reindex_heter_graph(
        T(x), [T(neigh), T(np.array([4, 0], "int64"))],
        [T(count), T(np.array([1, 0, 1], "int64"))])
    a, b, c = P.incubate.graph_reindex(T(x), T(neigh), T(count))
    return {"src": npy(src), "dst": npy(dst), "nodes": npy(nodes),
            "hs": npy(hs), "hd": npy(hd), "hn": npy(hn), "a": npy(a),
            "b": npy(b), "c": npy(c)}


@PKG
def test_reindex_graph_and_heter(pkg, on_cpu):
    run(_reindex_body, pkg)


# CSC graph: node n's neighbours are row[colptr[n]:colptr[n + 1]]
ROW = np.array([1, 2, 3, 0, 2, 0, 1, 3, 4, 2], "int64")
COLPTR = np.array([0, 3, 5, 9, 10, 10], "int64")


def test_sample_neighbors_invariants(on_cpu):
    G, T = paddle_tpu_torch.geometric, paddle_tpu_torch.to_tensor
    nodes = np.array([0, 2, 3, 4], "int64")
    eids = np.arange(10, dtype="int64") * 10
    neigh, cnt, e = G.sample_neighbors(T(ROW), T(COLPTR), T(nodes),
                                       sample_size=2, eids=T(eids),
                                       return_eids=True, seed=3)
    assert npy(cnt).tolist() == [2, 2, 1, 0]
    off = 0
    for n, c in zip(nodes, npy(cnt)):
        picked = npy(neigh)[off:off + c]
        full = ROW[COLPTR[n]:COLPTR[n + 1]]
        assert set(picked) <= set(full) and len(set(picked)) == c
        assert set(npy(e)[off:off + c] // 10) <= set(
            range(COLPTR[n], COLPTR[n + 1]))
        off += c
    again = G.sample_neighbors(T(ROW), T(COLPTR), T(nodes), sample_size=2,
                               seed=3)[0]
    np.testing.assert_array_equal(npy(again), npy(neigh))
    everything = G.sample_neighbors(T(ROW), T(COLPTR), T(nodes))[0]
    np.testing.assert_array_equal(
        npy(everything), np.concatenate([ROW[COLPTR[n]:COLPTR[n + 1]]
                                         for n in nodes]))
    # JAX's own sampler: the same invariants, its draws its own
    jn, jc = paddle_tpu.geometric.sample_neighbors(
        paddle_tpu.to_tensor(ROW), paddle_tpu.to_tensor(COLPTR),
        paddle_tpu.to_tensor(nodes), sample_size=2)
    assert npy(jc).tolist() == [2, 2, 1, 0]


def test_weighted_sampling_chi_square_pin(on_cpu):
    from scipy.stats import chisquare

    G, T = paddle_tpu_torch.geometric, paddle_tpu_torch.to_tensor
    row = np.array([0, 1, 2, 3], "int64")
    colptr = np.array([0, 4], "int64")
    w = np.array([1.0, 2.0, 3.0, 4.0], "float32")
    rng = np.random.default_rng(7)
    counts = np.zeros(4)
    n = 4000
    for _ in range(n):
        nb, _ = G.weighted_sample_neighbors(T(row), T(colptr), T(w),
                                            T(np.array([0])), sample_size=1,
                                            seed=rng)
        counts[int(npy(nb)[0])] += 1
    assert chisquare(counts, n * w / w.sum()).pvalue > 1e-4


def test_graph_khop_sampler(on_cpu):
    inc, T = paddle_tpu_torch.incubate, paddle_tpu_torch.to_tensor
    nodes = np.array([0, 2], "int64")
    neigh, cnt, uniq, src = inc.graph_khop_sampler(
        T(ROW), T(COLPTR), T(nodes), [2], seed=0)
    assert npy(cnt).tolist() == [2, 2]
    assert npy(uniq)[:2].tolist() == [0, 2]
    np.testing.assert_array_equal(npy(uniq)[npy(src)], npy(neigh))
    with pytest.raises(NotImplementedError, match="sorted_eids"):
        inc.graph_khop_sampler(T(ROW), T(COLPTR), T(nodes), [2],
                               sorted_eids=T(ROW))


# ------------------------------------------------------------- the tail
def _tail_body(P):
    inc, T = P.incubate, P.to_tensor
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 5, 5)).astype("float32")
    m = np.where(rng.random((2, 1, 5, 5)) > 0.3, 0.0, -1e4).astype(
        "float32")
    out = {"fuse": npy(inc.softmax_mask_fuse(T(x), T(m))),
           "upper": npy(inc.softmax_mask_fuse_upper_triangle(T(x)))}
    assert np.allclose(np.triu(out["upper"][0, 0], 1), 0.0)
    for r in (0, 1, 2, "sum", "mean", "none"):
        out[f"id_{r}"] = npy(inc.identity_loss(T(x), reduction=r))
    return out


@PKG
def test_identity_loss_and_softmax_mask_fuse(pkg, on_cpu):
    run(_tail_body, pkg, **TOL)


def _mlp(P):
    nn = P.nn
    net = nn.Sequential(nn.Linear(6, 8), nn.Tanh(), nn.Linear(8, 3))
    rng = np.random.default_rng(1)
    net.set_state_dict({k: (rng.standard_normal(tuple(v.shape)) * 0.4)
                        .astype("float32")
                        for k, v in sorted(net.state_dict().items())})
    return net


def _batches(P, n=4):
    rng = np.random.default_rng(2)
    return [(P.to_tensor(rng.standard_normal((4, 6)).astype("float32")),
             P.to_tensor(rng.standard_normal((4, 3)).astype("float32")))
            for _ in range(n)]


def _lookahead_body(P):
    net = _mlp(P)
    inner = P.optimizer.SGD(0.1, parameters=net.parameters())
    opt = P.incubate.LookAhead(inner, alpha=0.5, k=2)
    out = {}
    for i, (x, y) in enumerate(_batches(P)):
        loss = ((net(x) - y) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        out[f"w{i}"] = npy(net[0].weight).copy()   # the port's shares
        # the parameter's storage, which the next step writes
    assert opt._lk_step == 4
    return out


@PKG
def test_lookahead_over_four_steps(pkg, on_cpu):
    run(_lookahead_body, pkg, rtol=1e-6, atol=1e-7)


def test_lookahead_equals_a_hand_loop(on_cpu):
    """k = 2: the first sync stores the slow weights only; the second
    pulls the fast ones back halfway to them."""
    P = paddle_tpu_torch
    net, ref = _mlp(P), _mlp(P)
    opt = P.incubate.LookAhead(P.optimizer.SGD(0.1,
                                               parameters=net.parameters()),
                               alpha=0.5, k=2)
    sgd = P.optimizer.SGD(0.1, parameters=ref.parameters())
    slow = None
    for i, (x, y) in enumerate(_batches(P)):
        for model, o in ((net, opt), (ref, sgd)):
            ((model(x) - y) ** 2).mean().backward()
            o.step()
            o.clear_grad()
        if i == 1:
            slow = [p._value.detach().clone() for p in ref.parameters()]
        if i == 3:
            with torch.no_grad():
                for p, s in zip(ref.parameters(), slow):
                    p._value.copy_(s + 0.5 * (p._value - s))
        for a, b in zip(net.parameters(), ref.parameters()):
            assert torch.equal(a._value, b._value)


def _model_average_body(P):
    net = _mlp(P)
    sgd = P.optimizer.SGD(0.1, parameters=net.parameters())
    avg = P.incubate.ModelAverage(parameters=net.parameters())
    seen = []
    for x, y in _batches(P):
        ((net(x) - y) ** 2).mean().backward()
        sgd.step()
        sgd.clear_grad()
        avg.step()
        seen.append(npy(net[0].weight).copy())
    live = npy(net[0].weight).copy()
    avg.apply()
    applied = npy(net[0].weight).copy()
    np.testing.assert_allclose(applied, np.mean(seen, axis=0), rtol=1e-6,
                               atol=1e-7)
    avg.restore()
    np.testing.assert_array_equal(npy(net[0].weight), live)
    return {"applied": applied, "live": live}


@PKG
def test_model_average_apply_restore(pkg, on_cpu):
    run(_model_average_body, pkg, rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------- the raises
def test_wrappers_under_train_step_raise(on_cpu):
    """JAX's TrainStep raises for LookAhead and ModelAverage (their
    ``_update`` is the base class's) and runs an ASP-decorated optimizer's
    inner update without the masks; the port raises for all three."""
    from paddle_tpu_torch.incubate import asp
    from paddle_tpu_torch.jit import TrainStep

    P = paddle_tpu_torch
    net = _mlp(P)
    loss = torch.nn.functional.mse_loss
    for opt in (P.incubate.LookAhead(P.optimizer.SGD(
                    0.1, parameters=net.parameters())),
                P.incubate.ModelAverage(parameters=net.parameters()),
                asp.decorate(P.optimizer.SGD(0.1,
                                             parameters=net.parameters()))):
        name = type(opt).__name__
        with pytest.raises(NotImplementedError, match=name):
            TrainStep(net, loss, opt)


def test_unread_arguments_raise(on_cpu):
    P = paddle_tpu_torch
    inc = P.incubate
    with pytest.raises(NotImplementedError, match="average_window_rate"):
        inc.ModelAverage(0.3, parameters=_mlp(P).parameters())
    with pytest.raises(NotImplementedError, match="max_average_window"):
        inc.ModelAverage(parameters=_mlp(P).parameters(),
                         max_average_window=5)
    inc.ModelAverage(0.15, parameters=_mlp(P).parameters(),
                     min_average_window=10000)
    for kw in (dict(kdim=4), dict(vdim=4), dict(need_weights=True),
               dict(nranks=2), dict(ring_id=0), dict(transpose_qkv_wb=True),
               dict(ln_scale_attr=False)):
        with pytest.raises(NotImplementedError, match=next(iter(kw))):
            inc.nn.FusedMultiHeadAttention(8, 2, **kw)
    with pytest.raises(NotImplementedError, match="ln2_bias_attr"):
        inc.nn.FusedFeedForward(8, 16, ln2_bias_attr=False)
    with pytest.raises(NotImplementedError, match="weight_attr"):
        inc.nn.FusedTransformerEncoderLayer(8, 2, 16, weight_attr=False)
    mha = inc.nn.FusedMultiHeadAttention(8, 2, dropout_rate=0.0,
                                         attn_dropout_rate=0.0)
    x = P.to_tensor(np.zeros((1, 3, 8), "float32"))
    with pytest.raises(NotImplementedError, match="key"):
        mha(x, key=x)
    with pytest.raises(NotImplementedError, match="cache"):
        inc.nn.FusedFeedForward(8, 16)(x, cache=x)


# ------------------------------------------------------------ the surface
SURFACE = ["incubate", "incubate.nn", "incubate.nn.functional",
           "incubate.asp", "incubate.distributed.models.moe",
           "incubate.distributed.models.moe.gate", "geometric",
           "amp.debugging", "observability", "utils.log_writer"]
# names the JAX modules hold that are imports, not their surface, and the
# XLA introspection module, whose counterpart is observability.device
NOT_SURFACE = {"apply_op", "Layer", "xla"}


@pytest.mark.parametrize("mod", SURFACE)
def test_every_public_name_of_jax_is_in_the_port(mod):
    import importlib
    import types

    j = importlib.import_module("paddle_tpu." + mod)
    t = importlib.import_module("paddle_tpu_torch." + mod)
    names = set(getattr(j, "__all__", ())) | {
        n for n in dir(j) if not n.startswith("_")
        and not isinstance(getattr(j, n), types.ModuleType)
        and getattr(getattr(j, n), "__module__", "").startswith(
            "paddle_tpu.")}
    assert sorted(n for n in names - NOT_SURFACE if not hasattr(t, n)) == []
