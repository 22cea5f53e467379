"""Ring attention, Ulysses and Megatron sequence parallelism on gloo ranks
against the JAX package's over a "sep" / "mp" mesh of fake CPU devices
(``tests/test_context_parallel.py``, all seven bodies).

The ranks (``dist_ranks.body_context_parallel``, 4 ranks once per module)
run every case over the world (n = 4) and over the pairs of a 2 x 2 mesh
(n = 2), each rank with its sequence shard [B, S/n, H, D]. JAX runs the
same functions in ``shard_map`` over n devices; its gradients are
``jax.grad`` of the summed squared output through ``shard_map``. Held in
f32: outputs within 2e-5 (JAX's test), gradients within 5e-4 (JAX's ring
gradient tolerance), rank r's shard against device r's; the SP linears
within 1e-5 of JAX's dense two-layer MLP, their weight gradients within
1e-4 of the largest.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from paddle_tpu.distributed.context_parallel import (
    ring_attention, split_sequence, ulysses_attention,
)

import dist_ranks

B, S, H, D = 2, 64, 4, 8


def _qkv(seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, S, H, D).astype("float32") for _ in range(3)]


def _mesh(n, name="sep"):
    return Mesh(np.array(jax.devices()[:n]), (name,))


def _sharded(fn, n, causal):
    return shard_map(lambda a, b, c: fn(a, b, c, axis_name="sep",
                                        causal=causal),
                     mesh=_mesh(n), in_specs=P(None, "sep"),
                     out_specs=P(None, "sep"), check_rep=False)


def _jax_case(fn, q, k, v, n, causal):
    f = _sharded(fn, n, causal)
    out = jax.jit(f)(q, k, v)
    grads = jax.jit(jax.grad(lambda a, b, c: jnp.sum(f(a, b, c) ** 2),
                             argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


SEP_HEADS, SEP_LR = 2, 0.5


def _sep_case():
    r = np.random.RandomState(5)
    f = lambda *shape: (0.5 * r.randn(*shape)).astype("float32")  # noqa
    return {"x": f(4, 16, 16), "y": r.randint(0, 8, (4, 16)),
            "w": [f(16, 48), f(48), f(16, 8), f(8)], "heads": SEP_HEADS,
            "lr": SEP_LR}


def _jax_sep_training(fn, case, steps=3):
    """JAX's run over a ("dp", "sep") = (2, 2) mesh of the same model and
    loss, the batch's rows over dp and its sequence over sep, the
    attention ``fn`` (the JAX package's ring or Ulysses) inside
    ``shard_map``: (the gradients of the first step, each step's loss,
    the weights after ``steps`` steps of SGD)."""
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "sep"))

    def local(w, x, y):
        w1, b1, w2, b2 = w
        Bl, s, _ = x.shape
        qkv = (x @ w1 + b1).reshape(Bl, s, 3, SEP_HEADS, -1)
        o = fn(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], axis_name="sep",
               causal=True)
        logits = o.reshape(Bl, s, -1) @ w2 + b2
        lp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(lp, y[..., None], axis=-1).mean()
        return jax.lax.pmean(nll, ("dp", "sep"))

    f = shard_map(local, mesh=mesh, in_specs=(P(), P("dp", "sep"),
                                              P("dp", "sep")),
                  out_specs=P(), check_rep=False)
    vg = jax.jit(jax.value_and_grad(f))
    w = [jnp.asarray(a) for a in case["w"]]
    x, y = jnp.asarray(case["x"]), jnp.asarray(case["y"])
    losses, first = [], None
    for _ in range(steps):
        loss, g = vg(w, x, y)
        first = first or [np.asarray(a) for a in g]
        losses.append(float(loss))
        w = [a - case["lr"] * b for a, b in zip(w, g)]
    return first, losses, [np.asarray(a) for a in w]


@pytest.fixture(scope="module")
def spawned():
    """JAX's answers, and one spawn of four ranks running both bodies."""
    q, k, v = _qkv(2)
    rng = np.random.RandomState(3)
    gqa = [rng.randn(B, S, H, D).astype("float32"),
           rng.randn(B, S, H // 2, D).astype("float32"),
           rng.randn(B, S, H // 2, D).astype("float32")]
    ref = {}
    for n in (2, 4):
        for causal in (False, True):
            ref[f"ring_{n}_{causal}"] = _jax_case(ring_attention, q, k, v, n,
                                                  causal)
            ref[f"ulysses_{n}_{causal}"] = _jax_case(ulysses_attention, q, k,
                                                     v, n, causal)
    ref["ring_gqa"] = _jax_case(ring_attention, *gqa, 4, True)
    seq = np.arange(32, dtype=np.float32).reshape(1, 32)
    for n in (2, 4):
        ref[f"split_{n}"] = np.asarray(jax.jit(shard_map(
            lambda x: split_sequence(x, "sep", seq_dim=1), mesh=_mesh(n),
            in_specs=P(), out_specs=P(None, "sep"), check_rep=False))(seq))
    r = np.random.RandomState(0)
    sp = {"x": r.randn(2, 8, 16).astype("float32"),
          "w1": r.randn(16, 32).astype("float32"),
          "b1": r.randn(32).astype("float32"),
          "w2": r.randn(32, 16).astype("float32"),
          "b2": r.randn(16).astype("float32")}

    def mlp(x, w1, b1, w2, b2):
        return (x @ w1 + b1) @ w2 + b2

    args = [jnp.asarray(sp[k]) for k in ("x", "w1", "b1", "w2", "b2")]
    ref["sp_out"] = np.asarray(mlp(*args))
    ref["sp_grads"] = [np.asarray(g) for g in jax.grad(
        lambda *a: jnp.sum(mlp(*a) ** 2), argnums=(0, 1, 2, 3, 4))(*args)]
    explicit = np.arange(2 * 16 * 3, dtype=np.float32).reshape(2, 16, 3)
    case = _sep_case()
    ref["sep"] = {"ring": _jax_sep_training(ring_attention, case),
                  "ulysses": _jax_sep_training(ulysses_attention, case)}
    inputs = {"q": q, "k": k, "v": v, "gqa": gqa, "seq": seq, "sp": sp,
              "explicit": explicit, "sep_case": case}
    ranks = dist_ranks.run_ranks(["body_context_parallel",
                                  "body_sep_training"], 4, inputs)
    return ref, inputs, ranks


@pytest.fixture(scope="module")
def setup(spawned):
    ref, inputs, ranks = spawned
    return ref, inputs, [r["body_context_parallel"] for r in ranks]


def _rank_dev(n):
    """(rank, its index in the n-group): the world, or the 2 x 2 mesh's
    sep pairs {0, 1}, {2, 3}."""
    return [(r, r if n == 4 else r % 2) for r in range(4)]


def _hold(got, want, n, dev, out_tol, grad_tol):
    out, grads = got
    w_out, w_grads = want
    cut = lambda a: np.split(a, n, axis=1)[dev]        # noqa: E731
    np.testing.assert_allclose(out, cut(w_out), atol=out_tol)
    for g, w in zip(grads, w_grads):
        np.testing.assert_allclose(g, cut(w), atol=grad_tol)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [2, 4])
def test_ring_attention_parity_and_grads(setup, n, causal):
    ref, _, ranks = setup
    key = f"ring_{n}_{causal}"
    for rank, dev in _rank_dev(n):
        _hold(ranks[rank][key], ref[key], n, dev, 2e-5, 5e-4)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [2, 4])
def test_ulysses_attention_parity_and_grads(setup, n, causal):
    ref, _, ranks = setup
    key = f"ulysses_{n}_{causal}"
    for rank, dev in _rank_dev(n):
        _hold(ranks[rank][key], ref[key], n, dev, 2e-5, 5e-4)


def test_ring_attention_gqa(setup):
    ref, _, ranks = setup
    for rank in range(4):
        _hold(ranks[rank]["ring_gqa"], ref["ring_gqa"], 4, rank, 2e-5, 5e-4)


def test_ring_flash_attention_facade(setup):
    ref, _, ranks = setup
    for rank, dev in _rank_dev(2):
        np.testing.assert_allclose(
            ranks[rank]["ring_facade"],
            np.split(ref["ring_2_True"][0], 2, axis=1)[dev], atol=2e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_split_sequence(setup, n):
    ref, _, ranks = setup
    for rank, dev in _rank_dev(n):
        np.testing.assert_array_equal(
            ranks[rank][f"split_{n}"],
            np.split(ref[f"split_{n}"], n, axis=1)[dev])


def test_sequence_parallel_linears_parity(setup):
    """Column + Row SP pair over mp = 4 == the dense two-layer MLP: each
    rank's sequence shard of the output, of the input gradient, and its
    weight shards' gradients."""
    ref, _, ranks = setup
    gx, gw1, gb1, gw2, gb2 = ref["sp_grads"]
    for rank in range(4):
        y, xg, (w1g, b1g, w2g, b2g) = ranks[rank]["sp"]
        cut = lambda a: np.split(a, 4, axis=1)[rank]     # noqa: E731
        np.testing.assert_allclose(y, cut(ref["sp_out"]), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(xg, cut(gx), atol=1e-4, rtol=1e-5)
        for g, w in ((w1g, np.split(gw1, 4, 1)[rank]),
                     (b1g, np.split(gb1, 4)[rank]),
                     (w2g, np.split(gw2, 4, 0)[rank])):
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-4 * np.abs(w).max())
    # the replicated bias after the reduce-scatter: each rank's gradient
    # covers its sequence slice (marked sequence-parallel; the hybrid
    # wrappers' gradient sync sums it over mp)
    total = sum(r["sp"][2][3] for r in ranks)
    np.testing.assert_allclose(total, gb2, rtol=0,
                               atol=1e-4 * np.abs(gb2).max())
    for r in ranks:
        w1g, b1g, w2g, b2g = r["sp_synced"]
        np.testing.assert_allclose(b2g, gb2, rtol=0,
                                   atol=1e-4 * np.abs(gb2).max())
        np.testing.assert_array_equal(w2g, r["sp"][2][2])   # sharded: local


def test_sp_scatter_gather_explicit(setup):
    _, inputs, ranks = setup
    for r in ranks:
        shape, back = r["sp_explicit"]
        assert shape == (2, 4, 3)
        np.testing.assert_array_equal(back, inputs["explicit"])


@pytest.mark.parametrize("attn", ["ring", "ulysses"])
def test_sep_training_matches_jax_mesh_run(spawned, attn):
    """dp = 2 x sep = 2 through fleet's SegmentParallel: after one backward
    every rank holds the global gradients (its segment's, averaged over
    the dp x sep group by the wrapper); three TrainStep steps of SGD give
    JAX's losses and weights on every rank."""
    ref, _, ranks = spawned
    grads, losses, weights = ref["sep"][attn]
    coords = set()
    for r in ranks:
        r = r["body_sep_training"]
        coords.add(r["coord"])
        assert r["wrapper"] == "SegmentParallel"
        assert r["dp_sep_ranks"] == [0, 1, 2, 3]
        assert r[f"{attn}_syncs"] == 3
        for g, w in zip(r[f"{attn}_grads"], grads):
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-4 * np.abs(w).max())
        np.testing.assert_allclose(r[f"{attn}_losses"], losses, rtol=1e-5,
                                   atol=1e-5)
        for p, w in zip(r[f"{attn}_params"], weights):
            np.testing.assert_allclose(p, w, rtol=0, atol=1e-5)
    assert coords == {(0, 0), (0, 1), (1, 0), (1, 1)}
