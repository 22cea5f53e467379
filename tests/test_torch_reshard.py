"""``reshard`` of the port across meshes, to and from ``Partial``, and its
gradient, against the JAX package's on its CPU mesh
(``paddle_tpu/distributed/api.py:56-91``).

Meshes over 4 ranks: "2d" [[0, 1], [2, 3]] ("x", "y"), "1d" [0..3] ("x")
and "sub" [1, 3] ("x"), a mesh over a subset of the ranks. JAX computes
each case once in a module fixture on its devices 0-3; the port runs every
case on 4 gloo ranks in one spawn (``tests/dist_auto_bodies.py``
``body_reshard``). Held, exactly (moves and sums of small integers): each
rank's part equals what JAX's array holds on the device of the same
number, and a rank outside the target mesh holds nothing (JAX's array has
no shard there). A target holding a ``Partial`` resolves no pending
reduction, as in JAX. The gradient of ``sum(reshard(x) * C)`` with
respect to the whole leaf x: summed over the ranks that hold parts of a
sharded source (each rank its block), or on every rank for a replicated
one, it equals JAX's ``x.grad`` (within 1e-6: products of C).
"""
import numpy as np
import pytest

import dist_ranks
import paddle_tpu as paddle
import paddle_tpu.distributed as jdist

MESHES = {"2d": ([[0, 1], [2, 3]], ["x", "y"]),
          "1d": ([0, 1, 2, 3], ["x"]),
          "sub": ([1, 3], ["x"])}

CASES = {
    "2d_to_1d": ("2d", ["S0", "S1"], "1d", ["S1"]),
    "2d_to_sub": ("2d", ["S0", "S1"], "sub", ["S0"]),
    "1d_to_sub_replicated": ("1d", ["S0"], "sub", ["R"]),
    "sub_to_2d": ("sub", ["S1"], "2d", ["R", "S0"]),
    "partial_to_replicate": ("1d", ["P"], "1d", ["R"]),
    "replicate_to_partial": ("1d", ["R"], "1d", ["P"]),
    "partial_to_partial_across": ("1d", ["P"], "2d", ["P", "R"]),
    "partial_2d_to_1d": ("2d", ["P", "S0"], "1d", ["R"]),
    "shard_to_partial_across": ("2d", ["S0", "S1"], "1d", ["P"]),
}
GRADS = {
    "grad_shard_to_replicate": ("1d", ["S0"], "1d", ["R"]),
    "grad_replicate_to_shard": ("1d", ["R"], "1d", ["S1"]),
    "grad_2d_to_sub": ("2d", ["S0", "S1"], "sub", ["S0"]),
}

X = np.arange(32, dtype=np.float32).reshape(8, 4)
C = np.random.RandomState(0).randn(8, 4).astype(np.float32)


def _jmesh(name):
    ids, names = MESHES[name]
    return jdist.ProcessMesh(np.asarray(ids), names)


def _jpl(spec):
    out = []
    for s in spec:
        out.append(jdist.Replicate() if s == "R" else jdist.Partial()
                   if s == "P" else jdist.Shard(int(s[1:])))
    return out


def _by_device(t):
    return {s.device.id: np.asarray(s.data)
            for s in t._value.addressable_shards}


def _jax_case(case):
    sm, sp, tm, tp = case
    src = jdist.shard_tensor(paddle.to_tensor(X), _jmesh(sm), _jpl(sp))
    return _by_device(jdist.reshard(src, _jmesh(tm), _jpl(tp)))


def _jax_grad(case):
    sm, sp, tm, tp = case
    x = paddle.to_tensor(X, stop_gradient=False)
    # JAX's shard_tensor carries the grad node of its input: a leaf has
    # none, so the leaf goes through one op first
    src = jdist.shard_tensor(x * 1.0, _jmesh(sm), _jpl(sp))
    y = jdist.reshard(src, _jmesh(tm), _jpl(tp))
    c = jdist.shard_tensor(paddle.to_tensor(C), _jmesh(tm), _jpl(tp))
    (y * c).sum().backward()
    return np.asarray(x.grad._value)


@pytest.fixture(scope="module")
def runs():
    want = {k: _jax_case(c) for k, c in CASES.items()}
    want_grads = {k: _jax_grad(c) for k, c in GRADS.items()}
    ranks = dist_ranks.run_ranks(
        ["dist_auto_bodies:body_reshard"], 4,
        {"rs_x": X, "rs_c": C, "rs_cases": CASES, "rs_grad_cases": GRADS})
    got = [r["dist_auto_bodies:body_reshard"] for r in ranks]
    return want, want_grads, got


@pytest.mark.parametrize("case", sorted(CASES))
def test_parts_match_jax_devices(runs, case):
    want, _, got = runs
    members = {int(r) for r in np.asarray(MESHES[CASES[case][2]][0]).ravel()}
    assert set(want[case]) == members
    for rank, r in enumerate(got):
        part, placements_kept, global_shape = r[case]
        assert placements_kept and global_shape == list(X.shape)
        if rank not in members:
            assert part is None
            continue
        np.testing.assert_array_equal(part, want[case][rank],
                                      err_msg=f"rank {rank}")


def test_partial_target_resolves_nothing(runs):
    """A Partial target keeps each rank's unreduced value (JAX leaves the
    pending reduction pending); a Replicate target reduces it."""
    _, _, got = runs
    for r in got:
        np.testing.assert_array_equal(r["replicate_to_partial"][0], X)
        np.testing.assert_array_equal(r["partial_to_partial_across"][0], X)
        np.testing.assert_array_equal(r["partial_to_replicate"][0], 4 * X)


@pytest.mark.parametrize("case", sorted(GRADS))
def test_gradient_flows_back_through_reshard(runs, case):
    _, want_grads, got = runs
    grads = [r[case] for r in got]
    np.testing.assert_allclose(want_grads[case], C, rtol=0, atol=1e-6)
    if GRADS[case][1] == ["R"]:
        for g in grads:
            np.testing.assert_allclose(g, want_grads[case], rtol=0,
                                       atol=1e-6)
    else:
        np.testing.assert_allclose(np.sum(grads, axis=0), want_grads[case],
                                   rtol=0, atol=1e-6)
