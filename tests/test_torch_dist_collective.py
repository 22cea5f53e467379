"""The port's collectives on gloo ranks against the JAX package's over a
mesh of fake CPU devices (``tests/test_amp_collectives.py:70-176``).

The ranks run once per module (``dist_ranks.body_collectives``: 4 ranks,
every collective over the world and over the pairs of a 2 x 2 mesh). JAX
computes the same collectives in ``shard_map`` over 4 and over 2 devices,
each device holding the row its rank holds. Rank r must end with what
device r ends with, exactly: the inputs are small integers, so every sum
and product is exact in f32 whatever the order. Point-to-point calls,
uneven ``alltoall_single`` splits and the object collectives have no
in-trace counterpart in JAX; they are held to their numpy meaning.
"""
import numpy as np
import pytest

import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist

import dist_ranks

ROWS = 3


def _x(n):
    return (np.arange(n * ROWS, dtype=np.float32).reshape(n, ROWS) + 1)


def _jax_collectives(x):
    """{name: [n, ...] per-device results} of JAX's in-trace collectives."""
    n = x.shape[0]
    g = jdist.new_group(list(range(n)))
    ax = g.axis_name
    spec = P(ax)

    def run(f):
        return np.asarray(g.shard_map(lambda v: f(v[0])[None], spec,
                                      spec)(jnp.asarray(x)))

    def me():
        import jax

        return jax.lax.axis_index(ax)

    out = {}
    for op in ("sum", "max", "min", "prod", "avg"):
        def f(v, op=op):
            t = paddle.Tensor(v)
            jdist.all_reduce(t, op=op, group=g)
            return t._value
        out[f"all_reduce_{op}"] = run(f)
    out["all_reduce_tensor"] = out["all_reduce_sum"]

    def f(v):
        t = paddle.Tensor(v)
        jdist.reduce(t, dst=0, group=g)
        return t._value
    out["reduce"] = run(f)

    def f(v):
        t = paddle.Tensor(v)
        jdist.broadcast(t, src=n - 1, group=g)
        return t._value
    out["broadcast"] = run(f)

    def f(v):
        lst = []
        jdist.all_gather(lst, paddle.Tensor(v), group=g)
        return jnp.stack([t._value for t in lst])
    out["all_gather"] = run(f)
    out["all_gather_axis"] = out["all_gather"]

    def f(v):
        lst = []
        jdist.gather(paddle.Tensor(v), lst, dst=0, group=g)
        return jnp.stack([t._value for t in lst])
    out["gather"] = run(f)

    def f(v):
        lst = [paddle.Tensor(v * 0 + 10.0 * i + 100.0 * me())
               for i in range(n)]
        t = paddle.Tensor(v)
        jdist.scatter(t, lst, src=0, group=g)
        return t._value
    out["scatter"] = run(f)

    def f(v):
        t = paddle.Tensor(v)
        jdist.reduce_scatter(t, [paddle.Tensor(v * (i + 1))
                                 for i in range(n)], group=g)
        return t._value
    out["reduce_scatter_list"] = run(f)

    def f(v):
        t = paddle.Tensor(v[None])
        jdist.reduce_scatter(t, paddle.Tensor(jnp.stack(
            [v * (i + 1) for i in range(n)])), group=g)
        return t._value
    out["reduce_scatter_tiled"] = run(f)

    def f(v):
        outs = []
        jdist.alltoall(outs, [paddle.Tensor(v * (i + 1) + i)
                              for i in range(n)], group=g)
        return jnp.stack([t._value for t in outs])
    out["alltoall"] = run(f)

    def f(v):
        src = paddle.Tensor(jnp.concatenate([v * (i + 1) + i
                                             for i in range(n)]))
        dst = paddle.Tensor(src._value)
        jdist.alltoall_single(dst, src, group=g)
        return dst._value
    out["alltoall_single"] = run(f)

    for name, off in (("shift", 1), ("shift_back", -1)):
        def f(v, off=off):
            return jdist.collective.shift(paddle.Tensor(v), offset=off,
                                          group=g)._value
        out[name] = run(f)
    return out


def _numpy_p2p(x):
    """The meaning of the calls JAX has no in-trace form of."""
    n = x.shape[0]
    out = {"send_recv": np.roll(x, 1, axis=0),
           "isend_irecv": np.roll(x, 1, axis=0),
           "batch_p2p": np.stack([np.roll(x, 1, axis=0),
                                  np.roll(2 * x, -1, axis=0)], axis=1),
           "broadcast_object": [n - 1] * n,
           "all_gather_object": [[("r", i) for i in range(n)]] * n,
           "scatter_object": [f"o{i}" for i in range(n)]}
    out["alltoall_single_uneven"] = [
        np.concatenate([np.full((me + 1, ROWS), 10.0 * r + me)
                        for r in range(n)]) for me in range(n)]
    return out


@pytest.fixture(scope="module")
def jax_answers():
    return {n: _jax_collectives(_x(n)) for n in (2, 4)}


A = np.arange(24, dtype=np.float32).reshape(4, 6)


@pytest.fixture(scope="module")
def run():
    return dist_ranks.run_ranks(["body_collectives", "body_dist_api"], 4,
                                {"x4": _x(4), "x2": _x(2), "a": A})


@pytest.fixture(scope="module")
def ranks(run):
    return [r["body_collectives"] for r in run]


@pytest.fixture(scope="module")
def jax_shards():
    """Device d's shard of JAX's global arrays over the same 2 x 2 mesh."""
    mesh = jdist.ProcessMesh([[0, 1], [2, 3]], ["x", "y"])
    S, R = jdist.Shard, jdist.Replicate

    def per_device(t):
        shards = {s.device.id: np.asarray(s.data)
                  for s in t._value.addressable_shards}
        return [shards[d] for d in range(4)]

    t = jdist.shard_tensor(paddle.to_tensor(A), mesh, [S(0), R()])
    out = {"s0": per_device(t),
           "s01": per_device(jdist.shard_tensor(paddle.to_tensor(A), mesh,
                                                [S(0), S(1)])),
           "reshard_s1": per_device(jdist.reshard(t, mesh, [R(), S(1)]))}
    return out


def _rank_rows(ranks, n, name):
    """[(device index, rank's result)]: the world for n = 4, both pairs for
    n = 2 (ranks 0, 1 and 2, 3 are devices 0, 1 of a pair each)."""
    if n == 4:
        return [(r, ranks[r][f"n4_{name}"]) for r in range(4)]
    return [(r % 2, ranks[r][f"n2_{name}"]) for r in range(4)]


JAX_NAMES = ["all_reduce_sum", "all_reduce_max", "all_reduce_min",
             "all_reduce_prod", "all_reduce_avg", "all_reduce_tensor",
             "reduce", "broadcast", "all_gather", "all_gather_axis",
             "gather", "scatter", "reduce_scatter_list",
             "reduce_scatter_tiled", "alltoall", "alltoall_single", "shift",
             "shift_back"]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", JAX_NAMES)
def test_collective_matches_jax_mesh(ranks, jax_answers, n, name):
    want = jax_answers[n][name]
    for dev, got in _rank_rows(ranks, n, name):
        np.testing.assert_array_equal(np.asarray(got).reshape(
            want[dev].shape), want[dev], err_msg=f"{name} n={n} dev {dev}")


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["send_recv", "isend_irecv", "batch_p2p",
                                  "alltoall_single_uneven",
                                  "broadcast_object", "all_gather_object",
                                  "scatter_object"])
def test_p2p_and_objects_match_numpy(ranks, n, name):
    want = _numpy_p2p(_x(n))[name]
    for dev, got in _rank_rows(ranks, n, name):
        if isinstance(got, np.ndarray):
            np.testing.assert_array_equal(got, np.asarray(want[dev]))
        else:
            assert got == want[dev], (name, n, dev, got)


def test_mesh_dims_are_process_groups(ranks):
    assert [r["pair_ranks"] for r in ranks] == [[0, 1], [0, 1], [2, 3],
                                                [2, 3]]
    assert {r["group_axis"] for r in ranks} == {"b"}
    assert {r["backend"] for r in ranks} == {"gloo"}


def test_a_rank_that_raises_fails_within_the_timeout():
    """Rank 1 raises before an all-reduce that rank 0 enters: the run ends
    within the collective timeout and names rank 1's error, not a hang."""
    import time

    t0 = time.monotonic()
    with pytest.raises(dist_ranks.RankFailed) as ei:
        dist_ranks.run_ranks(["body_raise_on_rank1"], 2, timeout_s=10,
                             deadline_s=60)
    assert ei.value.rank == 1
    assert "planted failure on rank 1" in ei.value.trace
    assert time.monotonic() - t0 < 60


def test_entry_points_refuse_without_a_card_or_group():
    """No silent fallback: the card is the default and raises here; a
    collective without a process group raises."""
    import torch

    from paddle_tpu_torch import distributed as dist

    if torch.cuda.is_available():
        pytest.skip("this sandbox check needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist.init_parallel_env()
    with pytest.raises(RuntimeError, match="init_parallel_env"):
        dist.all_reduce(torch.ones(2))
    with pytest.raises(NotImplementedError, match="A5.9"):
        dist.rpc
    with pytest.raises(NotImplementedError, match="A5.9"):
        dist.InMemoryDataset
    # ZeRO is ported (A5.2): a stage is made; it needs a mesh only when
    # it is laid over an optimizer
    assert dist.ShardingStage1().axis_name == "dp"


@pytest.mark.parametrize("name", ["s0", "s01", "reshard_s1"])
def test_dist_tensor_shards_match_jax(run, jax_shards, name):
    """Rank r holds device r's shard of JAX's global array."""
    for r in range(4):
        np.testing.assert_array_equal(run[r]["body_dist_api"][name],
                                      jax_shards[name][r])


def test_dist_tensor_api(run):
    for r in range(4):
        res = run[r]["body_dist_api"]
        x, y = divmod(r, 2)
        assert res["global_shape"] == [4, 6]
        np.testing.assert_array_equal(res["unshard"], A)
        # Partial -> Replicate sums the parts of the ranks along "x"
        np.testing.assert_array_equal(res["p2r"], A * (2 * y + 4))
        np.testing.assert_array_equal(res["from_fn"], np.ones((2, 2)))
        assert res["dist_attr"] == ["Shard(dim=0)", "Replicate()"]
        shape, same, w = res["param_cut"]
        assert shape == (4, 3) and same
        whole = res["param_unshard"]        # the seeded [4, 6] weight
        assert whole.shape == (4, 6)
        np.testing.assert_array_equal(w, np.split(whole, 2, axis=1)[y])
        np.testing.assert_array_equal(
            whole, run[0]["body_dist_api"]["param_unshard"])


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Two processes started by ``distributed.spawn`` (a fixture's: two
    fresh interpreters take seconds)."""
    from paddle_tpu_torch import distributed as dist

    out = tmp_path_factory.mktemp("spawned")
    dist.spawn(dist_ranks.spawned_all_reduce, args=(str(out),), nprocs=2,
               backend="cpu")
    return sorted(p.read_text() for p in out.iterdir())


def test_spawn_starts_ranks_that_join_from_the_environment(spawned):
    """``distributed.spawn`` starts the processes ("spawn" method) with the
    launcher's variables set; ``init_parallel_env()`` joins from them."""
    assert spawned == ["2 gloo 3.0", "2 gloo 3.0"]
