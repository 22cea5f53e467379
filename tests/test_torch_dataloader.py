"""``io``: datasets, samplers and the ``DataLoader`` worker pool, on both
packages.

The bodies are ``tests/test_dataloader_workers.py``'s (ordered results
from worker processes, ``get_worker_info`` and ``worker_init_fn``,
iterable datasets sharding themselves, a worker's exception in the main
process, persistent pools, stale batches of an abandoned epoch, two live
iterators) without its timing leg, and the dataset / sampler surface of
``paddle_tpu/io/__init__.py``; each runs on the JAX package and on the
port (``port_bodies.run``: the port's batches, indices and lengths equal
to the JAX package's). Both packages sample from numpy's global generator,
seeded in the bodies.
"""
import time

import numpy as np
import pytest

import paddle_tpu_torch as port
from port_bodies import npy, on_cpu, run  # noqa: F401

PKG = pytest.mark.parametrize("pkg", ["jax", "torch"])


def _slow(io, n=64, delay=0.002):
    class Slow(io.Dataset):
        def __len__(self):
            return n

        def __getitem__(self, idx):
            time.sleep(delay)
            return np.full((4,), idx, dtype="float32"), np.int64(idx)

    return Slow()


def _arrays(batches):
    return [tuple(npy(t) for t in b) for b in batches]


def worker_order_matches_serial(paddle):
    io = paddle.io
    ref = _arrays(io.DataLoader(_slow(io), batch_size=8, num_workers=0))
    got = _arrays(io.DataLoader(_slow(io), batch_size=8, num_workers=4))
    assert len(got) == len(ref) == 8
    for g, r in zip(got, ref):
        for a, b in zip(g, r):
            np.testing.assert_array_equal(a, b)
    return {"x": np.concatenate([g[0] for g in got]),
            "y": np.concatenate([g[1] for g in got])}


def worker_info_and_init_fn(paddle):
    io = paddle.io

    class Info(io.Dataset):
        def __len__(self):
            return 16

        def __getitem__(self, idx):
            info = io.get_worker_info()
            assert info is not None and 0 <= info.id < info.num_workers
            return np.int64(info.id)

    def init_fn(worker_id):
        info = io.get_worker_info()
        assert info is not None and info.id == worker_id

    loader = io.DataLoader(Info(), batch_size=4, num_workers=2,
                           worker_init_fn=init_fn)
    ids = np.concatenate([npy(b) for b in loader])
    assert io.get_worker_info() is None
    return {"ids_in_range": bool(set(ids.tolist()) <= {0, 1}),
            "n": len(ids)}


def iterable_dataset_workers(paddle):
    io = paddle.io

    class Sharded(io.IterableDataset):
        def __iter__(self):
            info = io.get_worker_info()
            lo, step = (0, 1) if info is None else (info.id,
                                                    info.num_workers)
            for i in range(lo, 32, step):
                yield np.full((2,), i, dtype="float32")

    loader = io.DataLoader(Sharded(), batch_size=4, num_workers=2)
    vals = sorted(int(v) for b in loader for v in npy(b)[:, 0])
    inline = [npy(b) for b in io.DataLoader(Sharded(), batch_size=5)]
    return {"vals": vals, "inline_sizes": [len(b) for b in inline]}


def worker_exception_propagates(paddle):
    io = paddle.io

    class Bad(io.Dataset):
        def __len__(self):
            return 8

        def __getitem__(self, idx):
            if idx == 5:
                raise ValueError("boom-5")
            return np.float32(idx)

    with pytest.raises(RuntimeError, match="boom-5"):
        list(io.DataLoader(Bad(), batch_size=2, num_workers=2))
    return {}


def persistent_workers_reused(paddle):
    io = paddle.io
    loader = io.DataLoader(_slow(io, n=16), batch_size=4, num_workers=2,
                           persistent_workers=True)
    a = [npy(b[0]) for b in loader]
    pool = loader._pool
    b = [npy(x[0]) for x in loader]
    same_pool = loader._pool is pool and pool is not None
    pool.shutdown()
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    return {"same_pool": same_pool, "n": len(b)}


def abandoned_epoch_serves_no_stale_batches(paddle):
    io = paddle.io
    loader = io.DataLoader(_slow(io, n=32, delay=0.001), batch_size=4,
                           num_workers=2, persistent_workers=True)
    it = iter(loader)
    first = npy(next(it)[0])
    del it
    full = [npy(b[0]) for b in loader]
    loader._pool.shutdown()
    ref = [npy(b[0]) for b in io.DataLoader(_slow(io, n=32, delay=0.0),
                                           batch_size=4)]
    assert len(full) == len(ref)
    for x, y in zip(full, ref):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(first, ref[0])
    return {"n": len(full)}


def concurrent_iterators_raise(paddle):
    io = paddle.io
    loader = io.DataLoader(_slow(io, n=16, delay=0.001), batch_size=4,
                           num_workers=2, persistent_workers=True)
    it1 = iter(loader)
    next(it1)
    with pytest.raises(RuntimeError, match="one live iterator"):
        next(iter(loader))
    del it1
    loader._pool.shutdown()
    return {}


def datasets_and_samplers(paddle):
    io = paddle.io
    np.random.seed(3)
    xs = paddle.to_tensor(np.arange(12, dtype="float32").reshape(6, 2))
    ys = paddle.to_tensor(np.arange(6, dtype="int64"))
    td = io.TensorDataset([xs, ys])
    comp = io.ComposeDataset([td, td])
    cat = io.ConcatDataset([td, io.Subset(td, [5, 1])])
    chain = [v for v in io.ChainDataset([range(3), range(2)])]
    parts = io.random_split(td, [4, 2])
    seq = list(io.SequenceSampler(td))
    rnd = list(io.RandomSampler(td))
    rep = list(io.RandomSampler(td, replacement=True, num_samples=9))
    wts = list(io.WeightedRandomSampler([0.1, 0.0, 0.9], 5))
    sub = list(io.SubsetRandomSampler([7, 8, 9]))
    bs = list(io.BatchSampler(td, batch_size=4, drop_last=False))
    bsd = list(io.BatchSampler(td, batch_size=4, drop_last=True))
    dist = [list(io.DistributedBatchSampler(td, 2, num_replicas=3, rank=r,
                                            shuffle=True)) for r in range(3)]
    return {"td": npy(td[4][0]), "td_len": len(td),
            "comp": np.concatenate([npy(t).ravel().astype("float64")
                                    for t in comp[2]]),
            "comp_len": len(comp),
            "cat": npy(cat[7][0]), "cat_len": len(cat),
            "chain": chain, "parts": [len(p) for p in parts],
            "part_idx": parts[0].indices, "seq": seq, "rnd": rnd,
            "rep": rep, "wts": wts, "sub": sub, "bs": bs, "bsd": bsd,
            "dist": dist}


def collate_nested_samples(paddle):
    io = paddle.io

    class Nested(io.Dataset):
        def __len__(self):
            return 6

        def __getitem__(self, i):
            return {"x": np.full((2,), i, "float32"),
                    "pair": (np.int64(i), float(i) / 2)}

    batches = list(io.DataLoader(Nested(), batch_size=4))
    b = batches[0]
    return {"x": npy(b["x"]), "pair0": npy(b["pair"][0]),
            "pair1": npy(b["pair"][1]), "n": len(batches),
            "len": len(io.DataLoader(Nested(), batch_size=4))}


BODIES = [worker_order_matches_serial, worker_info_and_init_fn,
          iterable_dataset_workers, worker_exception_propagates,
          persistent_workers_reused, abandoned_epoch_serves_no_stale_batches,
          concurrent_iterators_raise, datasets_and_samplers,
          collate_nested_samples]


@PKG
@pytest.mark.parametrize("body", BODIES, ids=[b.__name__ for b in BODIES])
def test_dataloader_body(on_cpu, body, pkg):
    run(body, pkg)


def test_workers_send_numpy_and_the_main_process_makes_tensors(on_cpu):
    """A worker collates to numpy (``_worker_mode``); the main process
    wraps each leaf as a Tensor on the current place."""
    from paddle_tpu_torch import io

    loader = io.DataLoader(_slow(io, n=8, delay=0.0), batch_size=4,
                           num_workers=2)
    for x, y in loader:
        assert isinstance(x, port.Tensor) and x.place.is_cpu_place()
        assert str(y.dtype) == "torch.int64"
    assert io._worker_mode is False


def test_an_abandoned_epoch_shuts_its_workers_down_at_once(on_cpu):
    """Batches larger than a pipe's buffer, one read, the iterator
    dropped: the pool drains what the workers still flush while they exit
    (joining first would wait out its timeout on a worker blocked in
    that flush)."""
    import gc

    from paddle_tpu_torch import io

    class Big(io.Dataset):
        def __len__(self):
            return 64

        def __getitem__(self, i):
            return np.zeros((8, 1025), "int64")

    loader = io.DataLoader(Big(), batch_size=8, num_workers=2)
    t0 = time.monotonic()
    it = iter(loader)
    next(it)
    del it
    gc.collect()
    assert time.monotonic() - t0 < 2.0
