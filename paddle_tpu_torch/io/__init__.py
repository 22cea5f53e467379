"""Data loading — the counterpart of ``paddle_tpu/io/__init__.py``.
Reference: python/paddle/io/ (Dataset / DataLoader / Sampler,
dataloader/worker.py for the multiprocess worker pool).

``num_workers=0`` runs inline; ``num_workers > 0`` forks a pool of worker
processes (the GIL makes threads useless for CPU-bound transforms; fork,
as in JAX and torch's loader, because a dataset, sampler or collate
function need not be picklable by import path, which spawn requires).
Workers never touch CUDA: a forked child of a process that initialised
CUDA cannot use it, so samples are collated to numpy in the worker
(``_to_transportable``), carried over pickle queues (fork shares the
dataset copy-on-write), and turned into Tensors in the main process. There
each batch leaf goes to the current place (``framework.device``): to the
card through pinned host memory and a non-blocking copy on the current
stream, so the copy overlaps host work and no later kernel on that stream
reads the batch before it lands. Batches come back in sampler order
whatever the workers' timing; a worker's exception, death or silence past
``timeout`` raises in the main process.

Sampling draws from numpy's global generator, as in JAX (``generator``
arguments are accepted and not read); a seeded order is a ``Sampler``
the caller writes, or ``np.random.seed`` before iterating.
``DistributedBatchSampler`` shards by ``torch.distributed``'s rank and
world size when a process group is up (else one replica).
"""
from __future__ import annotations

import math
import multiprocessing as mp
import queue
import signal
import threading
import time as _time

import numpy as np
import torch

from ..framework import device as _device
from ..tensor import Tensor

__all__ = [
    "Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
    "ChainDataset", "Subset", "ConcatDataset", "random_split", "DataLoader",
    "BatchSampler", "Sampler", "SequenceSampler", "RandomSampler",
    "SubsetRandomSampler", "WeightedRandomSampler",
    "DistributedBatchSampler", "get_worker_info", "default_collate_fn",
    "WorkerInfo",
]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = datasets

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (list, tuple)) else [item])
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = datasets

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cum[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = int(np.searchsorted(self.cum, idx, side="right"))
        prev = 0 if ds_idx == 0 else self.cum[ds_idx - 1]
        return self.datasets[ds_idx][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    if all(isinstance(n, float) for n in lengths):
        total = len(dataset)
        lengths = [int(math.floor(total * f)) for f in lengths]
        lengths[0] += total - sum(lengths)
    perm = np.random.permutation(sum(lengths))
    out, offset = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[offset:offset + n].tolist()))
        offset += n
    return out


# ------------------------------------------------------------------ samplers
class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[: self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    """A random permutation of a fixed index subset."""

    def __init__(self, indices, generator=None):
        super().__init__(list(indices))
        self.indices = list(indices)

    def __iter__(self):
        return iter(self.indices[i]
                    for i in np.random.permutation(len(self.indices)))

    def __len__(self):
        return len(self.indices)


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray([float(w) for w in weights])
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


def _dist_rank_world():
    """(rank, world size) of the default process group, or (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class DistributedBatchSampler(BatchSampler):
    """Reference: io/dataloader/batch_sampler.py DistributedBatchSampler:
    indices padded to a multiple of the replicas, then rank r takes every
    replicas-th one; shuffled by ``epoch`` (``set_epoch``)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        own_rank, world = _dist_rank_world()
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = num_replicas if num_replicas is not None else world
        self.local_rank = rank if rank is not None else own_rank
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            indices = np.random.RandomState(self.epoch).permutation(n).tolist()
        else:
            indices = list(range(n))
        indices += indices[: (self.total_size - n)]
        indices = indices[self.local_rank::self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


# ------------------------------------------------------------------ loader
_worker_info = threading.local()


class WorkerInfo:
    """Inside a worker process, ``get_worker_info()``: id, num_workers,
    dataset, seed."""

    def __init__(self, id, num_workers, dataset, seed):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset
        self.seed = seed

    def __repr__(self):
        return (f"WorkerInfo(id={self.id}, num_workers={self.num_workers}, "
                f"seed={self.seed})")


def get_worker_info():
    return getattr(_worker_info, "info", None)


_LEAF = "__tensor__"
_worker_mode = False  # set in worker processes: collate to numpy only


def _to_transportable(obj):
    """Tensors -> tagged numpy arrays for the worker -> main queue."""
    if isinstance(obj, Tensor):
        obj = obj._value
    if isinstance(obj, torch.Tensor):
        return (_LEAF, obj.detach().cpu().numpy())
    if isinstance(obj, (list, tuple)) and not _is_leaf(obj):
        return type(obj)(_to_transportable(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _to_transportable(v) for k, v in obj.items()}
    return obj


def _is_leaf(obj):
    return (isinstance(obj, tuple) and len(obj) == 2
            and isinstance(obj[0], str) and obj[0] == _LEAF)


def _batch_tensor(arr):
    """A batch leaf (numpy) as a Tensor on the current place: through
    pinned memory and a non-blocking copy when that is the card."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    dev = _device.get_place().device
    if dev.type == "cuda":
        t = t.pin_memory().to(dev, non_blocking=True)
    return Tensor(t)


def _from_transportable(obj):
    if _is_leaf(obj):
        return _batch_tensor(obj[1])
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_transportable(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _from_transportable(v) for k, v in obj.items()}
    return obj


def _enter_worker(dataset, worker_id, num_workers, seed, init_fn):
    # a forked worker inherits the main process's handlers: one that only
    # sets a flag (a fit loop's preemption hook) would keep SIGTERM, which
    # ends the pool, from ending the worker
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    globals()["_worker_mode"] = True
    _worker_info.info = WorkerInfo(worker_id, num_workers, dataset, seed)
    np.random.seed(seed % (2 ** 31))
    if init_fn is not None:
        init_fn(worker_id)


def _map_worker_loop(dataset, index_queue, result_queue, collate_fn,
                     worker_id, num_workers, seed, init_fn):
    """Worker body (map-style): serve (epoch, batch index, indices)
    requests until the None sentinel."""
    try:
        _enter_worker(dataset, worker_id, num_workers, seed, init_fn)
        while True:
            req = index_queue.get()
            if req is None:
                break
            epoch, batch_idx, indices = req
            try:
                batch = collate_fn([dataset[i] for i in indices])
                result_queue.put(
                    (epoch, batch_idx, _to_transportable(batch), None))
            except Exception as e:  # surface the traceback in the parent
                import traceback

                result_queue.put((epoch, batch_idx, None,
                                  f"{e}\n{traceback.format_exc()}"))
    except KeyboardInterrupt:
        pass


def _iterable_worker_loop(dataset, result_queue, collate_fn, batch_size,
                          drop_last, worker_id, num_workers, seed, init_fn):
    """Worker body (iterable-style): each worker iterates its own dataset
    copy, which splits the work itself through ``get_worker_info()``."""
    try:
        _enter_worker(dataset, worker_id, num_workers, seed, init_fn)
        batch = []
        for item in dataset:
            batch.append(item)
            if len(batch) == batch_size:
                result_queue.put(
                    (worker_id, _to_transportable(collate_fn(batch)), None))
                batch = []
        if batch and not drop_last:
            result_queue.put(
                (worker_id, _to_transportable(collate_fn(batch)), None))
        result_queue.put((worker_id, None, None))  # this worker is done
    except KeyboardInterrupt:
        pass
    except Exception as e:
        import traceback

        result_queue.put((worker_id, None, f"{e}\n{traceback.format_exc()}"))


def _get_result(q, workers, timeout, last_progress):
    """One result from ``q``, waiting in 5 s slices; raises when
    ``timeout`` seconds pass without progress or a worker died."""
    while True:
        try:
            return q.get(timeout=5)
        except queue.Empty:
            if timeout and _time.monotonic() - last_progress > timeout:
                raise RuntimeError(f"DataLoader worker timed out after "
                                   f"{timeout}s without a batch")
            dead = [w.pid for w in workers if not w.is_alive()]
            if dead:
                raise RuntimeError(
                    f"DataLoader worker(s) {dead} died unexpectedly "
                    "(OOM-killed or crashed in a native transform)")


class _MapWorkerPool:
    """Ordered multiprocess prefetch for map-style datasets: per-worker
    index queues (batches dealt round-robin), one result queue, and a
    reorder buffer in the main process."""

    def __init__(self, loader):
        self.loader = loader
        ctx = mp.get_context("fork")
        n = loader.num_workers
        self.index_queues = [ctx.Queue() for _ in range(n)]
        self.result_queue = ctx.Queue()
        base_seed = int(np.random.randint(0, 2 ** 31))
        self.workers = [
            ctx.Process(
                target=_map_worker_loop,
                args=(loader.dataset, self.index_queues[i], self.result_queue,
                      loader.collate_fn, i, n, base_seed + i,
                      loader.worker_init_fn),
                daemon=True)
            for i in range(n)
        ]
        for w in self.workers:
            w.start()
        self._epoch = 0
        self._active = False

    def run_epoch(self):
        if self._active:
            raise RuntimeError(
                "a persistent_workers DataLoader supports one live iterator "
                "at a time (two iterators would consume each other's "
                "batches); exhaust or drop the first iterator before "
                "starting another")
        self._active = True
        try:
            yield from self._run_epoch_inner()
        finally:
            self._active = False

    def _run_epoch_inner(self):
        loader = self.loader
        n = loader.num_workers
        # results of an abandoned earlier epoch may still sit in the result
        # queue: each request carries its epoch, and others are dropped
        self._epoch += 1
        epoch = self._epoch
        batches = list(loader.batch_sampler)
        depth = max(1, loader.prefetch_factor)
        sent, next_out, received = 0, 0, {}

        def dispatch():
            nonlocal sent
            if sent < len(batches):
                self.index_queues[sent % n].put((epoch, sent, batches[sent]))
                sent += 1

        for _ in range(min(len(batches), depth * n)):
            dispatch()
        # timeout: seconds without progress (per batch), as the reference
        last_progress = _time.monotonic()
        while next_out < len(batches):
            while next_out not in received:
                ep, bi, data, err = _get_result(
                    self.result_queue, self.workers, loader.timeout,
                    last_progress)
                if ep != epoch:
                    continue  # stale result from an abandoned epoch
                if err is not None:
                    raise RuntimeError(f"DataLoader worker failed: {err}")
                received[bi] = data
                last_progress = _time.monotonic()
            data = received.pop(next_out)
            next_out += 1
            dispatch()
            yield _from_transportable(data)

    def shutdown(self):
        """Sentinel every worker, then ``_stop`` them (draining the results
        of an abandoned epoch that they flush on their way out)."""
        for q in self.index_queues:
            try:
                q.put(None)
            except (OSError, ValueError):
                pass
        _stop(self.workers, self.result_queue)


def _stop(workers, result_queue, timeout=5.0):
    """Join ``workers``, draining ``result_queue`` meanwhile: a worker that
    put results nobody read flushes them into the pipe before it can exit,
    and joining it without reading would wait for ever. A worker alive
    after ``timeout`` seconds is terminated."""
    deadline = _time.monotonic() + timeout
    while (any(w.is_alive() for w in workers)
           and _time.monotonic() < deadline):
        try:
            result_queue.get(timeout=0.05)
        except queue.Empty:
            pass
    for w in workers:
        if w.is_alive():
            w.terminate()
        w.join(timeout=timeout)


def _collate_leaf(arr):
    return (_LEAF, arr) if _worker_mode else _batch_tensor(arr)


def default_collate_fn(batch):
    """Stack samples into batch leaves: Tensors, torch tensors, numpy
    arrays and numbers stack along a new first axis; lists / tuples and
    dicts collate field by field. Leaves are Tensors on the current place
    (numpy inside a worker)."""
    sample = batch[0]
    if isinstance(sample, (Tensor, torch.Tensor)):
        return _collate_leaf(np.stack(
            [np.asarray(getattr(b, "_value", b).detach().cpu())
             for b in batch]))
    if isinstance(sample, (np.ndarray, np.generic)):
        return _collate_leaf(np.stack(batch))
    if isinstance(sample, (int, float)):
        return _collate_leaf(np.asarray(batch))
    if isinstance(sample, (list, tuple)):
        return [default_collate_fn(list(s)) for s in zip(*batch)]
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    return batch


class DataLoader:
    """Batches of ``dataset`` (map-style: through ``batch_sampler`` or
    ``batch_size`` / ``shuffle`` / ``drop_last``; iterable-style: in its
    order), inline or from ``num_workers`` worker processes (see the module
    docstring). ``persistent_workers`` keeps one pool across epochs."""

    def __init__(self, dataset, feed_list=None, places=None, return_list=True,
                 batch_sampler=None, batch_size=1, shuffle=False,
                 drop_last=False, collate_fn=None, num_workers=0,
                 use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self.persistent_workers = persistent_workers
        self._pool = None
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("length of IterableDataset loader is unknown")
        return len(self.batch_sampler)

    def _iter_direct(self):
        if self._iterable_mode:
            batch = []
            for item in self.dataset:
                batch.append(item)
                if len(batch) == self.batch_size:
                    yield self.collate_fn(batch)
                    batch = []
            if batch and not self.drop_last:
                yield self.collate_fn(batch)
        else:
            for idxs in self.batch_sampler:
                yield self.collate_fn([self.dataset[i] for i in idxs])

    def _iter_multiprocess_map(self):
        pool = self._pool
        if pool is None:
            pool = _MapWorkerPool(self)
            if self.persistent_workers:
                self._pool = pool
        try:
            yield from pool.run_epoch()
        finally:
            if not self.persistent_workers:
                pool.shutdown()

    def _iter_multiprocess_iterable(self):
        ctx = mp.get_context("fork")
        # bounded: backpressure keeps ~n * prefetch_factor batches in flight
        result_queue = ctx.Queue(
            maxsize=max(2, self.num_workers * max(1, self.prefetch_factor)))
        n = self.num_workers
        base_seed = int(np.random.randint(0, 2 ** 31))
        workers = [
            ctx.Process(
                target=_iterable_worker_loop,
                args=(self.dataset, result_queue, self.collate_fn,
                      self.batch_size, self.drop_last, i, n, base_seed + i,
                      self.worker_init_fn),
                daemon=True)
            for i in range(n)
        ]
        for w in workers:
            w.start()
        done = 0
        last_progress = _time.monotonic()
        try:
            while done < n:
                _, data, err = _get_result(result_queue, workers,
                                           self.timeout, last_progress)
                if err is not None:
                    raise RuntimeError(f"DataLoader worker failed: {err}")
                last_progress = _time.monotonic()
                if data is None:
                    done += 1
                    continue
                yield _from_transportable(data)
        finally:
            if done < n:         # abandoned: the rest is not wanted
                for w in workers:
                    w.terminate()
            _stop(workers, result_queue)

    def __iter__(self):
        if self.num_workers == 0:
            return self._iter_direct()
        if self._iterable_mode:
            return self._iter_multiprocess_iterable()
        return self._iter_multiprocess_map()

    def __del__(self):
        pool = getattr(self, "_pool", None)
        if pool is not None:
            pool.shutdown()
