"""Block-paged KV cache — the counterpart of
``paddle_tpu/inference/kv_cache.py``.

One shared per-layer page pool on the device, head-leading
``[Hkv, P, BS, D]``; each request owns a block table (host ints) that the
paged attention kernel reads. Host side is bookkeeping only: a free-list
allocator with LIFO reuse, per-request tables and lengths, and LRU
eviction of finished-but-retained requests when the pool runs dry.

The pools are torch tensors updated IN PLACE by the step programs, so
there is no functional commit: ``commit()`` only checks that the pools it
is handed are this cache's own. Each pool holds one page more than
``num_blocks``: page ``num_blocks`` is a scratch page that the allocator
never hands out and no block table names. The step programs write every
row of a step, and aim the rows a step drops (idle slots, padding, rows
past a ceiling or a table) at its first slot, ``scratch_slot``; only
pages ``[0, num_blocks)`` hold live rows. The prefix cache, fault
injection, mesh sharding and metrics binding of the JAX class are not
ported yet.
"""
from __future__ import annotations

import itertools
import math
import threading

import numpy as np
import torch

from ..framework import resolve_device

__all__ = ["CacheOutOfBlocks", "BlockAllocator", "PagedKVCache"]


_UIDS = itertools.count()    # process-unique cache ids (step-program keys)


class CacheOutOfBlocks(RuntimeError):
    """The pool cannot satisfy an allocation even after eviction."""


class BlockAllocator:
    """Fixed-population free-list block allocator with LIFO reuse (the most
    recently freed block is handed out first)."""

    def __init__(self, num_blocks: int):
        self.num_blocks = int(num_blocks)
        self._free = list(range(self.num_blocks - 1, -1, -1))
        self._live: set[int] = set()

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.num_blocks - len(self._free)

    def allocate(self, n: int) -> list[int]:
        if n > len(self._free):
            raise CacheOutOfBlocks(
                f"need {n} blocks, {len(self._free)} free of {self.num_blocks}")
        out = self._free[-n:][::-1]
        del self._free[len(self._free) - n:]
        self._live.update(out)
        return out

    def free(self, blocks) -> None:
        blocks = list(blocks)
        for b in blocks:
            if not (0 <= b < self.num_blocks):
                raise ValueError(f"block {b} outside pool")
            if b not in self._live:
                raise ValueError(f"double free of block {b} (not live)")
        self._live.difference_update(blocks)
        self._free.extend(blocks)


class _Request:
    __slots__ = ("blocks", "length", "done", "touch")

    def __init__(self, blocks, length, touch):
        self.blocks = blocks
        self.length = length
        self.done = False
        self.touch = touch


class PagedKVCache:
    """Shared device page pool + per-request block tables.

    ``device`` defaults to CUDA and raises on a machine without it unless
    the caller passes ``device="cpu"``."""

    def __init__(self, num_layers, num_kv_heads, head_dim, block_size=128,
                 num_blocks=64, dtype=torch.bfloat16, device="cuda"):
        self.num_layers = int(num_layers)
        self.num_kv_heads = int(num_kv_heads)
        self.head_dim = int(head_dim)
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        self.dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        self.device = resolve_device(device)
        shape = (self.num_kv_heads, self.num_blocks + 1, self.block_size,
                 self.head_dim)                 # + the scratch page
        self.k_pages = [torch.zeros(shape, dtype=self.dtype,
                                    device=self.device)
                        for _ in range(self.num_layers)]
        self.v_pages = [torch.zeros(shape, dtype=self.dtype,
                                    device=self.device)
                        for _ in range(self.num_layers)]
        self.allocator = BlockAllocator(self.num_blocks)
        # the captured step programs hold these pools' addresses: their
        # cache keys carry this id, never reused by another cache
        self.uid = next(_UIDS)
        self._requests: dict = {}
        self._clock = itertools.count()
        self.evictions = 0          # finished-but-retained requests reclaimed
        self.evicted_blocks = 0     # blocks those evictions returned
        # hit from HTTP handler threads (admission checks) and the batcher
        # thread (reserve/release); re-entrant: reserve -> _evict_lru ->
        # release
        self._lock = threading.RLock()

    def signature(self):
        """Hashable shape identity for step-program cache keys (JAX
        ``kv_cache.py:149-152``)."""
        return (self.num_layers, self.num_kv_heads, self.head_dim,
                self.block_size, self.num_blocks, str(self.dtype))

    @property
    def scratch_slot(self) -> int:
        """The flat pool slot (page * block_size + row) that takes the rows
        a fixed-length write drops: the first row of the scratch page."""
        return self.num_blocks * self.block_size

    def blocks_for(self, seq_len: int) -> int:
        return max(1, math.ceil(seq_len / self.block_size))

    # ----------------------------------------------------------- allocation
    def reserve(self, request_id, max_seq_len: int, evict: bool = True):
        """Allocate blocks covering max_seq_len for a new request; returns
        its block table as int32. When the free list runs dry and ``evict``,
        finished-but-retained requests are evicted least recently used
        first. Atomic: nothing is evicted when eviction still could not
        cover the allocation."""
        with self._lock:
            if request_id in self._requests:
                raise ValueError(f"request {request_id!r} already reserved")
            n = self.blocks_for(max_seq_len)
            if self.allocator.available < n:
                shortfall = n - self.allocator.available
                evictable = self._evictable_locked() if evict else 0
                if evictable < shortfall:
                    raise CacheOutOfBlocks(
                        f"need {n} blocks, {self.allocator.available} free "
                        f"+ {evictable} evictable of {self.num_blocks}")
                self._evict_lru(shortfall)
            blocks = self.allocator.allocate(n)
            self._requests[request_id] = _Request(blocks, 0,
                                                  next(self._clock))
            return np.asarray(blocks, np.int32)

    def _evict_lru(self, need: int):
        with self._lock:
            done = sorted((r for r in self._requests.items() if r[1].done),
                          key=lambda kv: kv[1].touch)
            freed = 0
            for rid, req in done:
                if freed >= need:
                    break
                self.evictions += 1
                self.release(rid)
                freed += len(req.blocks)
                self.evicted_blocks += len(req.blocks)

    def mark_done(self, request_id):
        """Request finished; its pages stay readable but become evictable."""
        with self._lock:
            self._requests[request_id].done = True

    def release(self, request_id):
        with self._lock:
            req = self._requests.pop(request_id)
            self.allocator.free(req.blocks)

    # ------------------------------------------------------------- metadata
    def block_table(self, request_id, pad_to=None):
        """int32 table of page ids, padded with page 0 (the kernel needs
        valid page ids in dead entries; it never reads them)."""
        with self._lock:
            req = self._requests[request_id]
            req.touch = next(self._clock)
            tbl = list(req.blocks)
        if pad_to is not None:
            tbl += [0] * (int(pad_to) - len(tbl))
        return np.asarray(tbl, np.int32)

    def length(self, request_id) -> int:
        with self._lock:
            return self._requests[request_id].length

    def append_tokens(self, request_id, n: int) -> int:
        """Advance the request's live length by ``n`` rows (monotonic,
        capacity-checked); returns the new length."""
        if n < 0:
            raise ValueError(f"append_tokens: n must be >= 0, got {n}")
        with self._lock:
            req = self._requests[request_id]
            new = req.length + int(n)
            if new > len(req.blocks) * self.block_size:
                raise ValueError(
                    f"length {new} exceeds reserved capacity "
                    f"{len(req.blocks) * self.block_size}")
            req.length = new
            req.touch = next(self._clock)
            return new

    def set_length(self, request_id, n: int):
        with self._lock:
            req = self._requests[request_id]
            if n > len(req.blocks) * self.block_size:
                raise ValueError(
                    f"length {n} exceeds reserved capacity "
                    f"{len(req.blocks) * self.block_size}")
            req.length = int(n)

    @property
    def blocks_in_use(self) -> int:
        return self.allocator.in_use

    @property
    def free_blocks(self) -> int:
        return self.allocator.available

    def _evictable_locked(self) -> int:
        return sum(len(r.blocks) for r in self._requests.values() if r.done)

    @property
    def live_utilization(self) -> float:
        """Fraction of the pool held by still-decoding requests."""
        with self._lock:
            return ((self.allocator.in_use - self._evictable_locked())
                    / self.num_blocks)

    # ----------------------------------------------------------- invariants
    def check_conservation(self) -> dict:
        """Audit of the allocator + request bookkeeping; raises
        AssertionError on a violation, returns the recomputed stats. Every
        allocated block has exactly one owner; free and live partition the
        pool; every length fits its reservation."""
        with self._lock:
            owner: dict[int, object] = {}
            for rid, req in self._requests.items():
                for b in req.blocks:
                    assert 0 <= b < self.num_blocks, \
                        f"request {rid!r} holds out-of-pool block {b}"
                    assert b not in owner, \
                        f"block {b} held by {owner[b]!r} and {rid!r}"
                    owner[b] = rid
                cap = len(req.blocks) * self.block_size
                assert req.length <= cap, \
                    (f"request {rid!r} length {req.length} exceeds "
                     f"capacity {cap}")
            live = self.allocator._live
            assert set(owner) == live, \
                (f"held != allocator live set (held-not-live="
                 f"{set(owner) - live}, live-not-held={live - set(owner)})")
            free = set(self.allocator._free)
            assert len(free) == len(self.allocator._free), \
                "free list contains duplicates"
            assert not (free & live), f"blocks both free and live: {free & live}"
            assert len(free) + len(live) == self.num_blocks, \
                (f"free ({len(free)}) + live ({len(live)}) != "
                 f"pool size {self.num_blocks}")
            evictable = self._evictable_locked()
            stats = {"live": len(live), "free": len(free),
                     "evictable": evictable,
                     "requests": len(self._requests),
                     "live_utilization": (len(live) - evictable)
                     / self.num_blocks}
        return stats

    # ------------------------------------------------------------ device I/O
    def commit(self, k_pages, v_pages):
        """The step programs update the pools in place; this only checks
        that the pools handed back are this cache's own tensors."""
        if (len(k_pages) != self.num_layers
                or any(a is not b for a, b in zip(k_pages, self.k_pages))
                or any(a is not b for a, b in zip(v_pages, self.v_pages))):
            raise ValueError("commit() takes this cache's own pools; the "
                             "port updates them in place")

    def gather(self, request_id, layer: int):
        """Contiguous [length, Hkv, D] (k, v) copies of a request's cache on
        the host — a debug/audit path; the kernel never gathers."""
        with self._lock:
            req = self._requests[request_id]
            n = self.blocks_for(max(req.length, 1))
            tbl = torch.as_tensor(req.blocks[:n], device=self.device)

            def dense(pages):
                arr = pages[:, tbl].reshape(self.num_kv_heads, -1,
                                            self.head_dim)
                return arr.transpose(0, 1)[:req.length].cpu()

            return dense(self.k_pages[layer]), dense(self.v_pages[layer])
