"""Block-paged KV cache — the counterpart of
``paddle_tpu/inference/kv_cache.py``.

One shared per-layer page pool on the device, head-leading
``[Hkv, P, BS, D]``; each request owns a block table (host ints) that the
paged attention kernel reads. Host side is bookkeeping only: a free-list
allocator with LIFO reuse, per-request tables and lengths, per-block
refcounts, and LRU eviction of finished-but-retained requests (then of the
prefix cache's parked tier) when the pool runs dry.

The pools are torch tensors updated IN PLACE by the step programs, so
there is no functional commit: ``commit()`` only checks that the pools it
is handed are this cache's own. Each pool holds one page more than
``num_blocks``: page ``num_blocks`` is a scratch page that the allocator
never hands out and no block table names. The step programs write every
row of a step, and aim the rows a step drops (idle slots, padding, rows
past a ceiling or a table) at its first slot, ``scratch_slot``; only
pages ``[0, num_blocks)`` hold live rows. The scratch page is never
handed out, indexed, parked or counted.

With a ``PrefixCache`` attached (``attach_prefix_cache``), a reservation
can lead with shared blocks (``reserve(..., shared=pairs)``), release frees
a block only when its last holder lets go, and a refcount-zero indexed
block parks in the prefix tier instead of freeing. ``faults=`` (an
``inference.faults.FaultInjector``) checks ``kv.reserve`` and
``kv.allocate``.

Under tensor parallelism (``tp_group=``, else the global mesh's "tp" axis,
as JAX's class reads its mesh, :113-130) the pool is head-sharded: each
rank holds ``[Hkv / tp, P, BS, D]`` per layer, its own kv heads, which its
step programs attend with. ``pool_bytes()`` is the logical pool's bytes,
``per_chip_pool_bytes()`` this rank's (1/tp of them), and the
``paddle_kv_pool_per_chip_bytes`` gauge reads the latter. tp must divide
the kv heads (GQA groups stay whole). Host bookkeeping is the same on
every rank; the continuous scheduler keeps it on rank 0 and sends the
tables to the others with each tick.
"""
from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from ..analysis.lockwitness import make_rlock
from ..framework import resolve_device

__all__ = ["CacheOutOfBlocks", "BlockAllocator", "PagedKVCache"]


_UIDS = itertools.count()    # process-unique cache ids (step-program keys)


class CacheOutOfBlocks(RuntimeError):
    """The pool cannot satisfy an allocation even after eviction."""


class BlockAllocator:
    """Fixed-population free-list block allocator with LIFO reuse (the most
    recently freed block is handed out first)."""

    def __init__(self, num_blocks: int, faults=None):
        self.num_blocks = int(num_blocks)
        self._free = list(range(self.num_blocks - 1, -1, -1))
        self._live: set[int] = set()
        self._faults = faults   # FaultInjector | None

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.num_blocks - len(self._free)

    def allocate(self, n: int) -> list[int]:
        if self._faults is not None:
            self._faults.check("kv.allocate")   # may raise CacheOutOfBlocks
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
                 num_blocks=64, dtype=torch.bfloat16, device="cuda",
                 faults=None, tp_group=None):
        from ..distributed.mesh import axis_group

        self.num_layers = int(num_layers)
        self.num_kv_heads = int(num_kv_heads)
        # None: the global mesh's "tp" axis; False: no sharding
        group = (None if tp_group is False else
                 tp_group if tp_group is not None else axis_group("tp"))
        if group is not None and group.nranks <= 1:
            group = None
        if group is not None and self.num_kv_heads % group.nranks:
            raise ValueError(f"tp={group.nranks} must divide the "
                             f"{self.num_kv_heads} kv heads")
        self.tp_group = group
        self.tp_sharded = group is not None
        self.tp = 1 if group is None else group.nranks
        self.local_kv_heads = self.num_kv_heads // self.tp
        self.head_dim = int(head_dim)
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        self.dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        self.device = resolve_device(device)
        shape = (self.local_kv_heads, self.num_blocks + 1, self.block_size,
                 self.head_dim)                 # + the scratch page
        self.k_pages = [torch.zeros(shape, dtype=self.dtype,
                                    device=self.device)
                        for _ in range(self.num_layers)]
        self.v_pages = [torch.zeros(shape, dtype=self.dtype,
                                    device=self.device)
                        for _ in range(self.num_layers)]
        self.allocator = BlockAllocator(self.num_blocks, faults=faults)
        self._faults = faults
        # the captured step programs hold these pools' addresses: their
        # cache keys carry this id, never reused by another cache
        self.uid = next(_UIDS)
        self._requests: dict = {}
        self._clock = itertools.count()
        self.evictions = 0          # finished-but-retained requests reclaimed
        self.evicted_blocks = 0     # blocks those evictions returned
        # holders per allocated block: exactly 1 without a prefix cache;
        # reserve(shared=...) bumps them, release frees only at zero
        self._block_refs: dict[int, int] = {}
        self._prefix = None         # PrefixCache | None
        # hit from HTTP handler threads (admission checks) and the batcher
        # thread (reserve/release); re-entrant: reserve -> _evict_lru ->
        # release; taken before PrefixCache._lock, never after
        self._lock = make_rlock("kv_cache.PagedKVCache._lock")

    def signature(self):
        """Hashable shape identity for step-program cache keys (JAX
        ``kv_cache.py:149-152``)."""
        sig = (self.num_layers, self.num_kv_heads, self.head_dim,
               self.block_size, self.num_blocks, str(self.dtype))
        if self.tp_sharded:       # a program over a head shard of a group
            sig += (("tp", self.tp_group.id),)
        return sig

    @property
    def scratch_slot(self) -> int:
        """The flat pool slot (page * block_size + row) that takes the rows
        a fixed-length write drops: the first row of the scratch page."""
        return self.num_blocks * self.block_size

    def blocks_for(self, seq_len: int) -> int:
        return max(1, math.ceil(seq_len / self.block_size))

    def per_chip_pool_bytes(self) -> int:
        """Bytes of this rank's K and V pools of every layer, the scratch
        page included (what its device holds)."""
        return sum(p.numel() * p.element_size()
                   for p in self.k_pages + self.v_pages)

    def pool_bytes(self) -> int:
        """Bytes of the logical pool: every rank's shard together."""
        return self.per_chip_pool_bytes() * self.tp

    def attach_prefix_cache(self, prefix):
        """Wire a PrefixCache into release and eviction (JAX
        ``kv_cache.py:170-177``)."""
        with self._lock:
            if self._prefix is not None and self._prefix is not prefix:
                raise ValueError("a prefix cache is already attached")
            self._prefix = prefix

    def bind_metrics(self, registry, pool="kv"):
        """The pool's state as scrape-time series (JAX
        ``kv_cache.py:180-222``): ``paddle_kv_pool_blocks{pool, state=
        live|free|evictable}`` (they partition the pool),
        ``paddle_kv_pool_size_blocks``, ``paddle_kv_pool_live_utilization``,
        ``paddle_kv_pool_evictions_total`` and
        ``paddle_kv_pool_per_chip_bytes`` (this rank's pools' bytes on
        its card, the scratch page included: 1/tp of the logical pool
        under tensor parallelism)."""
        blocks = registry.gauge(
            "paddle_kv_pool_blocks",
            "KV page-pool blocks by state; live+free+evictable == pool size",
            labels=("pool", "state"))
        blocks.labels(pool, "live").set_function(
            lambda: self.blocks_in_use - self.evictable_blocks)
        blocks.labels(pool, "free").set_function(lambda: self.free_blocks)
        blocks.labels(pool, "evictable").set_function(
            lambda: self.evictable_blocks)
        registry.gauge(
            "paddle_kv_pool_size_blocks", "Total blocks in the KV page pool",
            labels=("pool",)).labels(pool).set_function(
                lambda: self.num_blocks)
        registry.gauge(
            "paddle_kv_pool_live_utilization",
            "Fraction of the pool held by still-decoding requests "
            "(the admission-control pressure signal)",
            labels=("pool",)).labels(pool).set_function(
                lambda: self.live_utilization)
        registry.counter(
            "paddle_kv_pool_evictions_total",
            "Finished-but-retained requests evicted LRU to cover new "
            "reservations", labels=("pool",)).labels(pool).set_function(
                lambda: self.evictions)
        registry.gauge(
            "paddle_kv_pool_per_chip_bytes",
            "KV pool bytes resident PER CHIP — 1/tp of the logical pool "
            "when the pool is head-sharded over the serving mesh's tp axis",
            labels=("pool",)).labels(pool).set_function(
                self.per_chip_pool_bytes)
        return self

    # ----------------------------------------------------------- allocation
    def reserve(self, request_id, max_seq_len: int, evict: bool = True,
                shared=None):
        """Allocate blocks covering max_seq_len for a new request; returns
        its block table as int32. When the free list runs dry and ``evict``,
        finished-but-retained requests are evicted least recently used
        first, then the prefix cache's parked tier.

        ``shared``: (digest, block) pairs of a ``PrefixCache.lookup``,
        revalidated here under the lock (truncated at the first stale
        link). The validated blocks take a refcount and lead the table; the
        request's committed length starts at ``n_shared * block_size``.

        Atomic: either the request is fully reserved or the cache is as it
        was — nothing is evicted when eviction still could not cover the
        allocation, and a failed reservation re-parks what it acquired."""
        with self._lock:
            if self._faults is not None:
                self._faults.check("kv.reserve")  # injected pool-dry faults
            if request_id in self._requests:
                raise ValueError(f"request {request_id!r} already reserved")
            n = self.blocks_for(max_seq_len)
            acquired: list[int] = []
            if shared and self._prefix is not None:
                # refcounts first, so an eviction below can neither free
                # nor park these blocks
                acquired = self._prefix._acquire(list(shared)[:n])
                for b in acquired:
                    self._block_refs[b] = self._block_refs.get(b, 0) + 1
            try:
                need_new = n - len(acquired)
                if self.allocator.available < need_new:
                    shortfall = need_new - self.allocator.available
                    evictable = self._evictable_locked() if evict else 0
                    if evictable < shortfall:
                        raise CacheOutOfBlocks(
                            f"need {need_new} blocks, "
                            f"{self.allocator.available} free + {evictable} "
                            f"evictable of {self.num_blocks}")
                    self._evict_lru(shortfall)
                fresh = self.allocator.allocate(need_new)
            except BaseException:
                for b in acquired:     # undo: the cache as it was
                    self._unref(b)
                raise
            for b in fresh:
                self._block_refs[b] = 1
            blocks = acquired + fresh
            self._requests[request_id] = _Request(
                blocks, len(acquired) * self.block_size, next(self._clock))
            return np.asarray(blocks, np.int32)

    def _evict_lru(self, need: int):
        with self._lock:
            done = sorted((r for r in self._requests.items() if r[1].done),
                          key=lambda kv: kv[1].touch)
            freed = 0
            for rid, _ in done:
                if freed >= need:
                    break
                # blocks shared with live requests (or parked by the index)
                # do not come home: count what the release actually freed
                avail0 = self.allocator.available
                self.evictions += 1
                self.release(rid)
                got = self.allocator.available - avail0
                freed += got
                self.evicted_blocks += got
            if freed < need and self._prefix is not None:
                got = self._prefix._reclaim(need - freed)
                if got:
                    self.allocator.free(got)
                    self.evicted_blocks += len(got)

    def mark_done(self, request_id):
        """Request finished; its pages stay readable but become evictable."""
        with self._lock:
            self._requests[request_id].done = True

    def release(self, request_id):
        with self._lock:
            req = self._requests.pop(request_id)
            for b in req.blocks:
                self._unref(b)

    def _unref(self, block: int):
        """Drop one holder. At zero an indexed block parks in the prefix
        tier; any other goes back to the allocator."""
        with self._lock:
            r = self._block_refs[block] - 1
            if r > 0:
                self._block_refs[block] = r
                return
            del self._block_refs[block]
            if self._prefix is not None and self._prefix._park(block):
                return
            self.allocator.free([block])

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

    @property
    def evictable_blocks(self) -> int:
        """Blocks reclaimable on demand: held only by finished-but-retained
        requests, plus the prefix cache's parked tier."""
        with self._lock:
            return self._evictable_locked()

    def _evictable_locked(self) -> int:
        done_held: set[int] = set()
        live_held: set[int] = set()
        for r in self._requests.values():
            (done_held if r.done else live_held).update(r.blocks)
        n = len(done_held - live_held)
        if self._prefix is not None:
            n += self._prefix.cached_blocks()
        return n

    @property
    def shared_block_count(self) -> int:
        """Blocks that two or more request tables hold."""
        with self._lock:
            return sum(1 for v in self._block_refs.values() if v > 1)

    @property
    def utilization(self) -> float:
        """Fraction of the pool's blocks allocated (retained ones too)."""
        return self.allocator.in_use / self.num_blocks

    @property
    def live_utilization(self) -> float:
        """Fraction of the pool held by still-decoding requests."""
        with self._lock:
            return ((self.allocator.in_use - self._evictable_locked())
                    / self.num_blocks)

    # ----------------------------------------------------------- invariants
    def check_conservation(self) -> dict:
        """Audit of the allocator, request and refcount bookkeeping (JAX
        ``kv_cache.py:421-494``); raises AssertionError on a violation,
        returns the recomputed stats. No block twice in one table; every
        refcount equals a recount of its holders; held and parked blocks
        are disjoint and together the allocator's live set; parked blocks
        are indexed and indexed blocks live; free and live partition the
        pool (the scratch page is in neither); every length fits its
        reservation."""
        with self._lock:
            holders: dict[int, int] = {}
            for rid, req in self._requests.items():
                seen_here: set[int] = set()
                for b in req.blocks:
                    assert 0 <= b < self.num_blocks, \
                        f"request {rid!r} holds out-of-pool block {b}"
                    assert b not in seen_here, \
                        f"block {b} appears twice in {rid!r}'s table"
                    seen_here.add(b)
                    holders[b] = holders.get(b, 0) + 1
                cap = len(req.blocks) * self.block_size
                assert req.length <= cap, \
                    (f"request {rid!r} length {req.length} exceeds "
                     f"capacity {cap}")
            if holders != self._block_refs:
                diff = {b: (holders.get(b), self._block_refs.get(b))
                        for b in set(holders) | set(self._block_refs)
                        if holders.get(b) != self._block_refs.get(b)}
                raise AssertionError(
                    f"refcounts diverge from recounted holders "
                    f"(block: (recount, refs)) = {diff}")
            held = set(holders)
            if self._prefix is not None:
                parked, indexed = self._prefix._tier_snapshot()
            else:
                parked, indexed = set(), set()
            assert not (held & parked), \
                f"blocks both held and parked: {held & parked}"
            live = self.allocator._live
            assert held | parked == live, \
                (f"held | parked != allocator live set "
                 f"(not live={(held | parked) - live}, "
                 f"unaccounted={live - held - parked})")
            assert parked <= indexed, \
                f"parked blocks missing from index: {parked - indexed}"
            assert indexed <= live, \
                f"index names freed blocks: {indexed - live}"
            free = set(self.allocator._free)
            assert len(free) == len(self.allocator._free), \
                "free list contains duplicates"
            assert not (free & live), f"blocks both free and live: {free & live}"
            assert len(free) + len(live) == self.num_blocks, \
                (f"free ({len(free)}) + live ({len(live)}) != "
                 f"pool size {self.num_blocks}")
            evictable = self._evictable_locked()
            expect_live_util = (len(live) - evictable) / self.num_blocks
            n_requests = len(self._requests)
            got = self.live_utilization
        assert abs(got - expect_live_util) < 1e-9, \
            f"live_utilization {got} != ground truth {expect_live_util}"
        return {"live": len(live), "free": len(free), "evictable": evictable,
                "cached": len(parked), "shared":
                    sum(1 for v in holders.values() if v > 1),
                "requests": n_requests, "live_utilization": got}

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
                arr = pages[:, tbl].reshape(self.local_kv_heads, -1,
                                            self.head_dim)
                return arr.transpose(0, 1)[:req.length].cpu()

            return dense(self.k_pages[layer]), dense(self.v_pages[layer])
