"""Content-addressed prefix cache over the paged KV pool — the counterpart
of ``paddle_tpu/inference/prefix_cache.py``.

Full KV blocks are indexed by a chain digest of their token content —
``digest_i = blake2b(digest_{i-1} || tokens[i*BS:(i+1)*BS])``, 16 bytes,
the int64 tokens' bytes, rooted at ``seed`` — so a digest names the whole
prefix behind a block and a chain match is a prefix match. The digests are
the JAX package's, byte for byte.

Sharing is copy-on-write at block granularity, and never copies:

* match — admission hashes the prompt's full blocks, capped at
  ``plen - 1`` tokens (the last prompt token always prefills again: the
  cache holds KV rows, not logits), and walks the index for the longest
  indexed chain;
* share — ``PagedKVCache.reserve(..., shared=hit.pairs)`` revalidates the
  chain under the pool lock (truncated at the first stale link), bumps the
  blocks' refcounts and puts them first in the request's table. Every
  prefill, decode and verify write lands at rows ``>= plen``, past every
  shared block;
* park — a released indexed block whose refcount reaches zero stays
  resident and matchable in an LRU tier;
* reclaim — under pool pressure ``_evict_lru`` drains the parked tier
  LRU-first (after finished-but-retained requests), dropping the index
  entries as the blocks go back to the allocator.

Locking: this index has its own ``threading.RLock``, and the order is
``PagedKVCache._lock -> PrefixCache._lock``: ``_acquire``, ``_park`` and
``_reclaim`` run with the pool lock held; ``lookup`` takes only this lock;
``register`` and ``purge`` take the pool lock first.

``faults=`` (an ``inference.faults.FaultInjector``; default: the pool's)
checks ``kv.prefix_match`` at the entry of ``lookup`` (the scheduler takes
any lookup failure as a miss) and ``kv.prefix_evict`` at the entry of
``_reclaim``, inside ``reserve``'s atomic section.

A chain rooted at a non-empty ``seed`` (an adapter's registration seed,
``inference.adapters``) never matches a chain of another seed, so KV
computed under one adapter is never shared with another, nor with the
base model.
"""
from __future__ import annotations

import hashlib
import itertools
import threading

import numpy as np

from ..analysis.lockwitness import make_rlock

__all__ = ["PrefixCache", "PrefixHit"]

_DIGEST_BYTES = 16


class _Entry:
    __slots__ = ("block", "touch")

    def __init__(self, block, touch):
        self.block = block
        self.touch = touch


class PrefixHit:
    """A lookup's result: the prompt's full-block digest chain (for later
    registration) and the matched ``(digest, block)`` prefix of it, a hint
    that ``reserve`` revalidates."""

    __slots__ = ("digests", "pairs")

    def __init__(self, digests, pairs):
        self.digests = digests
        self.pairs = pairs


class PrefixCache:
    """Content index and LRU parked tier over one ``PagedKVCache``; built,
    it attaches itself to the pool (``attach_prefix_cache``). The first
    writer of a digest wins; a later one keeps its private block."""

    def __init__(self, kv_cache, faults=None):
        self.kv = kv_cache
        self._faults = (faults if faults is not None
                        else getattr(kv_cache, "_faults", None))
        self.block_size = int(kv_cache.block_size)
        self._index: dict[bytes, _Entry] = {}
        self._by_block: dict[int, bytes] = {}
        self._parked: set[int] = set()
        self._clock = itertools.count()
        self.hits = 0                 # lookups that matched >= 1 block
        self.misses = 0
        self.evicted_blocks_total = 0  # parked blocks reclaimed under pressure
        self._lock = make_rlock("prefix_cache.PrefixCache._lock")
        kv_cache.attach_prefix_cache(self)

    # -------------------------------------------------------------- hashing
    def hash_blocks(self, tokens, seed=b"") -> list:
        """Chain digests of every FULL block of ``tokens``; digest ``i``
        commits to the tokens of blocks ``0..i``."""
        toks = np.ascontiguousarray(np.asarray(tokens, np.int64))
        bs = self.block_size
        out = []
        parent = bytes(seed)
        for i in range(len(toks) // bs):
            h = hashlib.blake2b(parent, digest_size=_DIGEST_BYTES)
            h.update(toks[i * bs:(i + 1) * bs].tobytes())
            parent = h.digest()
            out.append(parent)
        return out

    # --------------------------------------------------------------- lookup
    def lookup(self, prompt, seed=b"") -> PrefixHit:
        """Longest indexed chain over the prompt's full blocks, capped at
        ``plen - 1`` tokens. Takes only this index's lock."""
        if self._faults is not None:
            self._faults.check("kv.prefix_match")
        prompt = np.asarray(prompt).reshape(-1)
        n_match = max(0, (len(prompt) - 1) // self.block_size)
        digests = self.hash_blocks(prompt, seed=seed)
        pairs = []
        with self._lock:
            now = next(self._clock)
            for d in digests[:n_match]:
                e = self._index.get(d)
                if e is None:
                    break
                e.touch = now          # popular prefixes stay resident
                pairs.append((d, e.block))
            if pairs:
                self.hits += 1
            else:
                self.misses += 1
        return PrefixHit(digests, pairs)

    # ------------------------------------------------------------- indexing
    def register(self, request_id, tokens, digests=None, length=None,
                 seed=b"") -> int:
        """Index ``request_id``'s full, committed blocks under their
        digests; returns how many entries were added. Only rows written to
        the pool are indexable: the cap is the pool's committed length, or
        ``length`` where the caller tracks committed rows itself (decode
        and verify ticks do). Lock order: pool, then index."""
        kv = self.kv
        with kv._lock:
            req = kv._requests.get(request_id)
            if req is None:
                return 0
            cap = len(req.blocks) * self.block_size
            committed = int(req.length) if length is None else int(length)
            committed = min(committed, cap)
            blocks = list(req.blocks)
            n_full = min(committed, len(tokens)) // self.block_size
            if n_full <= 0:
                return 0
            if digests is None:
                digests = self.hash_blocks(
                    np.asarray(tokens)[: n_full * self.block_size],
                    seed=seed)
            if len(digests) < n_full:
                raise ValueError(
                    f"register: {len(digests)} digests for {n_full} blocks")
            added = 0
            with self._lock:
                now = next(self._clock)
                for i in range(n_full):
                    d = digests[i]
                    if d in self._index or blocks[i] in self._by_block:
                        continue      # first writer won, or block re-indexed
                    self._index[d] = _Entry(blocks[i], now)
                    self._by_block[blocks[i]] = d
                    added += 1
            return added

    # ------------------------------------------------- pool-internal hooks
    # all three run with PagedKVCache._lock held (pool -> index order)
    def _acquire(self, pairs) -> list:
        """Revalidate a lookup's chain at reserve time: stop at the first
        pair whose digest no longer maps to that block. Acquired parked
        blocks leave the tier; the caller takes the refcount."""
        out = []
        with self._lock:
            for d, b in pairs:
                e = self._index.get(d)
                if e is None or e.block != b:
                    break
                self._parked.discard(b)
                out.append(b)
        return out

    def _park(self, block) -> bool:
        """Refcount reached zero: keep an indexed block resident (True),
        else the pool frees it (False)."""
        with self._lock:
            if block not in self._by_block:
                return False
            self._parked.add(block)
            return True

    def _reclaim(self, need: int) -> list:
        """Evict up to ``need`` parked blocks LRU-first, dropping their
        index entries; returns the block ids for the pool to free."""
        if self._faults is not None:
            self._faults.check("kv.prefix_evict")
        with self._lock:
            order = sorted(
                self._parked,
                key=lambda b: self._index[self._by_block[b]].touch)
            out = []
            for b in order[:max(0, int(need))]:
                self._parked.discard(b)
                d = self._by_block.pop(b)
                self._index.pop(d, None)
                out.append(b)
            self.evicted_blocks_total += len(out)
            return out

    # ----------------------------------------------------------------- ops
    def purge(self) -> int:
        """Every parked block back to the allocator (entries of blocks that
        live requests hold stay); returns how many went."""
        with self.kv._lock:
            blocks = self._reclaim(self.kv.num_blocks)
            if blocks:
                self.kv.allocator.free(blocks)
            return len(blocks)

    # -------------------------------------------------------- observability
    def cached_blocks(self) -> int:
        with self._lock:
            return len(self._parked)

    def indexed_blocks(self) -> int:
        with self._lock:
            return len(self._by_block)

    def _tier_snapshot(self):
        """(parked set, indexed block set), for ``check_conservation``."""
        with self._lock:
            return set(self._parked), set(self._by_block)

    def bind_metrics(self, registry, component="continuous"):
        """``paddle_prefix_cache_blocks{component, state=cached|shared|
        indexed}`` as scrape-time gauges and the eviction counter."""
        g = registry.gauge(
            "paddle_prefix_cache_blocks",
            "Prefix-cache blocks by state: cached (parked, refcount 0), "
            "shared (refcount >= 2), indexed (matchable)",
            labels=("component", "state"))
        g.labels(component, "cached").set_function(self.cached_blocks)
        g.labels(component, "indexed").set_function(self.indexed_blocks)
        g.labels(component, "shared").set_function(
            lambda: self.kv.shared_block_count)
        registry.counter(
            "paddle_prefix_cache_evicted_blocks_total",
            "Parked prefix blocks reclaimed under pool pressure",
            labels=("component",)).labels(component).set_function(
                lambda: self.evicted_blocks_total)
        return self
