"""Continuous (in-flight) batching over the paged KV pool — the core of
``paddle_tpu/inference/scheduler.py``'s
``ContinuousGenerateBatchingPredictor``.

A persistent tick loop over a fixed set of S slots:

* admit — queued requests take free slots FIFO by atomically reserving
  their blocks from the shared pool; a dry pool defers or sheds THAT
  request only.
* prefill — prompts are split into fixed-width chunks; each tick spends at
  most ``prefill_token_budget`` prompt tokens across slots in ONE
  ``prefill_chunk`` launch, so a long prompt never stalls the decoders for
  more than a chunk.
* decode — every decoding slot advances ``decode_steps`` tokens in ONE
  ``decode_step`` call.
* retire — finished / EOS / expired / cancelled sequences free their
  blocks and slot at the tick boundary.

When the pool's signature does not match the model, the tick loop hands
over to the base class's collect-and-run loop, which serves each request
through dense ``generate()`` (JAX ``scheduler.py:977-981``).

Not ported yet: the scheduler's speculative ``spec_k`` knob (the
single-stream ``verify_step`` loop is ``inference/speculative.py``), the
prefix cache, adapters, QoS, SLO monitor, flight recorder, utilization
ledger, AOT warmup, streaming and the replica fleet.
"""
from __future__ import annotations

import itertools
import queue
import threading

import numpy as np

from .kv_cache import CacheOutOfBlocks
from .resilience import DeadlineExceeded, ServiceUnavailable
from .serving import _PENDING, GenerateBatchingPredictor

__all__ = ["ContinuousGenerateBatchingPredictor"]

_PREFILL, _DECODE = "prefill", "decode"


class _SlotSeq:
    """One in-flight sequence bound to a scheduler slot."""

    __slots__ = ("req", "rid", "ids", "out_dtype", "plen", "pos", "tok",
                 "length", "generated", "table", "phase", "max_new", "order",
                 "temperature", "top_k")

    def __init__(self, req, rid, ids, out_dtype, max_new, order):
        self.req = req
        self.rid = rid
        self.ids = ids              # int64 prompt
        self.out_dtype = out_dtype  # client dtype, restored on finish
        self.plen = len(ids)
        self.pos = 0                # prefill progress (tokens in the cache)
        self.tok = 0                # next decode input (last sampled token)
        self.length = 0             # cache rows present
        self.generated: list[int] = []
        self.table = None           # np.int32 [table_width] page ids
        self.phase = _PREFILL
        self.max_new = int(max_new)
        self.order = order          # admission sequence number
        self.temperature = float(req.temperature or 0.0)
        self.top_k = int(req.top_k or 0)


class ContinuousGenerateBatchingPredictor(GenerateBatchingPredictor):
    """Token-level scheduler for /generate over the paged pool.

    max_slots            decode width S: concurrent in-flight sequences.
    prefill_chunk        static chunk width C — one slot's prefill quantum.
    prefill_token_budget max prompt tokens per tick across slots (2*C).
    decode_steps         tokens each decoding slot advances per tick.
    max_seq_len          per-sequence capacity (prompt + new tokens); sets
                         the block-table width. Default: the whole pool.
    max_new_tokens       server-wide output cap; ``infer(max_new_tokens=n)``
                         asks for fewer and retires at n.
    eos_token_id         optional early-exit token; the remainder freezes
                         to EOS and the slot retires.
    device               defaults to CUDA (see GenerateBatchingPredictor).
    """

    _component = "continuous"

    def __init__(self, model, max_slots=8, prefill_chunk=16,
                 prefill_token_budget=None, decode_steps=4, max_seq_len=None,
                 eos_token_id=None, max_defers=32, **kwargs):
        self.max_slots = int(max_slots)
        self.prefill_chunk = int(prefill_chunk)
        self.prefill_token_budget = int(prefill_token_budget
                                        if prefill_token_budget is not None
                                        else 2 * self.prefill_chunk)
        if self.prefill_token_budget < self.prefill_chunk:
            raise ValueError("prefill_token_budget must cover at least one "
                             "chunk")
        self.decode_steps = int(decode_steps)
        self.eos_token_id = (None if eos_token_id is None
                             else int(eos_token_id))
        self._seed = itertools.count(1)     # fresh sampling noise per tick
        self._slots: list = [None] * self.max_slots
        self._slot_lock = threading.Lock()
        self._busy = threading.Event()      # a tick is running
        # the tick thread starts inside super().__init__; it waits on this
        # until the pool-dependent sizes below are final
        self._configured = threading.Event()
        super().__init__(model, max_defers=max_defers, **kwargs)
        pool_tokens = self.kv_cache.num_blocks * self.kv_cache.block_size
        self.max_seq_len = int(max_seq_len) if max_seq_len else pool_tokens
        if self.max_seq_len > pool_tokens:
            self.close()
            raise ValueError(f"max_seq_len {self.max_seq_len} exceeds the "
                             f"pool ({pool_tokens} tokens)")
        self.table_width = self.kv_cache.blocks_for(self.max_seq_len)
        self._configured.set()

    # ---------------------------------------------------------------- client
    def infer(self, ids, timeout=None, deadline=None, max_new_tokens=None,
              temperature=None, top_k=None):
        """One prompt in -> prompt + generated ids out. ``max_new_tokens``
        (clamped to the server cap) retires the sequence early;
        ``temperature`` / ``top_k`` are per-request sampler knobs that ride
        the same step launches as greedy batchmates."""
        req = self._make_request([np.asarray(ids)], timeout, deadline)
        if max_new_tokens is not None:
            req.max_new = max(1, min(int(max_new_tokens),
                                     self.max_new_tokens))
        if temperature is not None:
            req.temperature = float(temperature)
        if top_k is not None:
            req.top_k = int(top_k)
        return self._submit(req)

    def _admission_check(self, arrays, req=None):
        plen = len(arrays[0])
        total = plen + self.max_new_tokens
        if total > self.max_seq_len:
            raise ValueError(
                f"request needs {total} tokens but max_seq_len is "
                f"{self.max_seq_len}; no retry can succeed")
        super()._admission_check(arrays, req)

    def pending(self) -> int:
        """Queued + in-flight sequences and batches (drain condition)."""
        return (super().pending() + self._live_count()
                + (1 if self._busy.is_set() else 0))

    def _live_count(self) -> int:
        with self._slot_lock:
            return sum(1 for s in self._slots if s is not None)

    def _phase_slots(self, phase):
        with self._slot_lock:
            return [(i, s) for i, s in enumerate(self._slots)
                    if s is not None and s.phase == phase]

    # ------------------------------------------------------------- tick loop
    def _loop(self):
        while not self._configured.wait(0.05):
            if self._stop.is_set():
                return
        if self.fallback_dense:
            # a pool the paged step programs cannot use: serve through the
            # base collect-and-run loop (_run_batch -> _run_dense)
            return super()._loop()
        try:
            while not self._stop.is_set():
                self._admit()
                if self._live_count() == 0:
                    continue        # _admit parked briefly on the queue
                self._busy.set()
                try:
                    self._retire_unserviceable()
                    self._prefill_tick()
                    self._decode_tick()
                finally:
                    self._busy.clear()
        finally:
            if self._stop.is_set():
                self._shutdown_slots()

    def _free_slot(self):
        with self._slot_lock:
            for i, s in enumerate(self._slots):
                if s is None:
                    return i
        return None

    def _admit(self):
        """Fill free slots from the queue, FIFO. On a dry pool the request
        defers or sheds and admission stops for this tick."""
        block = self._live_count() == 0     # idle: park, don't spin
        while True:
            idx = self._free_slot()
            if idx is None:
                return
            try:
                req = (self._queue.get(timeout=0.05) if block
                       else self._queue.get_nowait())
            except queue.Empty:
                return
            block = False
            if not self._usable(req):
                continue
            if not self._install_seq(idx, req):
                return

    def _install_seq(self, idx, req) -> bool:
        """Admit one usable request into free slot ``idx``; False only on a
        dry pool (the request deferred or shed)."""
        arr = req.arrays[0]
        plen = len(arr)
        max_new = (req.max_new if req.max_new is not None
                   else self.max_new_tokens)
        seq_n = next(self._rid)
        rid = ("cseq", seq_n)
        try:
            self.kv_cache.reserve(rid, plen + max_new)
        except CacheOutOfBlocks as e:
            self._shed_or_defer(req, e)
            return False
        seq = _SlotSeq(req, rid, np.asarray(arr, np.int64), arr.dtype,
                       max_new, seq_n)
        seq.table = self.kv_cache.block_table(rid, pad_to=self.table_width)
        with self._slot_lock:
            self._slots[idx] = seq
        self.metrics.inc("admitted_seqs")
        return True

    # ----------------------------------------------------------- retirement
    def _evict_slot(self, i, s):
        """Free the slot and return its blocks (every retirement path)."""
        with self._slot_lock:
            if self._slots[i] is s:
                self._slots[i] = None
        try:
            self.kv_cache.mark_done(s.rid)
            self.kv_cache.release(s.rid)
        except KeyError:    # already released
            pass

    def _retire_ok(self, i, s):
        out = np.concatenate(
            [s.ids, np.asarray(s.generated[:s.max_new], np.int64)])
        self.kv_cache.set_length(s.rid, s.plen + s.max_new)
        self._finish_req(s.req, out.astype(s.out_dtype))
        self._evict_slot(i, s)
        self.metrics.inc("retired_seqs")
        self.metrics.inc("generated_tokens", len(s.generated[:s.max_new]))

    def _retire_unserviceable(self):
        """At every tick boundary a sequence whose client cancelled, or
        whose deadline expired, is retired and its blocks freed."""
        for i, s in enumerate(list(self._slots)):
            if s is None:
                continue
            req = s.req
            if req.state != _PENDING:
                self.metrics.inc("cancelled_skipped")
                self._evict_slot(i, s)
                self.metrics.inc("retired_seqs")
            elif req.deadline is not None and req.deadline.expired():
                if self._fail(req, DeadlineExceeded(
                        "deadline expired mid-decode (continuous tick)")):
                    self.metrics.inc("expired_in_flight")
                self._evict_slot(i, s)
                self.metrics.inc("retired_seqs")

    def _absorb(self, i, s, toks) -> bool:
        """Fold one tick's sampled tokens into the sequence; True if it
        retired. EOS freezes the remainder."""
        eos = self.eos_token_id
        for t in toks:
            if len(s.generated) >= s.max_new:
                break
            t = int(t)
            s.generated.append(t)
            if eos is not None and t == eos:
                s.generated.extend([eos] * (s.max_new - len(s.generated)))
                break
        if len(s.generated) >= s.max_new:
            self._retire_ok(i, s)
            return True
        return False

    def _fail_picks(self, picks, error):
        self.metrics.inc("batch_failures")
        for i, s in picks:
            self._evict_slot(i, s)
            self._fail_or_retry(s.req, error)

    # -------------------------------------------------------------- prefill
    def _prefill_tick(self):
        pre = self._phase_slots(_PREFILL)
        if not pre:
            return
        pre.sort(key=lambda t: t[1].order)      # oldest prompt first
        budget = self.prefill_token_budget
        picks = []
        for i, s in pre:
            if budget < 1:
                break
            take = min(self.prefill_chunk, s.plen - s.pos, budget)
            if take < 1:
                continue
            picks.append((i, s, take))
            budget -= take
        if not picks:
            return
        S, C = self.max_slots, self.prefill_chunk
        chunk = np.zeros((S, C), np.int64)
        offs = np.zeros(S, np.int64)
        lens = np.zeros(S, np.int64)
        temps = np.zeros(S, np.float32)
        tks = np.zeros(S, np.int64)
        tables = np.zeros((S, self.table_width), np.int32)
        for i, s, take in picks:
            chunk[i, :take] = s.ids[s.pos:s.pos + take]
            offs[i] = s.pos
            lens[i] = take
            temps[i] = s.temperature
            tks[i] = s.top_k
            tables[i] = s.table
        try:
            tk = self.model.prefill_chunk(
                chunk, offs, lens, self.kv_cache, tables,
                temperature=temps, top_k=tks,
                eos_token_id=self.eos_token_id, seed=next(self._seed))
        except Exception as e:      # this tick's sequences fail, not the loop
            self._fail_picks([(i, s) for i, s, _ in picks], e)
            return
        self.metrics.inc("prefill_ticks")
        for i, s, take in picks:
            s.pos += take
            s.length = s.pos
            self.kv_cache.append_tokens(s.rid, take)
            if s.pos >= s.plen:
                s.phase = _DECODE
                s.tok = int(tk[i])
                self._absorb(i, s, [s.tok])

    # --------------------------------------------------------------- decode
    def _decode_tick(self):
        dec = self._phase_slots(_DECODE)
        if not dec:
            return
        S, T = self.max_slots, self.decode_steps
        tok = np.zeros(S, np.int64)
        lengths = np.zeros(S, np.int64)
        maxlens = np.zeros(S, np.int64)
        active = np.zeros(S, bool)
        temps = np.zeros(S, np.float32)
        tks = np.zeros(S, np.int64)
        tables = np.zeros((S, self.table_width), np.int32)
        for i, s in dec:
            tok[i] = s.tok
            lengths[i] = s.length
            maxlens[i] = s.plen + s.max_new   # write ceiling: reserved rows
            active[i] = True
            temps[i] = s.temperature
            tks[i] = s.top_k
            tables[i] = s.table
        try:
            toks = self.model.decode_step(
                tok, lengths, active, self.kv_cache, tables, steps=T,
                max_lens=maxlens, temperature=temps, top_k=tks,
                eos_token_id=self.eos_token_id, seed=next(self._seed))
        except Exception as e:      # this tick's sequences fail, not the loop
            self._fail_picks(dec, e)
            return
        self.metrics.inc("decode_ticks")
        for i, s in dec:
            s.length += T
            s.tok = int(toks[i, -1])
            self._absorb(i, s, toks[i])

    # ------------------------------------------------------------- lifecycle
    def _shutdown_slots(self):
        """close() path: every in-flight sequence fails; nobody hangs."""
        for i, s in enumerate(list(self._slots)):
            if s is None:
                continue
            self._fail(s.req, ServiceUnavailable("predictor closed"))
            self._evict_slot(i, s)
