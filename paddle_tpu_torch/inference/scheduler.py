"""Continuous (in-flight) batching over the paged KV pool — the counterpart
of ``paddle_tpu/inference/scheduler.py``'s
``ContinuousGenerateBatchingPredictor``.

A persistent tick loop over a fixed set of S slots:

* admit — queued requests take free slots (FIFO, or the shortest prompt
  first) by atomically reserving their blocks from the shared pool, led by
  the blocks a prefix-cache hit shares; a dry pool defers or sheds THAT
  request only.
* prefill — prompts are split into fixed-width chunks; each tick spends at
  most ``prefill_token_budget`` prompt tokens across slots in ONE
  ``prefill_chunk`` launch, so a long prompt never stalls the decoders for
  more than a chunk. A prefix hit resumes the prefill at its first novel
  token.
* decode — every decoding slot advances ``decode_steps`` tokens in ONE
  ``decode_step`` call; with ``spec_k > 0`` the tick is ONE ``verify_step``
  launch of width K + 1 scoring each slot's host-drafted tokens instead.
* retire — finished / EOS / expired / cancelled sequences free their
  blocks and slot at the tick boundary; streamed tokens flush there too.

When the pool's signature does not match the model, the tick loop hands
over to the base class's collect-and-run loop, which serves each request
through dense ``generate()`` (JAX ``scheduler.py:977-981``).

Not ported: adapters, QoS, the SLO monitor, the flight recorder, the
utilization ledger, the HBM planner, the persistent compile cache and the
replica fleet (ROADMAP A7): their knobs raise ``NotImplementedError``.
"""
from __future__ import annotations

import collections
import itertools
import queue
import threading

import numpy as np

from .kv_cache import CacheOutOfBlocks
from .prefix_cache import PrefixCache
from .resilience import DeadlineExceeded, ServiceUnavailable
from .serving import _PENDING, GenerateBatchingPredictor
from .speculative import make_drafter
from .warmup import Warmup
from .warmup import notify as _recompile_notify

__all__ = ["ContinuousGenerateBatchingPredictor"]

_PREFILL, _DECODE = "prefill", "decode"
# JAX knobs this port does not carry yet; each raises NotImplementedError
_NOT_PORTED = ("compile_cache_dir", "hbm_budget", "adapters", "qos", "slo",
               "flight_recorder", "utilization", "faults", "tracer")


class _SlotSeq:
    """One in-flight sequence bound to a scheduler slot."""

    __slots__ = ("req", "rid", "ids", "out_dtype", "plen", "pos", "tok",
                 "length", "generated", "table", "phase", "max_new", "order",
                 "temperature", "top_k", "spec", "prefix_hit", "digests",
                 "flushed")

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
        # speculation opt-out: an opted-out slot rides the same verify
        # program with draft length 0
        self.spec = True if req.spec is None else bool(req.spec)
        self.prefix_hit = 0         # prompt tokens served by shared blocks
        self.digests = None         # the prompt's full-block digest chain
        self.flushed = 0            # streamed-token high-water mark


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
    spec_k               speculative width: > 0 replaces the decode tick by
                         one ``verify_step`` launch of width K + 1 across
                         the decoding slots (1 + accepted tokens per slot,
                         the output law unchanged). 0: decode_step ticks.
    drafter              'ngram' (default) | 'self' | a Drafter instance.
    admit_policy         'fifo' (default) | 'shortest_prompt_first': a free
                         slot takes the waiting request with the shortest
                         prompt (ties: the most urgent deadline, then
                         arrival).
    prefix_cache         True builds a ``PrefixCache`` over this pool (or
                         pass one built over it): admission shares indexed
                         blocks and the prefill resumes at the first novel
                         token, token-identical to a cold prefill.
    warmup               True builds every step program of the
                         configuration (``warmup.program_keys``) on a
                         background thread before ``ready()`` turns True
                         and before any tick runs; after a complete warmup
                         any capture counts in
                         ``paddle_serving_recompiles_total``.
    device               defaults to CUDA (see GenerateBatchingPredictor).

    The JAX knobs ``compile_cache_dir``, ``hbm_budget``, ``adapters``,
    ``qos``, ``slo``, ``flight_recorder``, ``utilization`` (and
    ``faults``, ``tracer``) are accepted by name and raise
    ``NotImplementedError`` (ROADMAP A7) unless left at their defaults.
    """

    _component = "continuous"
    supports_sampler_knobs = True   # serving.py gates per-request headers
    supports_streaming = True       # tick-boundary flushes -> infer_stream

    def __init__(self, model, max_slots=8, prefill_chunk=16,
                 prefill_token_budget=None, decode_steps=4, max_seq_len=None,
                 eos_token_id=None, max_defers=32, spec_k=0, drafter="ngram",
                 admit_policy="fifo", prefix_cache=False, warmup=False,
                 compile_cache_dir=None, hbm_budget=None, adapters=None,
                 qos=None, slo=None, flight_recorder=False,
                 utilization=False, faults=None, tracer=None, **kwargs):
        given = dict(compile_cache_dir=compile_cache_dir,
                     hbm_budget=hbm_budget, adapters=adapters, qos=qos,
                     slo=slo, flight_recorder=flight_recorder,
                     utilization=utilization, faults=faults, tracer=tracer)
        for name in _NOT_PORTED:
            if given[name] not in (None, False):
                why = (" (a CUDA graph holds device addresses and cannot be "
                       "persisted)" if name == "compile_cache_dir" else "")
                raise NotImplementedError(
                    f"{name}= is not ported to the PyTorch scheduler"
                    f"{why}; ROADMAP A7")
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
        self.spec_k = int(spec_k)
        if self.spec_k < 0:
            raise ValueError("spec_k must be >= 0")
        self._drafter = (make_drafter(drafter, model) if self.spec_k > 0
                         else None)
        if admit_policy not in ("fifo", "shortest_prompt_first"):
            raise ValueError(f"unknown admit_policy {admit_policy!r} "
                             "(fifo | shortest_prompt_first)")
        self.admit_policy = admit_policy
        # reorder buffer of non-FIFO admission (deque: atomic appends and
        # pops; the tick thread and close() touch it)
        self._backlog: collections.deque = collections.deque()
        self._spec_drafted = 0      # written under _slot_lock
        self._spec_accepted = 0
        self._seed = itertools.count(1)     # fresh sampling noise per tick
        self._slots: list = [None] * self.max_slots
        self._slot_lock = threading.Lock()
        self._busy = threading.Event()      # a tick is running
        # the tick loop reads these before the pool-dependent parts below
        # are built; a tick that races them serves its admissions cold
        self.prefix_cache = None
        self._prefix_hit_counter = None
        self.warmup = bool(warmup)
        self._warm_done = threading.Event()
        self._warm_armed = threading.Event()
        self._warm_stats: collections.deque = collections.deque(maxlen=8)
        self._warm_errors: collections.deque = collections.deque(maxlen=8)
        self._warm_thread = None
        self._recompile_counter = None
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
        self._spec_counter = self._bind_scheduler_metrics()
        if prefix_cache:
            pc = (prefix_cache if isinstance(prefix_cache, PrefixCache)
                  else PrefixCache(self.kv_cache))
            if pc.kv is not self.kv_cache:
                self.close()
                raise ValueError("the prefix cache indexes another pool")
            pc.bind_metrics(self.metrics.registry, component=self._component)
            self._prefix_hit_counter = self.metrics.registry.counter(
                "paddle_prefix_hit_tokens_total",
                "Prompt tokens served from shared prefix blocks instead of "
                "prefill compute", labels=("component",)).labels(
                    self._component)
            self.prefix_cache = pc      # published last: counter is ready
        self._recompile_counter = self.metrics.registry.counter(
            "paddle_serving_recompiles_total",
            "Post-ready step-program cold builds by program — stays 0 when "
            "the AOT warmup covered the compile-surface manifest "
            "(analysis/compilesurface.py)", labels=("component", "program"))
        if self.warmup and not self.fallback_dense:
            self._warm_thread = threading.Thread(
                target=self._warm_start, name="warmup", daemon=True)
            self._warm_thread.start()
        else:
            self._warm_done.set()
        self._configured.set()

    # ---------------------------------------------------------------- warmup
    def _warm_start(self):
        """Body of the warmup thread: build every program, then open the
        gate. A failed warmup serves cold, with the error recorded and the
        sentinel unarmed (JAX ``scheduler.py:526-542``)."""
        try:
            stats = Warmup(self).run()
            self._warm_stats.append(stats)
            if not stats["missing"] and not self._stop.is_set():
                self._warm_armed.set()
        except Exception as e:            # recorded, not fatal
            self._warm_errors.append(e)
        finally:
            self._warm_done.set()

    def warm_stats(self):
        """The latest warmup's stats (programs, captured, missing, seconds,
        program_seconds), or None before one finished."""
        return self._warm_stats[-1] if self._warm_stats else None

    def warm_errors(self):
        return list(self._warm_errors)

    def ready(self) -> bool:
        """/readyz gate: False until the warmup finished (at once without
        one) and while shutting down."""
        return (self._warm_done.is_set() and not self._stop.is_set()
                and self._thread.is_alive())

    # ------------------------------------------------------------- telemetry
    def _bind_scheduler_metrics(self):
        """The scheduler's series under JAX's names and labels (JAX
        ``scheduler.py:560-711``, the families of the ported features)."""
        reg = self.metrics.registry
        slots = reg.gauge(
            "paddle_sched_slots",
            "Continuous-scheduler slots by phase; "
            "prefill + decode + free == slot count",
            labels=("component", "phase"))
        slots.labels(self._component, _PREFILL).set_function(
            lambda: self._phase_count(_PREFILL))
        slots.labels(self._component, _DECODE).set_function(
            lambda: self._phase_count(_DECODE))
        slots.labels(self._component, "free").set_function(
            lambda: self.max_slots - self._phase_count(None))
        reg.gauge(
            "paddle_sched_slot_count", "Configured continuous-scheduler "
            "slot width S", labels=("component",)).labels(
                self._component).set_function(lambda: self.max_slots)
        reg.gauge(
            "paddle_sched_prefill_token_budget",
            "Max prompt tokens spent per tick across slots (chunked "
            "prefill knob)", labels=("component",)).labels(
                self._component).set_function(
                    lambda: self.prefill_token_budget)
        reg.gauge(
            "paddle_sched_prefill_backlog_tokens",
            "Prompt tokens still to prefill across in-flight slots",
            labels=("component",)).labels(self._component).set_function(
                self._prefill_backlog)
        spec_counter = reg.counter(
            "paddle_spec_tokens_total",
            "Speculative decoding tokens by kind: drafted (submitted to "
            "verify), accepted (kept), wasted (drafted - accepted)",
            labels=("component", "kind"))
        reg.gauge(
            "paddle_spec_acceptance_rate",
            "Cumulative speculative acceptance rate (accepted / drafted)",
            labels=("component",)).labels(self._component).set_function(
                self._acceptance_rate)
        return spec_counter

    def _acceptance_rate(self):
        with self._slot_lock:
            d, a = self._spec_drafted, self._spec_accepted
        return a / d if d else 0.0

    def _gen_timing(self, info):
        """Launch-latency histogram only (tokens are counted per sequence
        at retirement), and the sentinel's tap: a launch that built its
        program after an armed warmup is counted and reported."""
        self._decode_hist.labels(self._component, info["path"]).observe(
            info["launch_s"])
        if info["compiled"] and self._warm_armed.is_set():
            self._recompile_counter.labels(
                self._component, info["path"]).inc()
            _recompile_notify(self._component, info["path"])

    def _phase_count(self, phase):
        with self._slot_lock:
            if phase is None:       # live count
                return sum(1 for s in self._slots if s is not None)
            return sum(1 for s in self._slots
                       if s is not None and s.phase == phase)

    def _prefill_backlog(self):
        with self._slot_lock:
            return sum(s.plen - s.pos for s in self._slots
                       if s is not None and s.phase == _PREFILL)

    # ---------------------------------------------------------------- client
    def _request(self, ids, timeout, deadline, max_new_tokens, temperature,
                 top_k, spec):
        req = self._make_request([np.asarray(ids)], timeout, deadline)
        if max_new_tokens is not None:
            req.max_new = max(1, min(int(max_new_tokens),
                                     self.max_new_tokens))
        if temperature is not None:
            req.temperature = float(temperature)
        if top_k is not None:
            req.top_k = int(top_k)
        if spec is not None:
            req.spec = bool(spec)
        return req

    def infer(self, ids, timeout=None, deadline=None, max_new_tokens=None,
              temperature=None, top_k=None, spec=None):
        """One prompt in -> prompt + generated ids out. ``max_new_tokens``
        (clamped to the server cap) retires the sequence early;
        ``temperature`` / ``top_k`` are per-request sampler knobs that ride
        the same step launches as greedy batchmates; ``spec=False`` opts
        the request out of speculation (zero drafts in the same verify
        program)."""
        return self._submit(self._request(ids, timeout, deadline,
                                          max_new_tokens, temperature, top_k,
                                          spec))

    def infer_stream(self, ids, timeout=None, deadline=None,
                     max_new_tokens=None, temperature=None, top_k=None,
                     spec=None):
        """Streaming twin of infer() (JAX ``scheduler.py:830-862``).
        Admission failures raise here; the returned iterator yields int64
        arrays of the tokens each tick boundary flushed, whose
        concatenation is infer()'s generated suffix. Failures after
        acceptance raise from the iterator; closing it early cancels the
        sequence."""
        req = self._request(ids, timeout, deadline, max_new_tokens,
                            temperature, top_k, spec)
        q: queue.Queue = queue.Queue()
        req.on_tokens = q.put       # published before enqueue
        self._start(req)
        return self._stream_pump(req, q)

    def _stream_pump(self, req, q):
        """Generator half of infer_stream: drain the flush queue with
        _await's deadline cancel between flushes."""
        try:
            while True:
                if req.deadline is None:
                    step = 0.1
                else:
                    rem = req.deadline.remaining()
                    if rem <= 0:
                        if req.cancel():
                            self.metrics.inc("timeouts")
                            self._observe(req)
                            raise DeadlineExceeded(
                                "inference request timed out mid-stream")
                        break   # lost the race: a terminal outcome landed
                    step = min(0.1, rem)
                try:
                    yield np.asarray(q.get(timeout=step), np.int64)
                    continue
                except queue.Empty:
                    pass
                if req.event.is_set():
                    break
                if not self._thread.is_alive():
                    self._fail(req, ServiceUnavailable("batcher thread died"))
            while True:     # flushes that landed before the terminal CAS
                try:
                    yield np.asarray(q.get_nowait(), np.int64)
                except queue.Empty:
                    break
            if req.error is not None:
                raise req.error
        except GeneratorExit:
            # the consumer walked away: a client-side cancel; the tick loop
            # frees the slot at the next boundary
            if req.cancel():
                self.metrics.inc("timeouts")
                self._observe(req)
            raise
        finally:
            req.on_tokens = None

    def _admission_check(self, arrays, req=None):
        plen = len(arrays[0])
        total = plen + self.max_new_tokens
        if total > self.max_seq_len:
            raise ValueError(
                f"request needs {total} tokens but max_seq_len is "
                f"{self.max_seq_len}; no retry can succeed")
        self.model._decode_validate(plen, self.max_new_tokens)
        super()._admission_check(arrays, req)

    def pending(self) -> int:
        """Queued + reordered + in-flight sequences (drain condition)."""
        return (self._queue.qsize() + len(self._backlog)
                + self._phase_count(None)
                + (1 if self._busy.is_set() else 0))

    # ------------------------------------------------------------- tick loop
    def _loop(self):
        while not self._configured.wait(0.05):
            if self._stop.is_set():
                return
        # the ready gate: no tick (so no capture under traffic) before the
        # warmup finished; polled, so close() during warmup exits promptly
        while not self._warm_done.wait(0.05):
            if self._stop.is_set():
                return
        if self.fallback_dense:
            # a pool the paged step programs cannot use: serve through the
            # base collect-and-run loop (_run_batch -> _run_dense)
            return super()._loop()
        try:
            while not self._stop.is_set():
                self._admit()
                if self._phase_count(None) == 0:
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
        """Fill free slots under the admit policy. On a dry pool the request
        defers or sheds and admission stops for this tick."""
        block = self._phase_count(None) == 0    # idle: park, don't spin
        while True:
            idx = self._free_slot()
            if idx is None:
                return
            try:
                req = self._next_request(block)
            except queue.Empty:
                return
            block = False
            if not self._usable(req):
                continue
            if not self._install_seq(idx, req):
                return

    def _next_request(self, block):
        """One queue pop under the admit policy (JAX
        ``scheduler.py:1319-1348``): FIFO pops the arrival queue;
        shortest_prompt_first drains arrivals into the backlog and takes
        its shortest prompt, ties to the most urgent deadline, then
        arrival."""
        if self.admit_policy == "fifo":
            return (self._queue.get(timeout=0.05) if block
                    else self._queue.get_nowait())
        while True:
            try:
                self._backlog.append(self._queue.get_nowait())
            except queue.Empty:
                break
        if not self._backlog:
            if not block:
                raise queue.Empty
            self._backlog.append(self._queue.get(timeout=0.05))

        def urgency(item):
            pos, r = item
            rem = (r.deadline.remaining() if r.deadline is not None
                   else float("inf"))
            return (len(r.arrays[0]), rem, pos)
        _, best = min(enumerate(self._backlog), key=urgency)
        self._backlog.remove(best)
        return best

    def _install_seq(self, idx, req) -> bool:
        """Admit one usable request into free slot ``idx``: look the prompt
        up in the prefix cache, reserve its blocks (shared ones first) and
        place the sequence. False only on a dry pool (the request deferred
        or shed)."""
        arr = req.arrays[0]
        plen = len(arr)
        max_new = (req.max_new if req.max_new is not None
                   else self.max_new_tokens)
        seq_n = next(self._rid)
        rid = ("cseq", seq_n)
        ids64 = np.asarray(arr, np.int64)
        hit = None
        pc = self.prefix_cache
        if pc is not None:
            try:
                hit = pc.lookup(ids64)
            except Exception:       # a failed lookup is a miss
                hit = None
        try:
            self.kv_cache.reserve(
                rid, plen + max_new,
                shared=hit.pairs if hit is not None else None)
        except CacheOutOfBlocks as e:
            self._shed_or_defer(req, e)
            return False
        seq = _SlotSeq(req, rid, ids64, arr.dtype, max_new, seq_n)
        seq.table = self.kv_cache.block_table(rid, pad_to=self.table_width)
        if hit is not None:
            # the shared rows are in the pool: the prefill resumes at the
            # first novel token
            got = int(self.kv_cache.length(rid))
            seq.prefix_hit = got
            seq.pos = seq.length = got
            seq.digests = hit.digests
            if got:
                self.metrics.inc("prefix_hit_tokens", got)
                self._prefix_hit_counter.inc(got)
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
        # index the generated tail before set_length rewrites the committed
        # length: only rows actually written are indexable
        self._register_prefix(s, out, min(s.length, s.plen + s.max_new),
                              digests=None)
        self.kv_cache.set_length(s.rid, s.plen + s.max_new)
        self._finish_req(s.req, out.astype(s.out_dtype))
        self._evict_slot(i, s)
        self.metrics.inc("retired_seqs")
        self.metrics.inc("generated_tokens", len(s.generated[:s.max_new]))
        self._tokens_total.labels(self._component).inc(len(s.generated))

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
        """Fold one tick's sampled tokens into the sequence and flush them
        to a stream; True if it retired. EOS freezes the remainder."""
        eos = self.eos_token_id
        for t in toks:
            if len(s.generated) >= s.max_new:
                break
            t = int(t)
            s.generated.append(t)
            if eos is not None and t == eos:
                s.generated.extend([eos] * (s.max_new - len(s.generated)))
                break
        self._flush_stream(s)
        if len(s.generated) >= s.max_new:
            self._retire_ok(i, s)
            return True
        return False

    def _flush_stream(self, s):
        """Push the tokens absorbed since the last flush to the request's
        stream, from the host list ``_absorb`` keeps (no device work). A
        broken consumer never takes the tick loop down."""
        cb = s.req.on_tokens
        if cb is None:
            return
        upto = min(len(s.generated), s.max_new)
        if upto <= s.flushed:
            return
        chunk = s.generated[s.flushed:upto]
        s.flushed = upto
        try:
            cb(list(chunk))
        except Exception:
            pass

    def _fail_picks(self, picks, error):
        self.metrics.inc("batch_failures")
        for i, s in picks:
            self._evict_slot(i, s)
            self._fail_or_retry(s.req, error)

    def _register_prefix(self, s, tokens, committed, digests="prompt"):
        """Index the sequence's committed full blocks: prefill chunks with
        the admission-time digests, the whole prompt + generation at
        retirement (rehashed). Best effort: an index failure never takes
        the sequence with it."""
        pc = self.prefix_cache
        if pc is None:
            return
        try:
            pc.register(s.rid, tokens,
                        digests=s.digests if digests == "prompt" else None,
                        length=int(committed))
        except Exception:
            pass

    # -------------------------------------------------------------- prefill
    def _prefill_tick(self):
        with self._slot_lock:
            pre = [(i, s) for i, s in enumerate(self._slots)
                   if s is not None and s.phase == _PREFILL]
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
                eos_token_id=self.eos_token_id,
                decode_kernel=self.decode_kernel, seed=next(self._seed),
                timing_hook=self._gen_timing)
        except Exception as e:      # this tick's sequences fail, not the loop
            self._fail_picks([(i, s) for i, s, _ in picks], e)
            return
        self.metrics.inc("prefill_ticks")
        for i, s, take in picks:
            s.pos += take
            s.length = s.pos
            self.kv_cache.append_tokens(s.rid, take)
            self._register_prefix(s, s.ids, s.pos)
            if s.pos >= s.plen:
                s.phase = _DECODE
                s.tok = int(tk[i])
                self._absorb(i, s, [s.tok])

    # --------------------------------------------------------------- decode
    def _decode_tick(self):
        if self.spec_k > 0:
            return self._verify_tick()
        with self._slot_lock:
            dec = [(i, s) for i, s in enumerate(self._slots)
                   if s is not None and s.phase == _DECODE]
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
                eos_token_id=self.eos_token_id,
                decode_kernel=self.decode_kernel, seed=next(self._seed),
                timing_hook=self._gen_timing)
        except Exception as e:      # this tick's sequences fail, not the loop
            self._fail_picks(dec, e)
            return
        self.metrics.inc("decode_ticks")
        for i, s in dec:
            s.length += T
            s.tok = int(toks[i, -1])
            self._absorb(i, s, toks[i])

    def _verify_tick(self):
        """Speculative decode tick (JAX ``scheduler.py:1841-1937``): draft
        on the host, verify in ONE fixed-width ``verify_step`` launch
        across the decoding slots. A slot drafts at most its spare tokens
        (still owed minus the launch's guaranteed one); rollback of a
        rejection is length bookkeeping only, and the write ceiling stays
        the reserved plen + max_new."""
        with self._slot_lock:
            dec = [(i, s) for i, s in enumerate(self._slots)
                   if s is not None and s.phase == _DECODE]
        if not dec:
            return
        S, K = self.max_slots, self.spec_k
        chunk = np.zeros((S, K + 1), np.int64)
        offs = np.zeros(S, np.int64)
        dlens = np.zeros(S, np.int64)
        maxlens = np.zeros(S, np.int64)
        active = np.zeros(S, bool)
        temps = np.zeros(S, np.float32)
        tks = np.zeros(S, np.int64)
        tables = np.zeros((S, self.table_width), np.int32)
        for i, s in dec:
            # a verify launch writes [length, length + 1 + K) and never
            # rolls back below plen; a prefix hit covers at most plen - 1
            # rows, so no verify write touches a shared block
            assert s.length >= s.plen > s.prefix_hit, \
                (f"verify tick would touch shared prefix rows: "
                 f"length={s.length} plen={s.plen} hit={s.prefix_hit}")
            chunk[i, 0] = s.tok
            offs[i] = s.length
            maxlens[i] = s.plen + s.max_new
            active[i] = True
            temps[i] = s.temperature
            tks[i] = s.top_k
            tables[i] = s.table
            spare = s.max_new - len(s.generated) - 1
            if s.spec and spare > 0:
                hist = np.concatenate(
                    [s.ids, np.asarray(s.generated, np.int64)])
                prop = np.asarray(self._drafter.draft(hist, K),
                                  np.int64).reshape(-1)[:K]
                n = min(len(prop), spare)
                if n > 0:
                    chunk[i, 1:1 + n] = prop[:n]
                    dlens[i] = n
        try:
            acc, nxt = self.model.verify_step(
                chunk, offs, dlens, active, self.kv_cache, tables,
                max_lens=maxlens, temperature=temps, top_k=tks,
                decode_kernel=self.decode_kernel, seed=next(self._seed),
                timing_hook=self._gen_timing)
        except Exception as e:      # this tick's sequences fail, not the loop
            self._fail_picks(dec, e)
            return
        self.metrics.inc("verify_ticks")
        drafted = int(sum(dlens[i] for i, _ in dec))
        accepted = int(sum(acc[i] for i, _ in dec))
        self._spec_counter.labels(self._component, "drafted").inc(drafted)
        self._spec_counter.labels(self._component, "accepted").inc(accepted)
        self._spec_counter.labels(self._component,
                                  "wasted").inc(drafted - accepted)
        with self._slot_lock:
            self._spec_drafted += drafted
            self._spec_accepted += accepted
        for i, s in dec:
            a = int(acc[i])
            s.length += 1 + a   # committed rows: accepted prefix + emitted
            s.tok = int(nxt[i])
            self._absorb(i, s, [int(t) for t in chunk[i, 1:1 + a]]
                         + [s.tok])

    # ------------------------------------------------------------- lifecycle
    def _shutdown_slots(self):
        """close() path: every in-flight sequence fails; nobody hangs."""
        for i, s in enumerate(list(self._slots)):
            if s is None:
                continue
            self._fail(s.req, ServiceUnavailable("predictor closed"))
            self._evict_slot(i, s)
        self._drain_backlog()

    def _drain_backlog(self):
        """Requests in the admit policy's reorder buffer get a terminal
        outcome too."""
        while True:
            try:
                r = self._backlog.popleft()
            except IndexError:
                break
            self._fail(r, ServiceUnavailable("predictor closed"))

    def close(self):
        super().close()
        self._drain_backlog()
        if self._warm_thread is not None:   # a launch cannot be cut short
            self._warm_thread.join(timeout=60)
