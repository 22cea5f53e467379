"""Continuous (in-flight) batching over the paged KV pool — the counterpart
of ``paddle_tpu/inference/scheduler.py``'s
``ContinuousGenerateBatchingPredictor``.

A persistent tick loop over a fixed set of S slots:

* admit — queued requests take free slots (FIFO, the shortest prompt
  first, or, with a ``TenantLedger``, the most under-served tenant of the
  most urgent tier) by atomically reserving their blocks from the shared
  pool, led by the blocks a prefix-cache hit shares; a dry pool defers or
  sheds THAT request only. A strictly more urgent waiter pauses the least
  urgent running sequence (blocks kept, slot freed) and the paused
  sequence later resumes where it stopped.
* prefill — prompts are split into fixed-width chunks; each tick spends at
  most ``prefill_token_budget`` prompt tokens across slots in ONE
  ``prefill_chunk`` launch. A prefix hit resumes the prefill at its first
  novel token.
* decode — every decoding slot advances ``decode_steps`` tokens in ONE
  ``decode_step`` call; with ``spec_k > 0`` the tick is ONE ``verify_step``
  launch of width K + 1 scoring each slot's host-drafted tokens instead.
  With an ``AdapterRegistry`` each launch takes the slots' [S] bank rows,
  so requests of different adapters (and base requests, row 0) share it.
* retire — finished / EOS / expired / cancelled sequences free their
  blocks and slot at the tick boundary; streamed tokens flush there too;
  retirement feeds the TTFT / TPOT histograms and the SLO monitor.

Each tick also closes a utilization window (integer FLOPs split into
useful / pad / spec_waste) and appends a flight-recorder snapshot when
those are installed. When the pool's signature does not match the model,
the tick loop hands over to the base class's collect-and-run loop, which
serves each request through dense ``generate()``.

``hbm_budget=`` sizes the pool from ``analysis.hbm.plan_kv_pool`` (the
pool's scratch page reserved first) and publishes the plan as
``paddle_hbm_planned_bytes{component}`` beside
``paddle_hbm_budget_bytes``. Still raising: ``compile_cache_dir=`` (a CUDA
graph holds device addresses and cannot be persisted; ROADMAP C).
"""
from __future__ import annotations

import collections
import itertools
import queue
import threading

import numpy as np

from ..analysis.lockwitness import make_lock
from .faults import ThreadDeath
from .kv_cache import CacheOutOfBlocks
from .lockstep import LockstepLeader, follow
from .prefix_cache import PrefixCache
from .resilience import DeadlineExceeded, ServiceUnavailable
from .serving import _PENDING, GenerateBatchingPredictor
from .speculative import make_drafter
from .warmup import Warmup
from .warmup import notify as _recompile_notify

__all__ = ["ContinuousGenerateBatchingPredictor", "phase_walls",
           "attribution_shares"]

_PREFILL, _DECODE = "prefill", "decode"


def phase_walls(t0, t_admit, t_first, t_end, paused_s, paused_pre_s):
    """Decompose one request's wall time into phase walls (seconds).

    Pure function over the scheduler-clock stamps: acceptance
    (t0), slot admission (t_admit), first generated token (t_first, None if
    the request never produced one), terminal (t_end), plus total paused
    seconds and the portion paused before the first token. Returns
    (queue_s, prefill_s, paused_s, decode_s), each clamped >= 0:

    * queue   — acceptance to slot admission (never admitted: the whole
      life was queue wait).
    * prefill — admission to first token, minus pre-first-token pause time
      (no first token: everything after admission that wasn't a pause).
    * paused  — preemption park time, charged to its OWN phase: a paused
      sequence is neither prefilling nor decoding, and folding it into
      either would misattribute a scheduling decision as model latency.
    * decode  — first token to terminal, minus post-first-token pauses.
    """
    if t0 is None:
        return (0.0, 0.0, 0.0, 0.0)
    if t_admit is None:
        return (max(0.0, t_end - t0), 0.0, 0.0, 0.0)
    queue_s = max(0.0, t_admit - t0)
    paused_total = max(0.0, float(paused_s))
    paused_pre = min(paused_total, max(0.0, float(paused_pre_s)))
    if t_first is None:
        prefill_s = max(0.0, (t_end - t_admit) - paused_total)
        return (queue_s, prefill_s, paused_total, 0.0)
    prefill_s = max(0.0, (t_first - t_admit) - paused_pre)
    decode_s = max(0.0, (t_end - t_first) - (paused_total - paused_pre))
    return (queue_s, prefill_s, paused_total, decode_s)


def attribution_shares(queue_s, prefill_s, paused_s, decode_s):
    """Phase walls -> the terminal span's deadline-attribution tags.

    Shares are normalized by the walls' own sum so they add to 1.0 by
    construction (the property test's invariant); a zero-duration request
    (door rejection, instant shed) is all queue — the phase it died in."""
    total = queue_s + prefill_s + paused_s + decode_s
    if total <= 0.0:
        return {"queue_share": 1.0, "prefill_share": 0.0,
                "paused_share": 0.0, "decode_share": 0.0}
    return {"queue_share": round(queue_s / total, 6),
            "prefill_share": round(prefill_s / total, 6),
            "paused_share": round(paused_s / total, 6),
            "decode_share": round(decode_s / total, 6)}


class _SlotSeq:
    """One in-flight sequence bound to a scheduler slot."""

    __slots__ = ("req", "rid", "ids", "out_dtype", "plen", "pos", "tok",
                 "length", "generated", "table", "phase", "max_new", "order",
                 "temperature", "top_k", "spec", "prefix_hit", "digests",
                 "flushed", "adapter", "adapter_seed", "tenant", "priority",
                 "qos_held", "t_admit", "t_first", "t_last", "t_pause",
                 "paused_s", "paused_pre_s", "n_tok")

    def __init__(self, req, rid, ids, out_dtype, max_new, order):
        self.req = req
        self.rid = rid
        self.ids = ids              # int64 prompt (program input dtype)
        self.out_dtype = out_dtype  # client dtype, restored on finish
        self.plen = len(ids)
        self.pos = 0                # prefill progress (tokens in the cache)
        self.tok = 0                # next decode input (last sampled token)
        self.length = 0             # cache rows present
        self.generated: list[int] = []
        self.table = None           # np.int32 [table_width] page ids
        self.phase = _PREFILL
        self.max_new = int(max_new)
        self.order = order          # admit sequence number (FIFO fairness)
        # per-request sampling params: traced [S]-array inputs of the step
        # programs, so mixed-sampler slots share one captured program
        self.temperature = float(req.temperature or 0.0)
        self.top_k = int(req.top_k or 0)
        # per-request speculation opt-out (X-Spec header); honored only
        # when the scheduler runs with spec_k > 0 — an opted-out slot rides
        # the same verify program with draft_len 0 (no new capture)
        self.spec = True if getattr(req, "spec", None) is None else bool(
            req.spec)
        # prefix-cache state: tokens satisfied from shared blocks
        # at admission, the prompt's full-block digest chain (for indexing
        # at prefill commit), and the streamed-token high-water mark
        self.prefix_hit = 0
        self.digests = None
        self.flushed = 0
        # per-request model delta: the adapter's bank row (0 =
        # base/identity) — a traced [S] step-program input, so heterogeneous
        # adapter mixes share one captured program — and its registration
        # uid, which seeds the prefix-cache digest chain (KV isolation)
        self.adapter = 0
        self.adapter_seed = b""
        # multi-tenant QoS: resolved tenant name + priority tier
        # (lower = more urgent), and whether this sequence currently holds
        # its tenant's fair-share inflight count (pause releases it while
        # the blocks stay reserved)
        self.tenant = None
        self.priority = 0
        self.qos_held = False
        # phase attribution: scheduler-clock stamps — admission,
        # first/last generated token — plus paused-time accounting (total
        # seconds parked, the portion parked before the first token, and
        # the open pause interval's start). Pause time charges a distinct
        # `paused` phase: it is in neither TTFT's prefill nor TPOT's decode.
        self.t_admit = None
        self.t_first = None
        self.t_last = None
        self.t_pause = None
        self.paused_s = 0.0
        self.paused_pre_s = 0.0
        self.n_tok = 0      # tokens actually sampled (EOS freeze excluded)


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
    adapters             an ``inference.adapters.AdapterRegistry`` over
                         this model: every step launch takes the slots' [S]
                         bank rows, ``infer(adapter=name)`` (HTTP
                         ``X-Adapter``) routes a request through its
                         adapter's low-rank delta and base requests ride
                         row 0 (the identity) of the same program.
                         Admission pins the row for the sequence's life.
                         Loads, unloads and mixes capture nothing new.
    qos                  an ``inference.qos.TenantLedger``: weighted fair-
                         share admission across tenants, per-tenant token-
                         bucket rate limits at the door (429 with a
                         computed Retry-After) and priority preemption: a
                         strictly more urgent waiter PAUSES the least
                         urgent running sequence (blocks kept, slot freed)
                         and it resumes later through the continuation
                         bookkeeping a prefix hit uses, token for token as
                         if never paused. Host-side only: no new program.
    slo                  an ``observability.slo.SLOMonitor``: retirement
                         feeds it per-tenant TTFT / TPOT, every terminal
                         outcome feeds availability (good = HTTP status
                         < 500); with a flight recorder, an alert edge
                         dumps the ring.
    flight_recorder      True (or a capacity, or a ``FlightRecorder``): a
                         per-tick ring of snapshots (slot map with tenant /
                         adapter / phase, widths, KV blocks, paused and
                         pending depths, fair ratios), served at
                         ``/debug/ticks``.
    utilization          True (or a ``UtilizationLedger``): each tick's
                         issued FLOPs split into useful / pad / spec_waste
                         in exact integers, useful FLOPs billed per tenant,
                         tick wall split into launch and host gap; the
                         FLOPs of a program are counted once per key over a
                         body run (``observability/device.py``).
    faults, tracer       a ``FaultInjector`` (sites ``batcher.tick``,
                         ``predictor.generate``, the pool's and the prefix
                         cache's) and a ``Tracer`` (request spans:
                         ``kv_reserve``, ``prefix_lookup``,
                         ``adapter_gather``, the step launches,
                         ``preempt`` / ``resume``).
    device               defaults to CUDA (see GenerateBatchingPredictor).

    ``compile_cache_dir`` raises for good (a CUDA graph holds device
    addresses and cannot be persisted; ROADMAP C); ``hbm_budget`` sizes
    the pool from ``analysis.hbm.plan_kv_pool``.

    A tensor-parallel model (its ``tp_group``, e.g. under
    ``distributed.serving_mesh(dp=1, tp=n)``) is served by a predictor on
    every rank of the group, in lockstep (``inference.lockstep``): rank 0
    admits, schedules and sends each step-program call to the others,
    whose predictors only follow (``infer`` raises there). Close rank 0's
    first or together: its close ends the followers. Every rank passes its
    own ``AdapterRegistry`` over its model shards (rank 0's loads and
    unloads reach the others in lockstep), and the self-drafter's calls
    go through the lockstep like every step call.
    """

    _component = "continuous"
    supports_sampler_knobs = True   # serving.py gates per-request headers
    supports_streaming = True       # tick-boundary flushes -> infer_stream

    @property
    def supports_adapters(self):
        """X-Adapter gate: routing needs a registry."""
        return getattr(self, "adapters", None) is not None

    @property
    def supports_tenants(self):
        """X-Tenant gate: tenant routing needs a TenantLedger."""
        return getattr(self, "qos", None) is not None

    def __init__(self, model, max_slots=8, prefill_chunk=16,
                 prefill_token_budget=None, decode_steps=4, max_seq_len=None,
                 eos_token_id=None, max_defers=32, spec_k=0, drafter="ngram",
                 admit_policy="fifo", prefix_cache=False, warmup=False,
                 compile_cache_dir=None, hbm_budget=None, adapters=None,
                 qos=None, slo=None, flight_recorder=False,
                 utilization=False, **kwargs):
        if compile_cache_dir is not None:
            raise NotImplementedError(
                "compile_cache_dir= has no counterpart in the PyTorch "
                "scheduler: a CUDA graph holds device addresses and cannot "
                "be persisted (ROADMAP C); warmup=True captures anew")
        self.tp_group = model._tp()
        self._follower = self.tp_group is not None and self.tp_group.rank
        if self.tp_group is not None and not self._follower:
            model = LockstepLeader(model, self.tp_group)
            if adapters is not None:
                # loads and frees reach the followers' registries
                adapters._lockstep = model
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
        if (isinstance(model, LockstepLeader)
                and getattr(self._drafter, "model", None) is model._model):
            # a self-drafter given over the tensor-parallel model drafts
            # through the lockstep too
            self._drafter.model = model
        if admit_policy not in ("fifo", "shortest_prompt_first"):
            raise ValueError(f"unknown admit_policy {admit_policy!r} "
                             "(fifo | shortest_prompt_first)")
        self.admit_policy = admit_policy
        if adapters is not None and adapters.device != model.device:
            raise ValueError(f"adapter bank on {adapters.device}, model on "
                             f"{model.device}")
        # reorder buffer of non-FIFO and QoS admission (deque: atomic
        # appends and pops; the tick thread and close() touch it)
        self._backlog: collections.deque = collections.deque()
        self._spec_drafted = 0      # written under _slot_lock
        self._spec_accepted = 0
        self._seed = itertools.count(1)     # fresh sampling noise per tick
        self._slots: list = [None] * self.max_slots
        self._slot_lock = make_lock(
            "scheduler.ContinuousGenerateBatchingPredictor._slot_lock")
        self._prefix_cache_arg = prefix_cache
        self.prefix_cache = None
        self._prefix_hit_counter = None
        self.warmup = bool(warmup)
        self._warm_done = threading.Event()
        self._warm_armed = threading.Event()
        self._warm_stats: collections.deque = collections.deque(maxlen=8)
        self._warm_errors: collections.deque = collections.deque(maxlen=8)
        self._warm_thread = None
        self._recompile_counter = None
        self.adapters = adapters
        self._lora_requests_counter = None
        self.qos = qos
        self._paused: collections.deque = collections.deque()
        self.slo = slo
        if flight_recorder is False or flight_recorder is None:
            self.flight = None
        elif flight_recorder is True:
            from ..observability.flightrecorder import FlightRecorder
            self.flight = FlightRecorder()
        elif isinstance(flight_recorder, int):
            from ..observability.flightrecorder import FlightRecorder
            self.flight = FlightRecorder(capacity=flight_recorder)
        else:
            self.flight = flight_recorder
        if utilization is False or utilization is None:
            self.util = None
        elif utilization is True:
            from ..observability.utilization import UtilizationLedger
            self.util = UtilizationLedger()
        else:
            self.util = utilization
        self._last_launch = None        # tick-thread-only hook stash
        hook = self._gen_timing
        if self.util is not None:
            # the marker asks the step programs for their FLOPs (counted
            # once per key); without a ledger the launch path is unchanged
            def hook(info, _h=self._gen_timing):
                _h(info)
            hook.wants_flops = True
        self._timing_hook = hook
        self._ttft_hist = None
        self._tpot_hist = None
        self._max_seq_len_arg = max_seq_len
        self.max_seq_len = None             # finalized in _start_worker
        self.table_width = None
        # hbm_budget= sizes the pool FROM the residency plan
        # (analysis/hbm.py plan_kv_pool, JAX scheduler.py:465-487), so the
        # static lint and the runtime share one arithmetic. Under tensor
        # parallelism each rank holds 1/tp of the kv heads and its own
        # parameter shards: the plan is per chip.
        self.hbm_budget = None if hbm_budget is None else int(hbm_budget)
        self._hbm_plan = None
        if (self.hbm_budget is not None and kwargs.get("kv_cache") is None
                and "num_blocks" not in kwargs):
            kwargs["num_blocks"], self._hbm_plan = self._plan_pool(
                getattr(model, "_model", model), kwargs, adapters)
        super().__init__(model, max_batch_size=max_slots,
                         max_defers=max_defers, **kwargs)

    def _plan_pool(self, model, kwargs, adapters):
        """(num_blocks, plan): the pool's size from ``plan_kv_pool`` over
        the budget, and the plan the ``paddle_hbm_*`` gauges publish."""
        import torch

        from ..analysis.hbm import params_bytes_of, plan_kv_pool

        tp = 1 if self.tp_group is None else int(self.tp_group.nranks)
        layers, kv_h, hd = (int(x) for x in model._decode_cache_spec())
        sizing = plan_kv_pool(
            self.hbm_budget, num_layers=layers, num_kv_heads=kv_h,
            head_dim=hd, block_size=kwargs.get("block_size", 32),
            dtype=str(torch.bfloat16), slots=self.max_slots,
            max_seq_len=self._max_seq_len_arg,
            # this rank's shards, as the plan's whole replica (params / tp)
            params_bytes=params_bytes_of(model) * tp, tp=tp,
            name=kwargs.get("component") or self._component,
            prefill_chunk=self.prefill_chunk,
            decode_steps=self.decode_steps, spec_k=self.spec_k,
            eos_token_id=self.eos_token_id,
            decode_kernel=self.decode_kernel,
            adapter_bank_bytes=(0 if adapters is None
                                else adapters.bank_bytes()))
        return sizing["num_blocks"], sizing["plan"]

    def _start_worker(self):
        """Pool-dependent set-up, then the tick thread. The set-up is
        written under ``_slot_lock``: the gauges, the warmup thread and
        ``close()`` read it from other threads once the worker runs."""
        with self._slot_lock:
            pool_tokens = self.kv_cache.num_blocks * self.kv_cache.block_size
            self.max_seq_len = (int(self._max_seq_len_arg)
                                if self._max_seq_len_arg else pool_tokens)
            if self.max_seq_len > pool_tokens:
                raise ValueError(f"max_seq_len {self.max_seq_len} exceeds "
                                 f"the pool ({pool_tokens} tokens)")
            self.table_width = self.kv_cache.blocks_for(self.max_seq_len)
            (self._spec_counter, self._lora_requests_counter,
             self._ttft_hist,
             self._tpot_hist) = self._bind_scheduler_metrics()
            pc = self._prefix_cache_arg
            if pc:
                pc = (pc if isinstance(pc, PrefixCache)
                      else PrefixCache(self.kv_cache, faults=self._faults))
                if pc.kv is not self.kv_cache:
                    raise ValueError("the prefix cache indexes another "
                                     "pool")
                pc.bind_metrics(self.metrics.registry,
                                component=self._component)
                self._prefix_hit_counter = self.metrics.registry.counter(
                    "paddle_prefix_hit_tokens_total",
                    "Prompt tokens served from shared prefix blocks instead "
                    "of prefill compute", labels=("component",)).labels(
                        self._component)
                self.prefix_cache = pc
            self._recompile_counter = self.metrics.registry.counter(
                "paddle_serving_recompiles_total",
                "Post-ready step-program cold builds by program — stays 0 "
                "when the AOT warmup covered the compile-surface manifest "
                "(analysis/compilesurface.py)",
                labels=("component", "program"))
            if self.warmup and not self.fallback_dense and not self._follower:
                self._warm_thread = threading.Thread(
                    target=self._warm_start, name="warmup", daemon=True)
                self._warm_thread.start()
            else:
                self._warm_done.set()
        super()._start_worker()

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
        one), while shutting down and once the tick thread is dead for
        good. The fleet router skips replicas that are not ready."""
        return self._warm_done.is_set() and super().ready()

    # ------------------------------------------------------------- telemetry
    def _bind_scheduler_metrics(self):
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
        # the plan hbm_budget= sized the pool from, component by
        # component, next to the declared budget (JAX :597-610); absent
        # when the knob is off
        if self._hbm_plan is not None:
            reg.gauge(
                "paddle_hbm_budget_bytes",
                "Declared per-chip HBM budget the serving plan was sized "
                "against (scheduler hbm_budget= knob)",
                labels=("component",)).labels(self._component).set(
                    self.hbm_budget)
            planned = reg.gauge(
                "paddle_hbm_planned_bytes",
                "Planned per-chip HBM residency by plan component "
                "(analysis/hbm.py DeploymentPlan)", labels=("component",))
            for part, nbytes in self._hbm_plan.components().items():
                planned.labels(part).set(nbytes)
        # multi-LoRA telemetry: bank occupancy by state (loaded =
        # resident, pinned = refcounted by in-flight slots, free = open
        # rows) plus per-adapter admission counts. Absent without a
        # registry: a gauge that would always read 0 is noise.
        lora_counter = None
        if self.adapters is not None:
            lora = reg.gauge(
                "paddle_lora_adapters",
                "Adapter bank slots by state (loaded|pinned|free); slot 0 "
                "(base identity) is not counted",
                labels=("component", "state"))
            for state in ("loaded", "pinned", "free"):
                lora.labels(self._component, state).set_function(
                    lambda st=state: self.adapters.stats()[st])
            lora_counter = reg.counter(
                "paddle_lora_requests_total",
                "Admitted sequences by adapter name ('base' = no adapter)",
                labels=("component", "adapter"))
        # multi-tenant QoS telemetry: the ledger's tenant series
        # (requests/tokens/rate-limited/inflight — bound ONCE per registry,
        # fleet replicas sharing a ledger are no-ops) plus this scheduler's
        # own paused-width gauge and per-tenant backlog (scrape-time queue
        # scan: no incremental counters to drift across defer/requeue).
        if self.qos is not None:
            self.qos.bind_metrics(reg)
            reg.gauge(
                "paddle_sched_paused",
                "Preempted sequences parked off-slot (blocks retained; "
                "resumed through the prefix-hit continuation path)",
                labels=("component",)).labels(self._component).set_function(
                    lambda: float(len(self._paused)))
            backlog = reg.gauge(
                "paddle_tenant_backlog",
                "Queued (not yet slotted) requests by tenant on this "
                "scheduler (autoscaler pressure signal)",
                labels=("component", "tenant"))
            for name in self.qos.tenant_names():
                backlog.labels(self._component, name).set_function(
                    lambda n=name: float(self.tenant_backlog().get(n, 0)))
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
        # phase-attributed latency: TTFT (acceptance -> first
        # generated token) and TPOT (mean inter-token gap after the first,
        # with pause time excluded — preemption is a scheduling decision,
        # not model latency) per tenant. Untenanted traffic rides the
        # "default" label, so the families are live on every continuous
        # scheduler — retirement always observes them.
        from ..observability.metrics import DEFAULT_LATENCY_BUCKETS
        ttft_hist = reg.histogram(
            "paddle_serving_ttft_seconds",
            "Time to first generated token (acceptance -> first token) by "
            "tenant; door-rejected requests are never sampled",
            labels=("component", "tenant"), buckets=DEFAULT_LATENCY_BUCKETS)
        tpot_hist = reg.histogram(
            "paddle_serving_tpot_seconds",
            "Mean time per output token after the first (paused time "
            "excluded) by tenant",
            labels=("component", "tenant"),
            buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                     0.1, 0.25, 0.5, 1.0, 2.5))
        # SLO gauges exist IFF a monitor is installed (exposition
        # contract); with a flight recorder too, an alert edge dumps the
        # ring — the breach window's slot state survives the incident.
        if self.slo is not None:
            self.slo.bind_metrics(reg)
            if self.flight is not None:
                self.slo.on_alert(
                    lambda p: self.flight.mark_alert(
                        p.name, state=p.state(),
                        burn_fast=round(p.burn_rate("fast"), 4),
                        burn_slow=round(p.burn_rate("slow"), 4)))
        # utilization series exist IFF a ledger is installed (same
        # absent-iff-off exposition contract); the MFU gauge additionally
        # needs a known device peak — the ledger itself enforces that.
        if self.util is not None:
            self.util.bind_metrics(reg, component=self._component)
            self.metrics.attach_utilization(self.util)
        if self.flight is not None:
            occ = reg.gauge(
                "paddle_flightrec_ticks",
                "Flight-recorder ring state (occupancy = retained tick "
                "snapshots, capacity = ring bound, dropped = evicted)",
                labels=("component", "state"))
            occ.labels(self._component, "occupancy").set_function(
                lambda: float(self.flight.occupancy))
            occ.labels(self._component, "capacity").set_function(
                lambda: float(self.flight.capacity))
            occ.labels(self._component, "dropped").set_function(
                lambda: float(self.flight.dropped))
        return spec_counter, lora_counter, ttft_hist, tpot_hist

    def _acceptance_rate(self):
        with self._slot_lock:
            d, a = self._spec_drafted, self._spec_accepted
        return a / d if d else 0.0

    def _gen_timing(self, info):
        """Launch-latency histogram only: the base hook also counts
        batch*new_tokens as generated, but a tick's width includes masked
        idle slots — actual tokens are counted per sequence at retirement
        (_retire_ok) instead.

        Doubles as the post-ready compile sentinel's tap: once
        the AOT warmup armed it, any launch that had to cold-build its step
        program is a compile-surface violation — counted per program and
        reported to the chaos-suite witness (inference/warmup.py)."""
        self._last_launch = info    # tick fns read flops/launch_s
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
    def infer(self, ids, timeout=None, deadline=None, trace_id=None,
              max_new_tokens=None, temperature=None, top_k=None, spec=None,
              adapter=None, tenant=None):
        """One prompt in -> prompt + generated ids out.

        `max_new_tokens` (<= the server cap) asks for fewer tokens than the
        server-wide maximum; the sequence retires the moment it has them and
        its slot/blocks go to the next request — the aggregate-throughput
        win whole-request batching cannot give.

        `temperature` / `top_k` are PER-REQUEST sampler knobs (default
        greedy). They ride the step programs as traced per-slot arrays, so
        a greedy request and a temperature-0.8/top-k-40 request decode in
        the SAME tick of the SAME captured program — mixed-sampler traffic
        never forks step programs (pinned by the post-ready capture counter).

        `spec` (tri-state) opts this request out of speculative decoding
        (`spec=False`) when the scheduler runs with spec_k > 0: the slot
        rides the same verify program with zero drafts. `spec=True` is a
        no-op beyond the default; it cannot force speculation on a
        scheduler configured without it.

        `adapter` names a registered LoRA adapter; the request
        decodes through its low-rank delta in the SAME tick program as base
        and other-adapter batchmates. Unknown names (and any adapter on a
        registry-less scheduler) raise ValueError here, synchronously —
        HTTP maps it to 400, the X-Temperature taxonomy.

        `tenant` bills the request to a TenantLedger tenant:
        weighted fair-share admission, the tenant's token-budget rate
        limit at the door (429 + computed Retry-After), and its priority
        tier for preemption. Unknown names (and any tenant on a
        ledger-less scheduler) raise ValueError — the X-Adapter taxonomy;
        None rides the ledger's built-in default tenant."""
        if self._follower:
            raise RuntimeError(
                f"rank {self.tp_group.ranks[self._follower]} follows rank "
                f"{self.tp_group.ranks[0]} of its tensor-parallel group: "
                f"send requests to that rank")
        req = self._make_request([np.asarray(ids)], timeout, deadline,
                                 trace_id)
        if max_new_tokens is not None:
            req.max_new = max(1, min(int(max_new_tokens),
                                     self.max_new_tokens))
        if temperature is not None:
            req.temperature = float(temperature)
        if top_k is not None:
            req.top_k = int(top_k)
        if spec is not None:
            req.spec = bool(spec)
        self._route_adapter(req, adapter)
        self._route_tenant(req, tenant)
        return self._submit(req)

    def _route_adapter(self, req, adapter):
        """Validate-and-attach for infer/infer_stream's adapter= param.

        The name is checked NOW (a malformed request must fail before
        enqueue, 400-style) but resolved to a bank slot at ADMISSION —
        acquire() there takes the refcount pin for exactly the sequence's
        lifetime, and an unregister between submit and admit is then an
        admission failure, never a stale slot index."""
        if adapter is None:
            return
        if self.adapters is None:
            raise ValueError(
                "adapter routing needs an AdapterRegistry (scheduler "
                "adapters= knob); this scheduler serves the base model only")
        if not self.adapters.has(adapter):
            raise ValueError(f"unknown adapter {adapter!r}")
        req.adapter = adapter

    def _route_tenant(self, req, tenant):
        """Validate-and-attach for infer/infer_stream's tenant= param:
        unknown names fail NOW (400-style, before enqueue), None resolves
        to the ledger's default tenant, and a tenant on a ledger-less
        scheduler is a client misroute (same contract as _route_adapter)."""
        if tenant is None:
            if self.qos is not None:
                req.tenant = self.qos.resolve(None).name
            return
        if self.qos is None:
            raise ValueError(
                "tenant routing needs a TenantLedger (scheduler qos= "
                "knob); this scheduler serves untenanted traffic only")
        req.tenant = self.qos.resolve(tenant).name  # ValueError: unknown

    def infer_stream(self, ids, timeout=None, deadline=None, trace_id=None,
                     max_new_tokens=None, temperature=None, top_k=None,
                     spec=None, adapter=None, tenant=None):
        """Streaming twin of infer(): tokens arrive as the tick
        loop absorbs them instead of at retirement.

        Admission-time failures (ServerBusy / circuit open / malformed
        request) raise HERE, synchronously — an HTTP front end still maps
        them to proper 4xx/5xx statuses because no response bytes have
        flushed yet. The return value is an iterator yielding int64 arrays
        of newly generated tokens per tick-boundary flush; their
        concatenation is exactly infer()'s generated suffix (same sampler,
        same programs — streaming changes WHEN tokens are delivered, never
        WHICH). Terminal failures after acceptance (deadline mid-stream,
        shed, batch error) raise from the iterator; deadline semantics are
        identical to _await's client-side cancel."""
        req = self._make_request([np.asarray(ids)], timeout, deadline,
                                 trace_id)
        if max_new_tokens is not None:
            req.max_new = max(1, min(int(max_new_tokens),
                                     self.max_new_tokens))
        if temperature is not None:
            req.temperature = float(temperature)
        if top_k is not None:
            req.top_k = int(top_k)
        if spec is not None:
            req.spec = bool(spec)
        self._route_adapter(req, adapter)
        self._route_tenant(req, tenant)
        q: queue.Queue = queue.Queue()
        req.on_tokens = q.put       # published before enqueue (no races)
        self._start(req)            # raises Rejected/ValueError/503 here
        return self._stream_pump(req, q)

    def _stream_pump(self, req, q):
        """Generator half of infer_stream: drain the flush queue, mirroring
        _await's deadline-cancel / supervisor-heal loop between flushes."""
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
                            if req.trace is not None:
                                req.trace.finish("timeout", cas="timeout",
                                                 where="client_stream")
                            raise DeadlineExceeded(
                                "inference request timed out mid-stream")
                        break   # lost the race: terminal outcome landed
                    step = min(0.1, rem)
                try:
                    yield np.asarray(q.get(timeout=step), np.int64)
                    continue
                except queue.Empty:
                    pass
                if req.event.is_set():
                    break
                try:
                    if self._sup.heal():
                        self.metrics.inc("batcher_restarts")
                except ServiceUnavailable as e:
                    self._fail(req, e)
                    raise
            # flushes that landed between the last drain and the terminal CAS
            while True:
                try:
                    yield np.asarray(q.get_nowait(), np.int64)
                except queue.Empty:
                    break
            if req.error is not None:
                raise req.error
        except GeneratorExit:
            # consumer walked away mid-stream (client disconnect): same
            # terminal path as a client-side timeout — the tick loop
            # reclaims the slot at the next boundary
            if req.cancel():
                self.metrics.inc("timeouts")
                self._observe(req)
                if req.trace is not None:
                    req.trace.finish("timeout", cas="timeout",
                                     where="stream_abandoned")
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
        need = self.kv_cache.blocks_for(total)
        self.admission.admit(self._queue.qsize(), cache=self.kv_cache,
                             blocks_needed=need)
        if self.qos is not None and req is not None:
            # tenant token-budget rate limit: charged at the
            # door with the request's worst-case token bill; a shed raises
            # ServerBusy carrying the bucket's computed time-to-refill —
            # HTTP 429 with a Retry-After derived from the tenant's rate
            want = (req.max_new if req.max_new is not None
                    else self.max_new_tokens)
            self.qos.charge(getattr(req, "tenant", None), plen + want)

    def pending(self) -> int:
        """Queued + in-flight + paused sequences (drain condition)."""
        return (self._queue.qsize() + len(self._backlog)
                + len(self._paused) + self._phase_count(None))

    def tenant_backlog(self) -> dict:
        """Queued (not yet slotted) PENDING requests by tenant: a
        scrape-time scan of the arrival queue + reorder backlog, so there
        is no incremental counter to drift across defer/retry/requeue
        paths. Feeds the paddle_tenant_backlog gauge and the autoscaler's
        per-tenant pressure signal."""
        if self.qos is None:
            return {}
        counts: dict = {}
        for r in list(self._queue.queue) + list(self._backlog):
            if r.state != _PENDING:
                continue
            name = self._tenant_spec_of(r).name
            counts[name] = counts.get(name, 0) + 1
        return counts

    def _tenant_spec_of(self, req):
        """Request -> TenantSpec; anything unroutable rides the default
        tenant (routing already 400'd truly unknown names — this is the
        tick loop, which must never fail on a stray request field)."""
        try:
            return self.qos.resolve(getattr(req, "tenant", None))
        except ValueError:
            return self.qos.resolve(None)

    # ------------------------------------------------------------- tick loop
    def _loop(self):
        if self._follower:      # a tensor-parallel rank other than 0
            runs = follow(self.model, self.kv_cache, self.tp_group,
                          self.adapters)
            with self._slot_lock:
                self.follower_runs = runs
            return
        # ready gate: no tick runs (and so no step program can
        # cold-build under traffic) until the aot-warmup thread finished.
        # Wait with a poll so close() during warmup still exits promptly.
        while self.warmup and not self._warm_done.wait(0.05):
            if self._stop.is_set():
                return
        if self.fallback_dense:
            # signature-mismatch degradation: the paged step programs would
            # scatter garbage; serve through the base collect-and-run loop
            # (GenerateBatchingPredictor._run_batch -> _run_dense)
            return super()._loop()
        try:
            while not self._stop.is_set():
                try:
                    if self._faults is not None:
                        self._faults.check("batcher.tick")  # ThreadDeath
                    self._admit()
                    if self._phase_count(None) == 0:
                        continue        # _admit parked briefly on the queue
                    self._busy = True
                    if self.util is not None:   # tick window opens
                        self.util.tick_begin()
                    try:
                        self._retire_unserviceable()
                        self._prefill_tick()
                        self._decode_tick()
                        self._util_tick()       # close BEFORE the
                        self._flight_tick()     # ring captures last_tick
                    finally:
                        self._busy = False
                except ThreadDeath:
                    # the dying thread strands no sequence: blocks go back to
                    # the pool, pending requests re-enter the queue, and the
                    # supervisor-healed thread re-runs them from scratch
                    self._abandon_slots()
                    raise
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
        """Fill free slots from the queue (one tick's admissions).

        The reserve is atomic: a request either ends up fully reserved in a
        slot or the pool is untouched. On a dry pool the request defers or
        sheds (existing `_shed_or_defer` budget) and admission STOPS for
        this tick — blocks free as other slots retire, so later ticks
        retry; already-running slots never notice.

        With a TenantLedger (qos= knob) admission routes through
        `_qos_admit` instead: free slots go to the most under-served
        tenant's waiting work (paused sequences compete with new arrivals),
        then strictly more urgent waiters preempt the least urgent running
        sequences."""
        if self.qos is not None:
            return self._qos_admit()
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

    def _install_seq(self, idx, req) -> bool:
        """Admit ONE usable request into free slot `idx`: pin its adapter,
        consult the prefix cache, atomically reserve its blocks, and place
        the sequence. Returns False only on a dry pool (CacheOutOfBlocks →
        `_shed_or_defer`; the caller stops admitting this tick); every
        other failure is THIS request's terminal and admission continues."""
        arr = req.arrays[0]
        plen = len(arr)
        max_new = (req.max_new if req.max_new is not None
                   else self.max_new_tokens)
        seq_n = next(self._rid)     # atomic draw (itertools.count)
        rid = ("cseq", seq_n)
        tr = req.trace
        traced = self.tracer.enabled
        ids64 = np.asarray(arr, np.int64)
        # pin the request's adapter slot FIRST — acquire
        # bumps the bank-row refcount for exactly the sequence's
        # lifetime (released in _evict_slot), so an unregister racing
        # this admission either loses (we hold the pin) or wins (the
        # name is gone and THIS request fails 400-style; the batch is
        # untouched). The uid seed keys the prefix lookup below: same
        # tokens under a different adapter can never share KV.
        aslot, aseed = 0, b""
        if self.adapters is not None:
            aname = getattr(req, "adapter", None)
            try:
                aslot, aseed = self.adapters.acquire(aname)
            except ThreadDeath:
                raise
            except Exception as e:
                self._fail(req, e)
                return True
            self._lora_requests_counter.labels(
                self._component,
                "base" if aname is None else aname).inc()
        hit, t_px = None, 0.0
        pc = self.prefix_cache
        if pc is not None:
            t_px = self.tracer.now_us() if traced else 0.0
            try:
                hit = pc.lookup(ids64, seed=aseed)  # kv.prefix_match
            except ThreadDeath:
                raise
            except Exception as e:
                # a broken index lookup is a cache MISS, never a failed
                # request — the cold path below is always correct
                if traced and tr is not None:
                    tr.child("prefix_lookup", t_px, self.tracer.now_us(),
                             error=repr(e))
                hit = None
        t_kv = self.tracer.now_us() if traced else 0.0
        try:
            self.kv_cache.reserve(
                rid, plen + max_new,
                shared=hit.pairs if hit is not None else None)
        except CacheOutOfBlocks as e:
            if traced and tr is not None:
                tr.child("kv_reserve", t_kv, self.tracer.now_us(),
                         error=repr(e))
            if self.adapters is not None:
                self.adapters.release(aslot)
            self._shed_or_defer(req, e)
            return False
        except Exception as e:
            # an eviction-path fault (kv.prefix_evict chaos) is THIS
            # request's admission failure, never a dead worker:
            # reserve's undo left the pool byte-identical, so fail the
            # one request and keep admitting (exactly-once terminal)
            if traced and tr is not None:
                tr.child("kv_reserve", t_kv, self.tracer.now_us(),
                         error=repr(e))
            if self.adapters is not None:
                self.adapters.release(aslot)
            self._fail(req, e)
            return True
        if traced and tr is not None:
            tr.child("kv_reserve", t_kv, self.tracer.now_us(),
                     blocks=self.kv_cache.blocks_for(plen + max_new))
        self._end_queue_wait([req])
        seq = _SlotSeq(req, rid, ids64, arr.dtype, max_new, seq_n)
        seq.adapter = aslot
        seq.adapter_seed = aseed
        if self.qos is not None:
            # bill the slot to its tenant — the inflight count is
            # held for exactly the RUNNING span (pause releases it, resume
            # re-takes it, every evict path drops it), and the expected
            # service cost advances the tenant's virtual-time clock ONCE,
            # here: _qos_pick admits the smallest clock first, which is what
            # makes steady-state throughput weight-proportional
            spec = self._tenant_spec_of(req)
            seq.tenant = spec.name
            seq.priority = spec.priority
            self.qos.acquire(spec.name, cost=plen + max_new)
            seq.qos_held = True
            self.qos.note_admitted(spec.name)
        seq.table = self.kv_cache.block_table(rid,
                                              pad_to=self.table_width)
        if hit is not None:
            # rows already resident after revalidation: reserve set the
            # committed length to the acquired shared blocks — chunked
            # prefill resumes at the first novel token (~O(new tokens))
            got = int(self.kv_cache.length(rid))
            seq.prefix_hit = got
            seq.pos = seq.length = got
            seq.digests = hit.digests
            if got:
                self.metrics.inc("prefix_hit_tokens", got)
                self._prefix_hit_counter.inc(got)
            if traced and tr is not None:
                tr.child("prefix_lookup", t_px, self.tracer.now_us(),
                         matched_blocks=len(hit.pairs),
                         hit_tokens=got)
        seq.t_admit = self._clock()     # queue phase ends here
        with self._slot_lock:
            self._slots[idx] = seq
        self.metrics.inc("admitted_seqs")
        if tr is not None:
            tr.event("admitted", slot=idx, prompt_len=plen,
                     max_new=max_new)
        return True

    # ------------------------------------------------- multi-tenant QoS tick
    def _qos_admit(self):
        """Fair-share admission (qos= knob): free slots go to the waiting
        work — paused sequences AND queued arrivals, unified — of the most
        urgent tier's most under-served tenant; then strictly more urgent
        waiters preempt the least urgent running sequences. Host-side
        bookkeeping only: the step launches (and so the compile surface)
        are byte-identical to the untenanted scheduler's."""
        while True:     # drain arrivals into the reorder backlog
            try:
                self._backlog.append(self._queue.get_nowait())
            except queue.Empty:
                break
        if (not self._backlog and not self._paused
                and self._phase_count(None) == 0):
            try:        # fully idle: park briefly instead of spinning
                self._backlog.append(self._queue.get(timeout=0.05))
            except queue.Empty:
                return
        while True:
            idx = self._free_slot()
            if idx is None:
                break
            pick = self._qos_pick()
            if pick is None:
                break
            kind, item = pick
            if kind == "resume":
                self._resume_seq(idx, item)
            elif not self._install_seq(idx, item):
                return      # pool dry: stop admitting this tick
        self._preempt_for_priority()

    def _qos_pick(self):
        """Best waiting work item: ('resume', seq) | ('admit', req) | None.

        Order: priority tier first (lower = more urgent), then the
        tenant's fair-share deficit (inflight/weight — the MINIMUM is the
        most under-served, so contended slots converge to weight shares),
        then resumes before fresh admissions (a paused sequence holds
        blocks; finishing it frees memory), then arrival order."""
        while True:
            best = best_key = kind = None
            for s in self._paused:
                k = (s.priority, self.qos.fair_ratio(s.tenant), 0, s.order)
                if best_key is None or k < best_key:
                    best_key, best, kind = k, s, "resume"
            for pos, r in enumerate(self._backlog):
                spec = self._tenant_spec_of(r)
                k = (spec.priority, self.qos.fair_ratio(spec.name), 1, pos)
                if best_key is None or k < best_key:
                    best_key, best, kind = k, r, "admit"
            if best is None:
                return None
            if kind == "resume":
                try:
                    self._paused.remove(best)
                except ValueError:  # pragma: no cover - raced an evict
                    continue
                return ("resume", best)
            self._backlog.remove(best)
            if not self._usable(best):
                continue
            return ("admit", best)

    def _preempt_for_priority(self):
        """Priority preemption: while a waiting request (or paused
        sequence) is STRICTLY more urgent than the least urgent running
        sequence, pause that victim — blocks retained, slot state parked,
        tick width freed — and hand its slot to the waiter. Equal tiers
        never preempt each other (fair share handles those), so the loop
        terminates: each round strictly improves the worst running tier."""
        while self._backlog or self._paused:
            if self._free_slot() is not None:
                return      # width available; the admit loop already ran
            wprio = None
            for s in self._paused:
                wprio = (s.priority if wprio is None
                         else min(wprio, s.priority))
            for r in self._backlog:
                if r.state != _PENDING:
                    continue
                p = self._tenant_spec_of(r).priority
                wprio = p if wprio is None else min(wprio, p)
            if wprio is None:
                return
            with self._slot_lock:
                victim, vi = None, -1
                for i, s in enumerate(self._slots):
                    if s is None:
                        continue
                    if (victim is None or (s.priority, s.order)
                            > (victim.priority, victim.order)):
                        victim, vi = s, i
            if victim is None or victim.priority <= wprio:
                return
            self._pause_slot(vi, victim)
            idx = self._free_slot()
            pick = self._qos_pick() if idx is not None else None
            if pick is None:
                return      # victim resumes via a later tick's admit loop
            kind, item = pick
            if kind == "resume":
                self._resume_seq(idx, item)
            elif not self._install_seq(idx, item):
                return      # pool dry (the paused victim keeps its blocks)

    def _pause_slot(self, i, s):
        """Preempt a running sequence: park it off-slot with its blocks
        RETAINED (the rid stays reserved — preemption frees tick width,
        not memory; adapter pin included, so an unload can't race a paused
        sequence either) and release its tenant's fair-share count. The
        parked pos/tok/length/table bookkeeping is exactly the state a
        prefix-hit admission produces, so resume is plain continuation —
        bit-identical tokens, zero new captured programs."""
        t0 = self.tracer.now_us() if self.tracer.enabled else 0.0
        with self._slot_lock:
            if self._slots[i] is s:
                self._slots[i] = None
        if s.qos_held:
            s.qos_held = False
            self.qos.release(s.tenant)
        s.t_pause = self._clock()   # paused phase opens
        self._paused.append(s)
        self.metrics.inc("preempted_seqs")
        tr = s.req.trace
        if tr is not None:
            tr.child("preempt", t0, self.tracer.now_us(), slot=i,
                     phase=s.phase, committed=int(s.length))

    def _resume_seq(self, idx, s):
        """Reinstall a paused sequence into a free slot: its blocks and
        pos/length bookkeeping never left, so the next tick continues it
        exactly where it stopped (mid-prefill resumes its chunk walk at
        pos — the prefix-hit continuation path; mid-decode feeds tok back
        to the decode launch)."""
        t0 = self.tracer.now_us() if self.tracer.enabled else 0.0
        if self.qos is not None and not s.qos_held:
            self.qos.acquire(s.tenant)
            s.qos_held = True
        self._close_pause(s)
        with self._slot_lock:
            self._slots[idx] = s
        self.metrics.inc("resumed_seqs")
        tr = s.req.trace
        if tr is not None:
            tr.child("resume", t0, self.tracer.now_us(), slot=idx,
                     phase=s.phase, committed=int(s.length))

    def _next_request(self, block):
        """One queue pop under the admit policy.

        FIFO pops the arrival queue directly. shortest_prompt_first drains
        arrivals into a reorder backlog and admits the backlog's shortest
        prompt, tie-broken by the most urgent deadline, then arrival order
        (deterministic). The reorder window is only ever the set of
        requests waiting while a slot is free — a long prompt is delayed,
        never starved: it admits the moment it is the backlog minimum."""
        if self.admit_policy == "fifo":
            return (self._queue.get(timeout=0.05) if block
                    else self._queue.get_nowait())
        while True:                 # drain arrivals into the backlog
            try:
                self._backlog.append(self._queue.get_nowait())
            except queue.Empty:
                break
        if not self._backlog:
            if not block:
                raise queue.Empty
            self._backlog.append(self._queue.get(timeout=0.05))

        def urgency(item):
            pos, r = item        # backlog preserves arrival order
            rem = (r.deadline.remaining() if r.deadline is not None
                   else float("inf"))
            return (len(r.arrays[0]), rem, pos)
        _, best = min(enumerate(self._backlog), key=urgency)
        self._backlog.remove(best)
        return best

    # ----------------------------------------------------------- retirement
    def _evict_slot(self, i, s):
        """Free the slot and return its blocks to the pool (all retirement
        paths funnel here — blocks can never outlive their sequence)."""
        with self._slot_lock:
            if self._slots[i] is s:
                self._slots[i] = None
        self._release_seq(s)

    def _evict_paused(self, s):
        """Paused-sequence twin of _evict_slot: unpark and release (the
        blocks a preempted sequence retained must not outlive it either)."""
        try:
            self._paused.remove(s)
        except ValueError:  # pragma: no cover - already unparked
            pass
        self._release_seq(s)

    def _release_seq(self, s):
        """Return a sequence's held resources: tenant fair-share count,
        adapter bank pin, KV blocks. Idempotent on every leg (double-evict
        from shutdown racing retirement releases exactly once)."""
        if self.qos is not None and s.qos_held:
            s.qos_held = False
            self.qos.release(s.tenant)
        if self.adapters is not None and s.adapter != 0:
            # drop the admission-time bank-slot pin; zeroing first makes a
            # double-evict (shutdown racing retirement) release exactly once
            aslot, s.adapter = s.adapter, 0
            self.adapters.release(aslot)
        try:
            self.kv_cache.mark_done(s.rid)
            self.kv_cache.release(s.rid)
        except KeyError:    # pragma: no cover - already evicted/released
            pass

    # ------------------------------------------------ phase attribution (18)
    def _close_pause(self, s):
        """Fold an open pause interval into the sequence's paused-time
        accounting (called on resume and on any terminal path that can
        reach a still-parked sequence)."""
        if s.t_pause is None:
            return
        dt = max(0.0, self._clock() - s.t_pause)
        s.t_pause = None
        s.paused_s += dt
        if s.t_first is None:
            s.paused_pre_s += dt

    def _attribute(self, s, observe=True):
        """Close out a sequence's phase accounting at its terminal: park
        the {queue,prefill,paused,decode}_share dict on the request (the
        terminal CAS tags the terminal span with it) and, when `observe`,
        emit the per-tenant TTFT/TPOT samples and feed the SLO monitor.
        Retry paths pass observe=False — a re-batched request must not
        sample TTFT twice."""
        self._close_pause(s)
        req = s.req
        walls = phase_walls(req.t0, s.t_admit, s.t_first, self._clock(),
                            s.paused_s, s.paused_pre_s)
        req.attribution = attribution_shares(*walls)
        if not observe:
            return
        tenant = s.tenant if s.tenant is not None else "default"
        if s.t_first is not None and req.t0 is not None:
            ttft = max(0.0, s.t_first - req.t0)
            self._ttft_hist.labels(self._component, tenant).observe(ttft)
            if self.slo is not None:
                self.slo.observe_ttft(ttft, tenant=tenant)
            if s.n_tok > 1:
                # decode wall with post-first-token pauses excluded: a
                # preempted sequence's park time is a scheduling decision,
                # never charged to TPOT
                gap = max(0.0, (s.t_last - s.t_first)
                          - (s.paused_s - s.paused_pre_s))
                tpot = gap / (s.n_tok - 1)
                self._tpot_hist.labels(self._component, tenant).observe(tpot)
                if self.slo is not None:
                    self.slo.observe_tpot(tpot, tenant=tenant)

    def _terminal_good(self, error):
        """Availability verdict of one terminal outcome: good iff the HTTP
        status the error maps to is non-5xx (mirrors the server's
        _fail_http taxonomy — a 400/429 is the client's problem, not an
        availability hit)."""
        if error is None:
            return True
        status = getattr(error, "status", None)     # Rejected carries one
        if status is None:
            if isinstance(error, TimeoutError):
                status = 504
            elif isinstance(error, CacheOutOfBlocks):
                status = 503
            elif isinstance(error, ValueError):
                status = 400
            else:
                status = 500
        return int(status) < 500

    def _finish_req(self, req, result) -> bool:
        won = super()._finish_req(req, result)
        if won and self.slo is not None:
            self.slo.observe_terminal(
                True, tenant=getattr(req, "tenant", None))
        return won

    def _fail(self, req, error) -> bool:
        won = super()._fail(req, error)
        if won and self.slo is not None:
            self.slo.observe_terminal(
                self._terminal_good(error),
                tenant=getattr(req, "tenant", None))
        return won

    def _util_tick(self):
        """Close the utilization ledger's tick window: tick wall
        minus the recorded launch walls becomes the host gap, the per-kind
        flops land on the counters. Ledger failures never take the tick
        loop down (same contract as the flight ring)."""
        if self.util is None:
            return
        try:
            self.util.tick_end()
        except ThreadDeath:
            raise
        except Exception:       # pragma: no cover - telemetry must not bite
            pass

    def _util_launch(self, program, total_units, slot_units, spec_units=0):
        """Attribute the tick's just-returned launch to the ledger. The
        timing hook stashed the launch's flops/launch_s on this thread; a
        path mismatch means the hook never fired for this program (warmup
        interleave) — skip rather than misattribute."""
        info = self._last_launch
        if info is None or info.get("path") != program:
            return
        try:
            self.util.record_launch(program, info.get("flops"),
                                    info.get("launch_s", 0.0),
                                    total_units, slot_units, spec_units)
        except ThreadDeath:
            raise
        except Exception:       # pragma: no cover - telemetry must not bite
            pass

    def _flight_tick(self):
        """One flight-recorder capture at the tick boundary: the
        slot map with per-slot tenant/adapter/phase/progress, batch widths,
        KV block accounting, paused/pending depths and the ledger's fair
        ratios. Capture failures are swallowed — the postmortem ring must
        never take the tick loop down."""
        rec = self.flight
        if rec is None:
            return
        try:
            with self._slot_lock:
                slots = [None if s is None else {
                    "slot": i, "tenant": s.tenant, "adapter": int(s.adapter),
                    "phase": s.phase, "plen": s.plen, "pos": int(s.pos),
                    "generated": len(s.generated), "priority": s.priority,
                } for i, s in enumerate(self._slots)]
            live = [d for d in slots if d is not None]
            kv = self.kv_cache
            snap = {
                "slots": slots,
                "width": {
                    "prefill": sum(1 for d in live
                                   if d["phase"] == _PREFILL),
                    "decode": sum(1 for d in live if d["phase"] == _DECODE),
                    "free": self.max_slots - len(live),
                },
                "kv": {"in_use": int(kv.blocks_in_use),
                       "free": int(kv.free_blocks),
                       "evictable": int(kv.evictable_blocks)},
                "paused": len(self._paused),
                "pending": self._queue.qsize() + len(self._backlog),
            }
            if self.qos is not None:
                snap["fair_ratios"] = self.qos.fair_snapshot()
            if self.util is not None and self.util.last_tick is not None:
                # the tick's own flops/gap decomposition rides
                # the ring — /debug/ticks shows WHY MFU dipped (which
                # slots were empty, which drafts died)
                snap["util"] = self.util.last_tick
            rec.record(snap)
        except ThreadDeath:
            raise
        except Exception:       # pragma: no cover - capture must not bite
            pass

    def _retire_ok(self, i, s):
        out = np.concatenate(
            [s.ids, np.asarray(s.generated[:s.max_new], np.int64)])
        # index the generated tail BEFORE the audit-only set_length below
        # rewrites the committed length: only rows actually written are
        # indexable (a decode tick's final launch may sample past max_new,
        # but the in-program write ceiling drops those rows — cap to it)
        self._register_prefix(s, out, min(s.length, s.plen + s.max_new),
                              digests=None)
        try:
            self.kv_cache.set_length(s.rid, s.plen + s.max_new)
        except (KeyError, ValueError):  # pragma: no cover - audit-only state
            pass
        self._attribute(s)      # shares + TTFT/TPOT samples
        self._finish_req(s.req, out.astype(s.out_dtype))
        if self.qos is not None and s.tenant is not None:
            # useful tokens by tenant: a fairness measure's
            # numerator is work DELIVERED at retirement, not work admitted
            self.qos.account(s.tenant, len(s.generated[:s.max_new]))
        self._evict_slot(i, s)
        self.metrics.inc("retired_seqs")
        self.metrics.inc("generated_tokens", len(s.generated[:s.max_new]))
        self._tokens_total.labels(self._component).inc(len(s.generated))

    def _retire_unserviceable(self):
        """Per token-step deadline/cancel semantics: at every tick boundary a
        sequence whose client cancelled, or whose deadline expired mid-
        decode, is retired and its blocks freed — exactly one terminal
        outcome via the request CAS, batchmates untouched."""
        for i, s in enumerate(list(self._slots)):
            if s is None:
                continue
            req = s.req
            if req.state != _PENDING:
                self.metrics.inc("cancelled_skipped")
                if req.trace is not None:
                    req.trace.event("slot_reclaimed_after_cancel", slot=i)
                self._evict_slot(i, s)
                self.metrics.inc("retired_seqs")
                continue
            if req.deadline is not None and req.deadline.expired():
                self._attribute(s)      # where the deadline actually went
                if self._fail(req, DeadlineExceeded(
                        "deadline expired mid-decode (continuous tick)")):
                    self.metrics.inc("expired_in_flight")
                self._evict_slot(i, s)
                self.metrics.inc("retired_seqs")
        # paused (preempted) sequences age under the same contract: a
        # cancelled or expired one frees its retained blocks NOW instead of
        # waiting to be resumed (exactly-once terminal via the request CAS)
        for s in list(self._paused):
            req = s.req
            if req.state != _PENDING:
                self.metrics.inc("cancelled_skipped")
                if req.trace is not None:
                    req.trace.event("paused_reclaimed_after_cancel")
                self._evict_paused(s)
                self.metrics.inc("retired_seqs")
            elif req.deadline is not None and req.deadline.expired():
                self._attribute(s)      # paused_share carries the park time
                if self._fail(req, DeadlineExceeded(
                        "deadline expired while preempted (paused)")):
                    self.metrics.inc("expired_in_flight")
                self._evict_paused(s)
                self.metrics.inc("retired_seqs")

    def _absorb(self, i, s, toks) -> bool:
        """Fold one tick's sampled tokens into the sequence; True if it
        retired. EOS freezes the remainder (parity with the in-scan
        sampler's finished mask, which resets per launch)."""
        eos = self.eos_token_id
        absorbed = 0
        for t in toks:
            if len(s.generated) >= s.max_new:
                break
            t = int(t)
            s.generated.append(t)
            absorbed += 1
            if eos is not None and t == eos:
                s.generated.extend([eos] * (s.max_new - len(s.generated)))
                break
        if absorbed:
            # first/last token stamps (tick-boundary resolution —
            # TPOT is the mean inter-token gap, and a tick absorbs
            # decode_steps tokens at once, so per-token jitter averages out)
            now = self._clock()
            if s.t_first is None:
                s.t_first = now
            s.t_last = now
            s.n_tok += absorbed
        self._flush_stream(s)
        if len(s.generated) >= s.max_new:
            self._retire_ok(i, s)
            return True
        return False

    def _flush_stream(self, s):
        """Tick-boundary streaming: push newly absorbed tokens
        through the request's on_tokens channel so infer_stream() clients
        see them NOW, not at retirement. A broken consumer never takes the
        tick loop down — the buffered result is still delivered."""
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
        except Exception:       # pragma: no cover - consumer bug
            pass

    def _fail_picks(self, picks, error, span_name, t0):
        self.breaker.record_failure()
        self.metrics.inc("batch_failures")
        reqs = [s.req for _, s in picks]
        self._span_each(reqs, span_name, t0, self.tracer.now_us(),
                        error=repr(error))
        for i, s in picks:
            # shares only (observe=False): a retry re-enters the queue and
            # must not sample TTFT twice — a retried-then-served request
            # samples once, at its eventual retirement
            self._attribute(s, observe=False)
            self._evict_slot(i, s)
            self._fail_or_retry(s.req, error)

    def _adapter_tick_kwargs(self, picks, reqs):
        """Per-tick LoRA launch kwargs: the traced [S] bank-index
        vector — each live slot gathers its adapter's rows, idle slots ride
        identity row 0. The host-side assembly is recorded as the
        `adapter_gather` span with the tick's distinct-adapter count (the
        heterogeneity dial: 1 means merged-weights would have done)."""
        if self.adapters is None:
            return {}
        traced = self.tracer.enabled
        t_g = self.tracer.now_us() if traced else 0.0
        aidx = np.zeros(self.max_slots, np.int32)
        for i, s in picks:
            aidx[i] = s.adapter
        if traced:
            self._span_each(reqs, "adapter_gather", t_g,
                            self.tracer.now_us(),
                            distinct_adapters=len({int(a) for a in aidx}))
        return dict(adapters=self.adapters, adapter_slots=aidx)

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
        tks = np.zeros(S, np.int32)
        tables = np.zeros((S, self.table_width), np.int32)
        for i, s, take in picks:
            chunk[i, :take] = s.ids[s.pos:s.pos + take]
            offs[i] = s.pos
            lens[i] = take
            temps[i] = s.temperature
            tks[i] = s.top_k
            tables[i] = s.table
        reqs = [s.req for _, s, _ in picks]
        akw = self._adapter_tick_kwargs([(i, s) for i, s, _ in picks], reqs)
        traced = self.tracer.enabled
        t0 = self.tracer.now_us() if traced else 0.0
        try:
            if self._faults is not None:
                self._faults.check("predictor.generate")
            tk = self.model.prefill_chunk(
                chunk, offs, lens, self.kv_cache, tables,
                temperature=temps, top_k=tks,
                eos_token_id=self.eos_token_id,
                decode_kernel=self.decode_kernel, seed=next(self._seed),
                timing_hook=self._timing_hook, **akw)
        except ThreadDeath:
            raise
        except Exception as e:
            self._fail_picks([(i, s) for i, s, _ in picks], e,
                             "prefill_chunk", t0)
            return
        self.breaker.record_success()
        self.metrics.inc("prefill_ticks")
        if self.util is not None:
            # useful positions are exactly each pick's take; the
            # S*C - sum(take) remainder (idle slots, chunk tail) is pad
            self._util_launch("prefill_chunk", S * C,
                              [(s.tenant, take) for _, s, take in picks])
        self._span_each(reqs, "prefill_chunk", t0, self.tracer.now_us(),
                        slots=len(picks),
                        tokens=int(sum(t for _, _, t in picks)))
        for i, s, take in picks:
            s.pos += take
            s.length = s.pos
            try:
                self.kv_cache.append_tokens(s.rid, take)
            except KeyError:    # pragma: no cover - raced an eviction
                pass
            self._register_prefix(s, s.ids, s.pos)
            if s.pos >= s.plen:
                s.phase = _DECODE
                s.tok = int(tk[i])
                self._absorb(i, s, [s.tok])

    def _register_prefix(self, s, tokens, committed, digests="prompt"):
        """Index this sequence's freshly COMMITTED full blocks (prefill
        chunks as they land, reusing the admission-time digest chain; the
        whole prompt+generation at retirement, rehashed since generated
        blocks have no precomputed digests). Registration is best-effort:
        an index failure must never take the sequence with it."""
        pc = self.prefix_cache
        if pc is None:
            return
        try:
            pc.register(s.rid, tokens,
                        digests=s.digests if digests == "prompt" else None,
                        length=int(committed), seed=s.adapter_seed)
        except ThreadDeath:
            raise
        except Exception:       # pragma: no cover - index bug, stay cold
            pass

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
        tks = np.zeros(S, np.int32)
        tables = np.zeros((S, self.table_width), np.int32)
        for i, s in dec:
            tok[i] = s.tok
            lengths[i] = s.length
            maxlens[i] = s.plen + s.max_new   # write ceiling: reserved rows
            active[i] = True
            temps[i] = s.temperature
            tks[i] = s.top_k
            tables[i] = s.table
        reqs = [s.req for _, s in dec]
        akw = self._adapter_tick_kwargs(dec, reqs)
        traced = self.tracer.enabled
        t0 = self.tracer.now_us() if traced else 0.0
        try:
            if self._faults is not None:
                self._faults.check("predictor.generate")
            toks = self.model.decode_step(
                tok, lengths, active, self.kv_cache, tables, steps=T,
                max_lens=maxlens, temperature=temps, top_k=tks,
                eos_token_id=self.eos_token_id,
                decode_kernel=self.decode_kernel, seed=next(self._seed),
                timing_hook=self._timing_hook, **akw)
        except ThreadDeath:
            raise
        except Exception as e:
            self._fail_picks(dec, e, "decode_step", t0)
            return
        self.breaker.record_success()
        self.metrics.inc("decode_ticks")
        self._span_each(reqs, "decode_step", t0, self.tracer.now_us(),
                        slots=len(dec), steps=T)
        units = []
        for i, s in dec:
            s.length += T
            s.tok = int(toks[i, -1])
            n0 = s.n_tok
            self._absorb(i, s, toks[i])
            # useful = tokens the sequence actually ABSORBED this
            # tick (EOS-frozen / over-cap rows are pad, like idle slots)
            units.append((s.tenant, s.n_tok - n0))
        if self.util is not None:
            self._util_launch("decode_step", S * T, units)

    def _verify_tick(self):
        """Speculative decode tick (spec_k > 0): draft on the host, verify
        in ONE fixed-width `verify_step` launch across all decoding slots.

        Per slot the drafted width is min(drafter proposal, SPARE width) —
        spare = tokens still owed minus the launch's guaranteed one, so a
        slot about to retire rides along with zero drafts instead of
        forking a narrower program. Rollback on rejection is length
        bookkeeping only (verify_step's contract); the KV ceiling stays
        the reserved plen + max_new exactly like the decode tick."""
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
        tks = np.zeros(S, np.int32)
        tables = np.zeros((S, self.table_width), np.int32)
        for i, s in dec:
            # shared-prefix safety: a verify launch writes its
            # whole window at [length, length+1+K) and rejection "rollback"
            # is length bookkeeping only — length never drops below plen,
            # and a prefix hit covers at most plen-1 tokens, so a verify
            # tick can never write into (or roll back into) a shared block
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
        reqs = [s.req for _, s in dec]
        akw = self._adapter_tick_kwargs(dec, reqs)
        traced = self.tracer.enabled
        t0 = self.tracer.now_us() if traced else 0.0
        try:
            if self._faults is not None:
                self._faults.check("predictor.generate")
            acc, nxt = self.model.verify_step(
                chunk, offs, dlens, active, self.kv_cache, tables,
                max_lens=maxlens, temperature=temps, top_k=tks,
                decode_kernel=self.decode_kernel, seed=next(self._seed),
                timing_hook=self._timing_hook, **akw)
        except ThreadDeath:
            raise
        except Exception as e:
            self._fail_picks(dec, e, "verify_step", t0)
            return
        self.breaker.record_success()
        self.metrics.inc("verify_ticks")
        drafted = int(sum(dlens[i] for i, _ in dec))
        accepted = int(sum(acc[i] for i, _ in dec))
        self._span_each(reqs, "verify_step", t0, self.tracer.now_us(),
                        slots=len(dec), drafted=drafted, accepted=accepted)
        self._spec_counter.labels(self._component, "drafted").inc(drafted)
        self._spec_counter.labels(self._component, "accepted").inc(accepted)
        self._spec_counter.labels(self._component,
                                  "wasted").inc(drafted - accepted)
        with self._slot_lock:
            self._spec_drafted += drafted
            self._spec_accepted += accepted
        units = []
        for i, s in dec:
            a = int(acc[i])
            s.length += 1 + a   # committed rows: accepted prefix + emitted
            s.tok = int(nxt[i])
            n0 = s.n_tok
            self._absorb(i, s, [int(t) for t in chunk[i, 1:1 + a]]
                         + [s.tok])
            # useful = absorbed (accepted prefix + the emitted
            # token, minus any over-cap shortfall); rejected drafts are
            # spec_waste; the rest of the S*(K+1) window is pad
            units.append((s.tenant, s.n_tok - n0))
        if self.util is not None:
            self._util_launch("verify_step", S * (K + 1), units,
                              spec_units=drafted - accepted)

    # ------------------------------------------------------------- lifecycle
    def _abandon_slots(self):
        """ThreadDeath path: free every slot's blocks; still-pending
        requests re-enter the queue and re-run from scratch after the
        supervisor heals the thread (their chunked-prefill progress is
        lost with the thread — correctness over cleverness)."""
        for i, s in enumerate(list(self._slots)):
            if s is None:
                continue
            self._evict_slot(i, s)
            if s.req.state == _PENDING:
                if s.req.trace is not None:
                    s.req.trace.event("requeued_after_thread_death")
                self._enqueue(s.req)
        for s in list(self._paused):
            # paused sequences lose their progress with the thread too:
            # blocks back to the pool, still-pending requests re-enter the
            # queue and re-run from scratch (correctness over cleverness)
            self._evict_paused(s)
            if s.req.state == _PENDING:
                if s.req.trace is not None:
                    s.req.trace.event("requeued_after_thread_death")
                self._enqueue(s.req)

    def _shutdown_slots(self):
        """stop() path: nobody hangs on a closed scheduler."""
        for i, s in enumerate(list(self._slots)):
            if s is None:
                continue
            self._fail(s.req, ServiceUnavailable("predictor closed",
                                                 retry_after=None))
            self._evict_slot(i, s)
        for s in list(self._paused):
            self._fail(s.req, ServiceUnavailable("predictor closed",
                                                 retry_after=None))
            self._evict_paused(s)
        self._drain_backlog()

    def _drain_backlog(self):
        """Backlog twin of close()'s queue drain: requests parked in the
        admit-policy reorder buffer get a terminal outcome too."""
        while True:
            try:
                r = self._backlog.popleft()
            except IndexError:
                break
            self._fail(r, ServiceUnavailable("predictor closed",
                                             retry_after=None))

    def close(self):
        super().close()
        self._drain_backlog()
        if self._warm_thread is not None:   # a launch cannot be cut short
            self._warm_thread.join(timeout=60)
        if isinstance(self.model, LockstepLeader):
            self.model.stop()           # the followers' loops end
        elif self._follower:
            self._sup.thread.join(timeout=60)
