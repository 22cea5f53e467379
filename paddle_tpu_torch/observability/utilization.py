"""Fleet utilization ledger: per-tick FLOPs attribution.

The port's own copy of ``paddle_tpu/observability/utilization.py``
(pure Python).

The continuous scheduler launches FIXED-WIDTH programs — prefill_chunk
[S, C], decode_step [S]xT, verify_step [S, K+1] — so every launch issues a
CONSTANT amount of compute regardless of how much of it serves live
tokens. Padding (idle slots, masked chunk tail, EOS-frozen rows), rejected
speculation and host gaps between launches are all invisible to the
existing token counters: a fleet can read "healthy tok/s" while most of
its FLOPs heat pad rows. This module makes the waste a first-class,
CONSERVED quantity:

    issued == useful + pad_waste + spec_waste        (exactly, per tick)
    sum(per-tenant billed) == useful                 (exactly)

Exactness is by construction, not by epsilon: all attribution happens in
INTEGER flops units. A launch's issued FLOPs (``observability/device.py
cost_flops``: counted once per program cache key over one run of the
step program's body under ``torch.utils.flop_counter``, never inside a
capture; aten products only, so the hand-written paged attention kernel's
FLOPs are not in the count) are split token-proportionally with floor
division — ``useful_i = issued * units_i // total_units`` — and pad_waste
absorbs the rounding remainder, so the invariants above hold bit-exactly
and the conservation property sweep (tests/test_torch_utilization.py) can
assert ``==`` after every tick under mixed greedy / sampled / spec /
preempted traffic.
Tenant bills are the SAME per-slot integers grouped by tenant, so the
chargeback sum closes on useful by construction too; preempted (paused)
sequences are off-slot and contribute no units, so paused time can never
bill a tenant.

Tick wall-time splits the same way: launch wall (the device-side work,
summed from the generation timing hook) vs HOST GAP (everything else the
tick spent on the host — admission bookkeeping, numpy assembly, absorb).
The gap histogram is the dispatch-efficiency dial ROADMAP's disaggregated
prefill/decode item needs before tiers can be sized.

Exported series (absent-iff-off, like every optional subsystem):

* ``paddle_serving_flops_total{component,kind}`` — kind in
  useful | pad | spec_waste; the sum over kinds is issued.
* ``paddle_tenant_flops_total{component,tenant}`` — chargeback counters.
* ``paddle_serving_host_gap_seconds{component}`` — per-tick histogram.
* ``paddle_serving_mfu{component}`` — rolling-window useful FLOP/s over
  ``device_peak_flops`` — registered only when the peak is KNOWN (real
  accelerator or an injected ``peak_flops=``); on CPU the gauge is absent,
  never a made-up number (same contract as training MFU).
"""
from __future__ import annotations

import collections
import threading
import time

from .device import device_peak_flops

__all__ = ["UtilizationLedger", "attribute_launch", "HOST_GAP_BUCKETS"]

# per-tick host gaps are sub-millisecond on a healthy scheduler and spike
# to tens of ms when the host falls behind — finer-than-latency buckets
HOST_GAP_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                    0.025, 0.05, 0.1, 0.25, 0.5, 1.0)


def attribute_launch(flops, total_units, slot_units, spec_units=0):
    """Integer decomposition of one launch's issued FLOPs.

    ``slot_units``: iterable of ``(tenant_or_None, useful_units)`` — one
    entry per live slot. ``spec_units``: rejected draft positions across
    the launch. Returns ``(issued, useful, pad, spec, bills)`` where
    ``bills`` maps tenant name -> integer flops and every invariant holds
    exactly: ``issued == useful + pad + spec``, ``sum(bills) == useful``.

    Floor division can only UNDER-attribute each slot, so pad (the
    remainder) is always >= 0 as long as the caller's units fit the
    launch: ``sum(useful_units) + spec_units <= total_units``.
    """
    issued = max(0, int(round(flops or 0.0)))
    total = int(total_units)
    useful = 0
    bills: dict = {}
    spec = 0
    if issued > 0 and total > 0:
        for tenant, units in slot_units:
            units = int(units)
            if units <= 0:
                continue
            share = issued * units // total
            if share <= 0:
                continue
            useful += share
            key = "default" if tenant is None else str(tenant)
            bills[key] = bills.get(key, 0) + share
        spec = issued * int(spec_units) // total
    pad = issued - useful - spec
    return issued, useful, pad, spec, bills


class UtilizationLedger:
    """Per-tick FLOPs/wall decomposition for one continuous scheduler.

    The tick thread drives ``tick_begin`` / ``record_launch`` /
    ``tick_end``; gauges and the ``/utilization`` endpoint read
    ``snapshot()`` / ``last_tick`` from other threads (totals are guarded
    by a lock; in-tick accumulators are tick-thread-only).

    ``peak_flops``: MFU denominator (FLOP/s). Default resolves
    ``device_peak_flops`` of the current CUDA device (or ``device``) — None
    on the CPU and on a card the peak table does not hold, which
    leaves the MFU gauge unregistered (absent-iff-off). ``clock`` is
    injectable for deterministic tests.
    """

    def __init__(self, *, peak_flops=None, device=None,
                 clock=time.monotonic, mfu_window_s=10.0,
                 gap_samples=1024):
        if peak_flops is None:
            if device is None:
                import torch

                if torch.cuda.is_available():
                    device = torch.device("cuda",
                                          torch.cuda.current_device())
            if device is not None:
                peak_flops = device_peak_flops(device)
        self.peak_flops = peak_flops
        self._clock = clock
        self.mfu_window_s = float(mfu_window_s)
        self._lock = threading.Lock()
        # lifetime totals (integer flops, exact)
        self.issued = 0
        self.useful = 0
        self.pad_waste = 0
        self.spec_waste = 0
        self.by_tenant: dict = {}
        self.ticks = 0
        self.launches = 0
        self.launch_wall_s = 0.0
        self.host_gap_s = 0.0
        self._gaps = collections.deque(maxlen=int(gap_samples))
        # MFU window: (t_end, tick_wall_s, useful_flops) per tick
        self._window: collections.deque = collections.deque()
        self.last_tick = None
        # in-tick state — tick thread only
        self._t0 = None
        self._tick = None
        # metric children, bound by bind_metrics (None = no registry)
        self._flops_counter = None
        self._tenant_counter = None
        self._gap_hist = None

    # ------------------------------------------------------------- metrics
    def bind_metrics(self, registry, component="continuous"):
        """Register the utilization series on ``registry``. The MFU gauge
        binds only when ``peak_flops`` is known — a denominator-less MFU
        would be a made-up number, so on CPU the series is simply absent."""
        self._component = component
        self._flops_counter = registry.counter(
            "paddle_serving_flops_total",
            "Issued step-program FLOPs decomposed by kind; conservation: "
            "useful + pad + spec_waste == issued (exact, integer units)",
            labels=("component", "kind"))
        self._tenant_counter = registry.counter(
            "paddle_tenant_flops_total",
            "Useful FLOPs billed per tenant (chargeback); the sum over "
            "tenants equals the useful kind exactly — paused sequences "
            "are off-slot and never billed",
            labels=("component", "tenant"))
        self._gap_hist = registry.histogram(
            "paddle_serving_host_gap_seconds",
            "Per-tick host time outside step-program launches (tick wall "
            "minus launch wall) — the dispatch-efficiency dial",
            labels=("component",), buckets=HOST_GAP_BUCKETS).labels(
                component)
        if self.peak_flops:
            registry.gauge(
                "paddle_serving_mfu",
                "Serving model FLOPs utilization: rolling-window USEFUL "
                "FLOP/s over device_peak_flops (pad and rejected "
                "speculation excluded — the honest utilization number)",
                labels=("component",)).labels(component).set_function(
                    self.mfu)
        return self

    # ------------------------------------------------------------ tick API
    def tick_begin(self):
        self._t0 = self._clock()
        self._tick = {
            "issued": 0, "useful": 0, "pad": 0, "spec_waste": 0,
            "launch_s": 0.0, "tenants": {}, "programs": {},
        }

    def record_launch(self, program, flops, launch_s, total_units,
                      slot_units, spec_units=0):
        """Attribute one launch inside the current tick. ``slot_units`` is
        ``[(tenant_or_None, useful_units), ...]`` per live slot — the
        scheduler's ground truth of which positions carried live tokens."""
        if self._tick is None:      # launch outside a tick (warmup): skip
            return
        issued, useful, pad, spec, bills = attribute_launch(
            flops, total_units, slot_units, spec_units)
        t = self._tick
        t["issued"] += issued
        t["useful"] += useful
        t["pad"] += pad
        t["spec_waste"] += spec
        t["launch_s"] += float(launch_s or 0.0)
        for tenant, share in bills.items():
            t["tenants"][tenant] = t["tenants"].get(tenant, 0) + share
        p = t["programs"].setdefault(
            program, {"issued": 0, "useful": 0, "pad": 0, "spec_waste": 0,
                      "launches": 0})
        p["issued"] += issued
        p["useful"] += useful
        p["pad"] += pad
        p["spec_waste"] += spec
        p["launches"] += 1

    def tick_end(self):
        if self._tick is None:
            return None
        t, self._tick = self._tick, None
        now = self._clock()
        wall = max(0.0, now - (self._t0 if self._t0 is not None else now))
        self._t0 = None
        gap = max(0.0, wall - t["launch_s"])
        t["wall_s"] = wall
        t["host_gap_s"] = gap
        launches = sum(p["launches"] for p in t["programs"].values())
        with self._lock:
            self.issued += t["issued"]
            self.useful += t["useful"]
            self.pad_waste += t["pad"]
            self.spec_waste += t["spec_waste"]
            for tenant, share in t["tenants"].items():
                self.by_tenant[tenant] = (self.by_tenant.get(tenant, 0)
                                          + share)
            self.ticks += 1
            self.launches += launches
            self.launch_wall_s += t["launch_s"]
            self.host_gap_s += gap
            self._gaps.append(gap)
            self._window.append((now, wall, t["useful"]))
            self._prune_window(now)
            self.last_tick = t
        if self._flops_counter is not None:
            c = self._flops_counter
            c.labels(self._component, "useful").inc(t["useful"])
            c.labels(self._component, "pad").inc(t["pad"])
            c.labels(self._component, "spec_waste").inc(t["spec_waste"])
            for tenant, share in t["tenants"].items():
                self._tenant_counter.labels(
                    self._component, tenant).inc(share)
            self._gap_hist.observe(gap)
        return t

    def _prune_window(self, now):
        horizon = now - self.mfu_window_s
        w = self._window
        while w and w[0][0] < horizon:
            w.popleft()

    # ------------------------------------------------------------- reading
    def mfu(self):
        """Rolling-window useful FLOP/s over peak (0.0 with no peak or no
        ticks in the window). Elapsed time spans from the oldest retained
        tick's BEGIN to now, so a single tick reads its own wall."""
        if not self.peak_flops:
            return 0.0
        now = self._clock()
        with self._lock:
            self._prune_window(now)
            if not self._window:
                return 0.0
            t_end0, wall0, _ = self._window[0]
            elapsed = max(1e-9, now - (t_end0 - wall0))
            useful = sum(u for _, _, u in self._window)
        return useful / (elapsed * self.peak_flops)

    @staticmethod
    def _pct(sorted_vals, q):
        if not sorted_vals:
            return None
        i = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
        return sorted_vals[i]

    def snapshot(self) -> dict:
        """Full JSON state for ``/utilization``: lifetime totals (integer
        flops, conservation checkable by the reader), per-tenant bills,
        host-gap percentiles and the last tick's decomposition."""
        with self._lock:
            gaps = sorted(self._gaps)
            out = {
                "flops": {
                    "issued": self.issued, "useful": self.useful,
                    "pad_waste": self.pad_waste,
                    "spec_waste": self.spec_waste,
                },
                "tenants": dict(self.by_tenant),
                "ticks": self.ticks,
                "launches": self.launches,
                "launch_wall_s": round(self.launch_wall_s, 6),
                "host_gap_s": round(self.host_gap_s, 6),
                "last_tick": self.last_tick,
            }
        if self.issued:
            out["useful_ratio"] = round(self.useful / self.issued, 6)
        for q, name in ((0.50, "host_gap_p50_s"), (0.99, "host_gap_p99_s")):
            v = self._pct(gaps, q)
            if v is not None:
                out[name] = round(v, 6)
        out["peak_flops"] = self.peak_flops
        out["mfu"] = round(self.mfu(), 6) if self.peak_flops else None
        return out

    def metrics_block(self) -> dict:
        """Compact block for the JSON /metrics snapshot (mirrors the 
        tracer/flight blocks): mfu, flops by kind, host-gap tail."""
        snap = self.snapshot()
        return {
            "mfu": snap["mfu"],
            "flops": snap["flops"],
            "host_gap_p50_s": snap.get("host_gap_p50_s"),
            "host_gap_p99_s": snap.get("host_gap_p99_s"),
        }
