"""Serving SLOs: declarative objectives, rolling windows, burn-rate alerting.

The port's own copy of ``paddle_tpu/observability/slo.py`` (pure Python).

Reference role: the Google SRE-workbook multi-window multi-burn-rate
alerting recipe, applied to the serving stack's phase-attributed latency
series (scheduler TTFT/TPOT, ). An SLO here is "fraction of GOOD
events >= target over a rolling window"; latency objectives translate the
standard way — ``ttft_p95_ms: 200`` means "at most 5% of requests may take
longer than 200ms to first token", i.e. good = (ttft <= 200ms) with
target 0.95 — so every objective reduces to one good/bad event stream.

Definitions (pinned by tests/test_slo_observability.py):

* ``bad_fraction(W)``   — bad events / total events over the last W seconds
  (0.0 with no events: an idle service burns no budget).
* ``burn_rate(W)``      — bad_fraction(W) / (1 - target). Burn rate 1.0
  sustained for the whole budget window consumes exactly the error budget;
  14.4 empties a 30-day budget in ~2 days (the SRE-workbook page numbers).
* ``error_budget_remaining`` — max(0, 1 - burn_rate(slow)): the fraction of
  the slow (budget) window's error budget still unspent.
* ``state`` — "alerting" iff BOTH windows burn >= ``burn_threshold``
  (fast = is it happening NOW, slow = has it been happening long enough to
  matter), "fast_burn" when only the fast window is hot (a blip that has
  not yet consumed meaningful budget), else "ok". Requiring both windows is
  what keeps a 2-second latency spike from paging anyone while a sustained
  regression still alerts within the fast window's span.

``SLOMonitor`` composes policies, routes scheduler observations to them by
kind, exports ``paddle_slo_error_budget_remaining{slo}`` and
``paddle_slo_burn_rate{slo,window=fast|slow}`` gauges, fires registered
``on_alert`` callbacks exactly on the not-alerting -> alerting edge (the
scheduler wires the flight recorder's dump there), and serves the
``/slo`` endpoint's JSON snapshot. Clocks are injectable everywhere —
the burn-rate lifecycle tests drive a fake clock through
budget-exhaust -> fast alert -> slow confirm -> recovery without sleeping.
"""
from __future__ import annotations

import collections
import re
import threading
import time

__all__ = ["SLOPolicy", "SLOMonitor", "make_policies"]

# objective key grammar: ttft_p95_ms / tpot_p99_ms / tpot_p99.9_ms
_LATENCY_KEY = re.compile(r"^(ttft|tpot)_p(\d+(?:\.\d+)?)_ms$")


class SLOPolicy:
    """One objective as a good-event fraction over fast/slow rolling windows.

    kind         "ttft" | "tpot" | "availability" — which scheduler
                 observation stream feeds this policy.
    target       required good fraction (0 < target < 1), e.g. 0.95 for a
                 p95 latency objective or 0.999 for three-nines availability.
    threshold_ms latency kinds only: an observation is GOOD iff
                 value <= threshold_ms.
    fast/slow    rolling window spans in seconds (fast < slow); slow doubles
                 as the error-budget window.
    burn_threshold  both windows' burn rate must reach this for "alerting".
    clock        injectable monotonic clock (seconds).
    max_events   ring bound on retained events (memory cap; oldest evicted).
    """

    __slots__ = ("name", "kind", "target", "threshold_ms", "fast_window_s",
                 "slow_window_s", "burn_threshold", "_clock", "_events",
                 "_lock", "_alerting", "total_events", "bad_events")

    def __init__(self, name, kind, target, threshold_ms=None,
                 fast_window_s=60.0, slow_window_s=300.0,
                 burn_threshold=2.0, clock=time.monotonic, max_events=16384):
        if kind not in ("ttft", "tpot", "availability"):
            raise ValueError(f"unknown SLO kind {kind!r} "
                             "(ttft | tpot | availability)")
        if not 0.0 < float(target) < 1.0:
            raise ValueError(f"SLO {name!r}: target must be in (0, 1) — "
                             "an exact-1.0 objective has no error budget "
                             "to burn")
        if kind in ("ttft", "tpot") and threshold_ms is None:
            raise ValueError(f"SLO {name!r}: latency kind {kind!r} needs "
                             "threshold_ms")
        if not float(fast_window_s) < float(slow_window_s):
            raise ValueError(f"SLO {name!r}: fast window must be shorter "
                             "than the slow (budget) window")
        self.name = str(name)
        self.kind = kind
        self.target = float(target)
        self.threshold_ms = (None if threshold_ms is None
                             else float(threshold_ms))
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.burn_threshold = float(burn_threshold)
        self._clock = clock
        # (t, good) ring; pruned to the slow window on every write/read
        self._events: collections.deque = collections.deque(
            maxlen=int(max_events))
        self._lock = threading.Lock()
        self._alerting = False          # edge detection (SLOMonitor)
        self.total_events = 0           # lifetime, for the snapshot
        self.bad_events = 0

    # -------------------------------------------------------------- recording
    def record(self, good, t=None):
        """One good/bad event (availability kind, or pre-thresholded)."""
        now = self._clock() if t is None else float(t)
        with self._lock:
            self._events.append((now, bool(good)))
            self.total_events += 1
            if not good:
                self.bad_events += 1
            self._prune(now)

    def observe(self, value_s, t=None):
        """One latency observation (seconds); thresholded to good/bad."""
        if self.threshold_ms is None:
            raise ValueError(f"SLO {self.name!r} has no latency threshold")
        self.record(float(value_s) * 1000.0 <= self.threshold_ms, t=t)

    def _prune(self, now):
        # under self._lock; drop events older than the slow (budget) window
        horizon = now - self.slow_window_s
        ev = self._events
        while ev and ev[0][0] < horizon:
            ev.popleft()

    # ------------------------------------------------------------------ math
    def bad_fraction(self, window_s) -> float:
        now = self._clock()
        horizon = now - float(window_s)
        with self._lock:
            self._prune(now)
            total = bad = 0
            for t, good in self._events:
                if t < horizon:
                    continue
                total += 1
                if not good:
                    bad += 1
        return bad / total if total else 0.0

    def _window_s(self, window) -> float:
        if window == "fast":
            return self.fast_window_s
        if window == "slow":
            return self.slow_window_s
        raise ValueError(f"unknown window {window!r} (fast | slow)")

    def burn_rate(self, window) -> float:
        """Error-budget burn rate over one window: bad_fraction / budget."""
        budget = 1.0 - self.target
        return self.bad_fraction(self._window_s(window)) / budget

    def error_budget_remaining(self) -> float:
        """Unspent fraction of the slow window's error budget, floored at 0
        (a gauge that goes negative reads as a scrape bug, not "more than
        everything is spent")."""
        return max(0.0, 1.0 - self.burn_rate("slow"))

    def state(self) -> str:
        """"alerting" (both windows hot) | "fast_burn" (blip) | "ok"."""
        fast_hot = self.burn_rate("fast") >= self.burn_threshold
        slow_hot = self.burn_rate("slow") >= self.burn_threshold
        if fast_hot and slow_hot:
            return "alerting"
        if fast_hot:
            return "fast_burn"
        return "ok"

    def snapshot(self) -> dict:
        return {
            "kind": self.kind,
            "target": self.target,
            "threshold_ms": self.threshold_ms,
            "fast_window_s": self.fast_window_s,
            "slow_window_s": self.slow_window_s,
            "burn_threshold": self.burn_threshold,
            "burn_rate_fast": round(self.burn_rate("fast"), 4),
            "burn_rate_slow": round(self.burn_rate("slow"), 4),
            "error_budget_remaining": round(self.error_budget_remaining(), 4),
            "state": self.state(),
            "total_events": self.total_events,
            "bad_events": self.bad_events,
        }


def make_policies(objectives, *, fast_window_s=60.0, slow_window_s=300.0,
                  burn_threshold=2.0, clock=time.monotonic):
    """Declarative objectives -> [SLOPolicy].

    ``objectives`` maps objective keys to their thresholds/targets::

        make_policies({"ttft_p95_ms": 200.0,   # p95 TTFT <= 200ms
                       "tpot_p99_ms": 50.0,    # p99 TPOT <= 50ms
                       "availability": 0.999}) # non-5xx terminal fraction

    ``<kind>_p<q>_ms: X`` becomes kind=<kind>, target=q/100,
    threshold_ms=X (the standard percentile-to-good-fraction translation);
    ``availability: t`` becomes kind="availability", target=t."""
    policies = []
    for key, value in objectives.items():
        m = _LATENCY_KEY.match(key)
        if m is not None:
            kind, q = m.group(1), float(m.group(2))
            if not 0.0 < q < 100.0:
                raise ValueError(f"objective {key!r}: percentile out of "
                                 "range (0, 100)")
            policies.append(SLOPolicy(
                key, kind, target=q / 100.0, threshold_ms=float(value),
                fast_window_s=fast_window_s, slow_window_s=slow_window_s,
                burn_threshold=burn_threshold, clock=clock))
        elif key == "availability":
            policies.append(SLOPolicy(
                key, "availability", target=float(value),
                fast_window_s=fast_window_s, slow_window_s=slow_window_s,
                burn_threshold=burn_threshold, clock=clock))
        else:
            raise ValueError(
                f"unknown SLO objective {key!r} (ttft_p<q>_ms | "
                "tpot_p<q>_ms | availability)")
    return policies


class SLOMonitor:
    """Policy set + gauge export + alert-edge callbacks + /slo snapshot.

    Built either from declarative ``objectives`` (see ``make_policies``) or
    explicit ``policies``. The scheduler feeds it at retirement
    (``observe_ttft`` / ``observe_tpot``) and at every terminal CAS
    (``observe_terminal``); each feed re-evaluates states and fires
    ``on_alert`` callbacks exactly on a policy's not-alerting -> alerting
    edge (re-armed when the policy recovers). Callbacks run on the feeding
    thread (usually the scheduler tick loop) and are exception-isolated —
    a broken alert hook must never take a tick down."""

    def __init__(self, objectives=None, policies=None,
                 fast_window_s=60.0, slow_window_s=300.0,
                 burn_threshold=2.0, clock=time.monotonic):
        self.policies = list(policies) if policies is not None else []
        if objectives:
            self.policies.extend(make_policies(
                objectives, fast_window_s=fast_window_s,
                slow_window_s=slow_window_s, burn_threshold=burn_threshold,
                clock=clock))
        if not self.policies:
            raise ValueError("SLOMonitor needs at least one objective")
        names = [p.name for p in self.policies]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO policy names: {names}")
        self._clock = clock
        self._callbacks: list = []
        self._bound_registries: set = set()
        self._bind_lock = threading.Lock()
        # newest-first breach context for the /slo snapshot and runbook:
        # (t, policy, kind, tenant) of recent BAD events (atomic deque)
        self.recent_bad: collections.deque = collections.deque(maxlen=32)

    # --------------------------------------------------------------- feeding
    def observe_ttft(self, seconds, tenant=None):
        self._feed("ttft", value_s=seconds, tenant=tenant)

    def observe_tpot(self, seconds, tenant=None):
        self._feed("tpot", value_s=seconds, tenant=tenant)

    def observe_terminal(self, good, tenant=None):
        self._feed("availability", good=bool(good), tenant=tenant)

    def _feed(self, kind, value_s=None, good=None, tenant=None):
        for p in self.policies:
            if p.kind != kind:
                continue
            if kind == "availability":
                is_good = good
                p.record(is_good)
            else:
                is_good = float(value_s) * 1000.0 <= p.threshold_ms
                p.record(is_good)
            if not is_good:
                self.recent_bad.append(
                    (self._clock(), p.name, kind, tenant))
        self._check_alerts()

    def _check_alerts(self):
        for p in self.policies:
            alerting = p.state() == "alerting"
            was = p._alerting
            p._alerting = alerting
            if alerting and not was:
                for cb in list(self._callbacks):
                    try:
                        cb(p)
                    except Exception:   # noqa: BLE001 — isolation contract
                        pass

    def on_alert(self, fn):
        """Register fn(policy) for the not-alerting -> alerting edge."""
        self._callbacks.append(fn)
        return fn

    def alerting(self) -> list:
        """Names of currently-alerting policies (both windows hot)."""
        return [p.name for p in self.policies if p.state() == "alerting"]

    # --------------------------------------------------------------- metrics
    def bind_metrics(self, registry):
        """Export the SLO gauges on `registry` (idempotent per registry —
        fleet replicas sharing one monitor and one registry bind once).
        Gauges exist only when a policy is installed: the exposition-lint
        contract is "paddle_slo_* present IFF an SLOMonitor is wired"."""
        with self._bind_lock:
            if id(registry) in self._bound_registries:
                return
            self._bound_registries.add(id(registry))
        budget = registry.gauge(
            "paddle_slo_error_budget_remaining",
            "Unspent fraction of the slow-window error budget by SLO "
            "(1.0 = untouched, 0.0 = exhausted)", labels=("slo",))
        burn = registry.gauge(
            "paddle_slo_burn_rate",
            "Error-budget burn rate by SLO and window (SRE multi-window "
            "multi-burn-rate: 'alerting' needs both windows over the "
            "policy's burn_threshold)", labels=("slo", "window"))
        for p in self.policies:
            budget.labels(p.name).set_function(
                lambda p=p: p.error_budget_remaining())
            for w in ("fast", "slow"):
                burn.labels(p.name, w).set_function(
                    lambda p=p, w=w: p.burn_rate(w))

    # -------------------------------------------------------------- snapshot
    def snapshot(self) -> dict:
        """JSON shape of the /slo endpoint."""
        return {
            "alerting": self.alerting(),
            "policies": {p.name: p.snapshot() for p in self.policies},
            "recent_bad": [
                {"t": round(t, 6), "slo": name, "kind": kind,
                 "tenant": tenant}
                for t, name, kind, tenant in list(self.recent_bad)
            ],
        }
