"""Multi-tenant QoS: tenant ledger, fair-share admission, fleet autoscaling.

The port's own copy of ``paddle_tpu/inference/qos.py`` (pure Python).

It closes the gap the robustness stack left open: every primitive so
far (admission door, breakers, drain/retire, AOT-gated readiness) protects
the *server*, but nothing protects one tenant from another — a single
flash-crowd client can starve everyone behind the shared admission door.

Three pieces, composed by the continuous scheduler and the replica fleet:

``TenantSpec`` / ``TenantLedger``
    Per-tenant accounting keyed off the ``X-Tenant`` header (same strict
    400 taxonomy as ``X-Adapter``): a weight (fair share of slots under
    contention), a priority tier (lower = more urgent; a strictly more
    urgent arrival may PAUSE a running lower-tier sequence), and an
    optional token-budget rate limit (token bucket; a shed carries the
    computed time-to-refill as ``Retry-After``, not a flat floor). The
    ledger is shared: one instance across all replicas of a fleet keeps
    the buckets and inflight counts global.

``FleetAutoscaler``
    A control loop over ``ReplicaFleet``'s existing add/drain/retire API:
    it watches aggregate queue depth, KV live-utilization and per-tenant
    backlog, and warms up (AOT-gated — the fleet router never dispatches
    to a replica whose ``ready()`` is False) or drains replicas. Explicit
    ``tick()`` for tests; ``start()`` runs it on a daemon thread.

Failure posture (chaos-gated): an injected ``qos.ledger`` fault degrades
the rate limiter to ADMIT-ALL — a broken ledger must never wedge
admission — and an injected ``fleet.scale_up`` fault leaves the fleet
serving on the surviving replicas (the scale event is counted ``error``
and retried after the cooldown). ``ThreadDeath`` passes through both, as
everywhere in the serving stack.
"""
from __future__ import annotations

import threading
import time

from ..analysis.lockwitness import make_lock
from .faults import ThreadDeath
from .resilience import ServerBusy

__all__ = ["TenantSpec", "TenantLedger", "FleetAutoscaler"]

DEFAULT_TENANT = "default"


class TenantSpec:
    """One tenant's QoS contract.

    weight      fair-share weight (> 0): under slot contention a tenant is
                entitled to weight / sum(weights of contending tenants) of
                the running slots; the scheduler admits the most
                under-served tenant first (min inflight/weight).
    priority    tier, lower = more urgent (0 is the most urgent). A waiting
                request whose tier is STRICTLY lower than a running
                sequence's may preempt it (pause, not kill).
    rate        token budget in tokens/second (prompt + requested new
                tokens charged at admission), None = unlimited.
    burst       bucket capacity in tokens; defaults to 4x rate so a cold
                tenant can land a few requests back-to-back.
    """

    __slots__ = ("name", "weight", "priority", "rate", "burst")

    def __init__(self, name, weight=1.0, priority=1, rate=None, burst=None):
        self.name = str(name)
        self.weight = float(weight)
        if self.weight <= 0:
            raise ValueError(f"tenant {name!r}: weight must be > 0")
        self.priority = int(priority)
        if self.priority < 0:
            raise ValueError(f"tenant {name!r}: priority must be >= 0")
        self.rate = None if rate is None else float(rate)
        if self.rate is not None and self.rate <= 0:
            raise ValueError(f"tenant {name!r}: rate must be > 0 tokens/s")
        if burst is not None:
            self.burst = float(burst)
        else:
            self.burst = None if self.rate is None else 4.0 * self.rate
        if self.rate is not None and self.burst < 1.0:
            raise ValueError(f"tenant {name!r}: burst must cover >= 1 token")


class _TenantState:
    __slots__ = ("spec", "tokens", "stamp", "inflight", "admitted",
                 "rate_limited", "tokens_done", "vservice", "vstart")

    def __init__(self, spec, now):
        self.spec = spec
        self.tokens = spec.burst if spec.burst is not None else 0.0
        self.stamp = now            # last bucket refill
        self.inflight = 0           # running slots (paused ones release)
        self.admitted = 0           # sequences admitted to a slot
        self.rate_limited = 0       # charge() sheds
        self.tokens_done = 0        # useful generated tokens (retirement)
        self.vservice = 0.0         # cumulative cost/weight (SFQ finish tag)
        self.vstart = 0.0           # start tag of the latest admission


class TenantLedger:
    """Thread-safe per-tenant accounting shared across schedulers.

    The scheduler calls in at every lifecycle edge: ``charge`` at the
    admission door (rate limit — raises ``ServerBusy`` whose
    ``retry_after`` is the bucket's computed time-to-refill), ``acquire``/
    ``release`` as sequences take and leave running slots (fair-share
    inflight), ``note_admitted`` / ``account`` for the per-tenant counters.
    An UNKNOWN tenant name raises ValueError from ``resolve`` — the HTTP
    layer maps it to 400, the X-Adapter taxonomy — while ``None`` rides
    the built-in ``default`` tenant.

    ``faults=`` wires the ``qos.ledger`` chaos site into ``charge``: an
    injected fault there degrades THIS check to admit-all (counted in
    ``degraded``) instead of wedging or failing admission.
    """

    def __init__(self, tenants=(), *, default_weight=1.0, default_priority=1,
                 clock=None, faults=None):
        self._lock = make_lock("qos.TenantLedger._lock")
        self._faults = faults
        self._clock = (clock if clock is not None
                       else faults.monotonic if faults is not None
                       else time.monotonic)
        self._degraded = 0
        self._bound = False
        self._requests_counter = None
        self._tokens_counter = None
        self._rate_limited_counter = None
        self._degraded_counter = None
        self._tenants: dict[str, _TenantState] = {}
        now = self._clock()
        self._tenants[DEFAULT_TENANT] = _TenantState(
            TenantSpec(DEFAULT_TENANT, weight=default_weight,
                       priority=default_priority), now)
        for spec in tenants:
            self.register(spec)

    # ---------------------------------------------------------- registration
    def register(self, spec, **kw):
        """Add (or replace) a tenant; ``register("gold", weight=3)`` builds
        the spec inline. Re-registering keeps the bucket level and inflight
        count — a weight change must not reset a tenant's debt."""
        if not isinstance(spec, TenantSpec):
            spec = TenantSpec(spec, **kw)
        with self._lock:
            st = self._tenants.get(spec.name)
            if st is None:
                self._tenants[spec.name] = _TenantState(spec, self._clock())
            else:
                st.spec = spec
        return spec

    def has(self, name) -> bool:
        with self._lock:
            return name in self._tenants

    def tenant_names(self):
        with self._lock:
            return sorted(self._tenants)

    def resolve(self, name) -> TenantSpec:
        """Name -> spec; None rides the default tenant, unknown raises
        ValueError (400 at the HTTP layer, never a silent default)."""
        if name is None:
            name = DEFAULT_TENANT
        with self._lock:
            st = self._tenants.get(name)
        if st is None:
            raise ValueError(f"unknown tenant {name!r}")
        return st.spec

    def priority_of(self, name) -> int:
        return self.resolve(name).priority

    # ------------------------------------------------------------ rate limit
    def _refill(self, st, now):
        spec = st.spec
        if spec.rate is None:
            return
        st.tokens = min(spec.burst,
                        st.tokens + (now - st.stamp) * spec.rate)
        st.stamp = now

    def charge(self, name, tokens):
        """Admission-door rate limit: deduct `tokens` from the tenant's
        bucket or raise ``ServerBusy`` carrying the computed time-to-refill
        as ``retry_after`` (HTTP 429 + a Retry-After the client can trust,
        not a flat floor). The ``qos.ledger`` chaos site is checked FIRST:
        an injected fault degrades to admit-all — a broken ledger must
        never wedge or fail admission."""
        if self._faults is not None:
            try:
                self._faults.check("qos.ledger")
            except ThreadDeath:
                raise
            except Exception:
                with self._lock:
                    self._degraded += 1
                if self._degraded_counter is not None:
                    self._degraded_counter.inc()
                return
        spec = self.resolve(name)
        if spec.rate is None:
            return
        tokens = float(tokens)
        now = self._clock()
        with self._lock:
            st = self._tenants[spec.name]
            self._refill(st, now)
            if st.tokens >= tokens:
                st.tokens -= tokens
                return
            need = (tokens - st.tokens) / spec.rate
            st.rate_limited += 1
        if self._rate_limited_counter is not None:
            self._rate_limited_counter.labels(spec.name).inc()
        raise ServerBusy(
            f"tenant {spec.name!r} over its token budget "
            f"({spec.rate:g} tok/s); next {tokens:g} tokens refill in "
            f"{need:.2f}s", retry_after=need)

    # ------------------------------------------------------------ fair share
    def acquire(self, name, cost=0.0):
        """A sequence of `name` takes a running slot. `cost` (the expected
        service: prompt + requested new tokens) is billed to the tenant's
        VIRTUAL service clock at admission — start-time fair queuing, not
        an instantaneous slot count, because an inflight/weight ratio has
        no memory: with as many tenants as slots every tenant holds ~one
        slot and weights stop mattering. A resume re-takes the slot with
        cost 0 (the sequence was billed when first installed).

        SFQ clamp: the new start tag never lags the virtual time — the
        minimum START tag (not finish tag) among currently running
        tenants — so a long-idle tenant re-enters at "now" and competes
        fairly instead of monopolizing until its stale clock catches up.
        Clamping to start tags matters: a heavy-weight tenant's own seqs
        retire and re-admit constantly, and a finish-tag floor would hoist
        its clock up to the light tenants' every time it momentarily held
        zero slots, equalizing everyone and erasing the weights."""
        name = self.resolve(name).name
        with self._lock:
            st = self._tenants[name]
            if cost:
                vtime = min((t.vstart for t in self._tenants.values()
                             if t.inflight > 0), default=None)
                start = st.vservice
                if vtime is not None:
                    start = max(start, vtime)
                st.vstart = start
                st.vservice = start + float(cost) / st.spec.weight
            st.inflight += 1

    def release(self, name):
        """The running slot frees (retire/evict/pause)."""
        name = self.resolve(name).name
        with self._lock:
            st = self._tenants[name]
            st.inflight = max(0, st.inflight - 1)

    def inflight(self, name) -> int:
        with self._lock:
            st = self._tenants.get(name)
            return 0 if st is None else st.inflight

    def fair_ratio(self, name) -> float:
        """The tenant's weight-normalized virtual service clock — the
        scheduler admits the MINIMUM first (most under-served), so under
        sustained contention delivered throughput converges to the weight
        shares. Ties (fresh ledger) fall back to arrival order."""
        spec = self.resolve(name)
        with self._lock:
            return self._tenants[spec.name].vservice

    # ------------------------------------------------------------ accounting
    def note_admitted(self, name):
        name = self.resolve(name).name
        with self._lock:
            self._tenants[name].admitted += 1
        if self._requests_counter is not None:
            self._requests_counter.labels(name).inc()

    def account(self, name, tokens):
        """Useful generated tokens, credited at retirement (the fairness
        measure's numerator: work DELIVERED, not work admitted)."""
        name = self.resolve(name).name
        n = int(tokens)
        with self._lock:
            self._tenants[name].tokens_done += n
        if self._tokens_counter is not None and n:
            self._tokens_counter.labels(name).inc(n)

    @property
    def degraded(self) -> int:
        """How many times an injected ledger fault forced admit-all."""
        with self._lock:
            return self._degraded

    def fair_snapshot(self) -> dict:
        """All tenants' fair-share clocks in one lock acquisition — the
        flight recorder's per-tick capture: N fair_ratio()
        calls per tick would pay N lock round-trips on the hot loop."""
        with self._lock:
            return {name: round(st.vservice, 6)
                    for name, st in sorted(self._tenants.items())}

    def snapshot(self) -> dict:
        with self._lock:
            return {
                name: {
                    "weight": st.spec.weight,
                    "priority": st.spec.priority,
                    "rate": st.spec.rate,
                    "inflight": st.inflight,
                    "admitted": st.admitted,
                    "rate_limited": st.rate_limited,
                    "tokens_done": st.tokens_done,
                }
                for name, st in sorted(self._tenants.items())
            }

    # --------------------------------------------------------------- metrics
    def bind_metrics(self, registry):
        """Publish the ledger's tenant series (idempotent: a fleet's
        replicas share one ledger and one registry — the first replica
        binds, the rest are no-ops). Per-tenant BACKLOG is the scheduler's
        to publish (it owns the queue); everything ledger-global is here."""
        with self._lock:
            if self._bound:
                return
            self._bound = True
        # families built OUTSIDE the lock (get-or-create, idempotent;
        # inflight set_function takes the lock at scrape time), attribute
        # publication UNDER it so charge/account readers never see a torn set
        requests = registry.counter(
            "paddle_tenant_requests_total",
            "Sequences admitted to a scheduler slot, by tenant",
            labels=("tenant",))
        tokens = registry.counter(
            "paddle_tenant_tokens_total",
            "Useful generated tokens credited at retirement, by tenant",
            labels=("tenant",))
        rate_limited = registry.counter(
            "paddle_tenant_rate_limited_total",
            "Admissions shed by the tenant token-budget rate limit "
            "(HTTP 429; Retry-After = computed time-to-refill)",
            labels=("tenant",))
        degraded = registry.counter(
            "paddle_qos_ledger_degraded_total",
            "Ledger faults degraded to admit-all (qos.ledger chaos site): "
            "a broken ledger never wedges admission")
        degraded.inc(0)   # materialize: scrapes see 0, not absence
        with self._lock:
            self._requests_counter = requests
            self._tokens_counter = tokens
            self._rate_limited_counter = rate_limited
            self._degraded_counter = degraded
        g = registry.gauge(
            "paddle_tenant_inflight",
            "Running scheduler slots held, by tenant (paused sequences "
            "release their share)", labels=("tenant",))
        for name in self.tenant_names():
            g.labels(name).set_function(
                lambda n=name: float(self.inflight(n)))


class FleetAutoscaler:
    """Elastic control loop over ``ReplicaFleet``'s add/drain/retire API.

    Scale-up fires when ANY pressure signal crosses its threshold —
    aggregate queued+in-flight depth, max KV live-utilization across ready
    replicas, or max per-tenant backlog — and the fleet is below
    ``max_replicas``. The new replica inherits the fleet's replica kwargs
    (``replica_overrides`` overlays; pass ``warmup=True`` there to make
    cold start AOT-gated — ``ReplicaFleet._pick`` never dispatches to a
    replica whose ``ready()`` is False, so a warming replica takes no
    traffic until its step programs are built).

    Scale-down fires when ALL quiet signals hold and the fleet is above
    ``min_replicas``: the least-loaded ready replica is drained, given
    ``drain_timeout`` to finish queued work, and retired.

    Every decision is one explicit ``tick()`` (tests drive it directly);
    ``start(period_s)`` runs ticks on a daemon thread. Scale events land in
    ``paddle_fleet_scale_events_total{direction,outcome}`` on the fleet's
    registry. The ``fleet.scale_up`` chaos site is checked inside the
    scale-up action: an injected fault counts an ``error`` event and
    leaves the fleet serving on the surviving replicas.
    """

    def __init__(self, fleet, *, min_replicas=1, max_replicas=4,
                 scale_up_pending=8, scale_up_kv_util=0.85,
                 scale_up_backlog=16, scale_down_pending=0,
                 scale_down_kv_util=0.25, cooldown_s=5.0, drain_timeout=5.0,
                 replica_overrides=None, ledger=None, clock=None,
                 faults=None):
        self.fleet = fleet
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        self.scale_up_pending = int(scale_up_pending)
        self.scale_up_kv_util = float(scale_up_kv_util)
        self.scale_up_backlog = int(scale_up_backlog)
        self.scale_down_pending = int(scale_down_pending)
        self.scale_down_kv_util = float(scale_down_kv_util)
        self.cooldown_s = float(cooldown_s)
        self.drain_timeout = float(drain_timeout)
        self.replica_overrides = dict(replica_overrides or {})
        self.ledger = ledger
        self._faults = faults
        self._clock = (clock if clock is not None
                       else faults.monotonic if faults is not None
                       else time.monotonic)
        self._last_action = -float("inf")
        self._stop = threading.Event()
        self._thread = None
        self._scale_events = fleet.registry.counter(
            "paddle_fleet_scale_events_total",
            "Autoscaler decisions by direction (up|down) and outcome "
            "(ok|error)", labels=("direction", "outcome"))

    # --------------------------------------------------------------- signals
    def _ready_replicas(self):
        return [rep for rep in self.fleet._snapshot()
                if self.fleet._refresh(rep) == "ready"]

    def signals(self) -> dict:
        """One consistent read of the pressure gauges this loop acts on."""
        ready = self._ready_replicas()
        kv = 0.0
        backlog = 0
        for rep in ready:
            cache = getattr(rep.predictor, "kv_cache", None)
            if cache is not None:
                kv = max(kv, float(cache.live_utilization))
            per_tenant = getattr(rep.predictor, "tenant_backlog", None)
            if per_tenant is not None:
                counts = per_tenant()
                if counts:
                    backlog = max(backlog, max(counts.values()))
        return {"pending": self.fleet.pending(), "kv_util": kv,
                "tenant_backlog": backlog, "ready_replicas": len(ready)}

    # --------------------------------------------------------------- control
    def tick(self):
        """One control decision: 'up' | 'down' | 'up_failed' | None."""
        now = self._clock()
        if now - self._last_action < self.cooldown_s:
            return None
        sig = self.signals()
        n = sig["ready_replicas"]
        pressure = (sig["pending"] >= self.scale_up_pending
                    or sig["kv_util"] >= self.scale_up_kv_util
                    or sig["tenant_backlog"] >= self.scale_up_backlog)
        if pressure and n < self.max_replicas:
            self._last_action = now
            return self._scale_up()
        # ANY live pressure signal (including a starving tenant's backlog
        # when the fleet is already at max) vetoes a drain
        if (not pressure and n > self.min_replicas
                and sig["pending"] <= self.scale_down_pending
                and sig["kv_util"] <= self.scale_down_kv_util):
            self._last_action = now
            return self._scale_down()
        return None

    def _scale_up(self):
        try:
            if self._faults is not None:
                self._faults.check("fleet.scale_up")
            self.fleet.add_replica(**self.replica_overrides)
        except ThreadDeath:
            raise
        except Exception:
            # a failed provision (chaos fleet.scale_up, or a real allocator
            # error) must leave the fleet serving on the survivors; the
            # cooldown spaces the retry
            self._scale_events.labels("up", "error").inc()
            return "up_failed"
        self._scale_events.labels("up", "ok").inc()
        return "up"

    def _scale_down(self):
        ready = self._ready_replicas()
        if len(ready) <= self.min_replicas:
            return None
        victim = min(ready, key=lambda rep: rep.predictor.pending())
        try:
            self.fleet.retire_replica(victim.name,
                                      drain_timeout=self.drain_timeout)
        except ThreadDeath:
            raise
        except Exception:
            self._scale_events.labels("down", "error").inc()
            return None
        self._scale_events.labels("down", "ok").inc()
        return "down"

    # ------------------------------------------------------------- lifecycle
    def start(self, period_s=1.0):
        """Run the control loop on a daemon thread until stop()."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        period = float(period_s)

        def loop():
            while not self._stop.wait(period):
                try:
                    self.tick()
                except ThreadDeath:     # pragma: no cover - chaos only
                    raise
                except Exception:       # pragma: no cover - keep controlling
                    pass

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="fleet-autoscaler")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2)
