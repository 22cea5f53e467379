"""Deterministic fault injection for the serving stack — the port's own
copy of ``paddle_tpu/inference/faults.py`` (pure Python).

Faults are counter-armed, not probabilistic: a fault arms after ``after``
checks of a named site and fires ``times`` times, so every chaos leg is
reproducible.

=====================  =====================================================
site                   where it is checked
=====================  =====================================================
``kv.reserve``         entry of ``PagedKVCache.reserve`` (before any state
                       mutation — an injected ``CacheOutOfBlocks`` models a
                       genuinely dry pool)
``kv.allocate``        entry of ``BlockAllocator.allocate``
``kv.prefix_match``    entry of ``PrefixCache.lookup`` (the scheduler treats
                       any lookup failure as a cache miss)
``batcher.tick``       top of the batcher / tick loop (a ``ThreadDeath``
                       here kills the worker with the queue intact)
``batcher.batch``      start of ``_run_batch`` (the loop re-queues the
                       batch before dying, so no request is lost)
``predictor.run``      immediately before ``predictor.run``
``predictor.generate`` immediately before a step launch, ``generate_paged``
                       or the dense-fallback ``generate``
``lora.load``          entry of ``AdapterRegistry.register``, before any
                       bank write (a corrupt adapter artifact)
``qos.ledger``         entry of ``TenantLedger.charge`` — an injected error
                       degrades the tenant rate limit to admit-all
``fleet.scale_up``     inside ``FleetAutoscaler._scale_up``, before
                       ``ReplicaFleet.add_replica``
=====================  =====================================================

``CheckpointManager(injector=...)`` (``framework/checkpoint.py``) checks
``ckpt.snapshot`` / ``ckpt.serialize`` / ``ckpt.commit`` through the same
``check`` and reads ``monotonic``.

Clock skew: components built with an injector read time through
``injector.monotonic``; ``skew_clock(dt)`` shifts that clock forward, so
deadline and backoff expiry are tested without sleeping.
"""
from __future__ import annotations

import time

from ..analysis.lockwitness import make_lock

__all__ = ["ThreadDeath", "FaultInjector"]


class ThreadDeath(BaseException):
    """Kills a worker thread through the generic ``except Exception`` nets.

    Deliberately a BaseException subclass: the batching loop catches and
    isolates ordinary exceptions per-request, so an injected *thread death*
    must ride a channel those handlers don't see — exactly like a real
    ``SystemExit``/interpreter teardown would.
    """


class _Fault:
    __slots__ = ("error", "delay", "times", "after", "fired")

    def __init__(self, error, delay, times, after):
        self.error = error
        self.delay = float(delay)
        self.times = int(times)
        self.after = int(after)
        self.fired = 0


class FaultInjector:
    """Counter-armed fault injection with a skewable monotonic clock."""

    def __init__(self):
        self._lock = make_lock("faults.FaultInjector._lock")
        self._faults: dict[str, list[_Fault]] = {}
        self._calls: dict[str, int] = {}
        self._skew = 0.0
        self.log: list[tuple[str, str]] = []  # (site, repr(error)|"delay")

    # ----------------------------------------------------------- installing
    def install(self, site, *, error=None, delay=0.0, times=1, after=0):
        """Arm `site`: starting at its (after+1)-th check, fire `times` times.

        Each firing sleeps `delay` seconds (slow-call injection), then raises
        `error` if given (pass an exception INSTANCE, re-raised as-is, so the
        test controls the exact type the production code must handle)."""
        with self._lock:
            self._faults.setdefault(site, []).append(
                _Fault(error, delay, times, after))

    def reset(self):
        with self._lock:
            self._faults.clear()
            self._calls.clear()
            self._skew = 0.0
            self.log.clear()

    # -------------------------------------------------------------- checking
    def check(self, site):
        """Called by production code at an instrumented site."""
        with self._lock:
            n = self._calls[site] = self._calls.get(site, 0) + 1
            hit = None
            for f in self._faults.get(site, ()):
                if f.fired < f.times and n > f.after:
                    f.fired += 1
                    hit = f
                    break
        if hit is None:
            return
        if hit.delay:
            with self._lock:    # log shares the injector lock everywhere
                self.log.append((site, "delay"))
            time.sleep(hit.delay)   # deliberately OUTSIDE the lock
        if hit.error is not None:
            with self._lock:
                self.log.append((site, repr(hit.error)))
            raise hit.error

    def calls(self, site) -> int:
        """How many times `site` has been checked."""
        with self._lock:
            return self._calls.get(site, 0)

    def fired(self, site) -> int:
        """How many faults have actually triggered at `site`."""
        with self._lock:
            return sum(f.fired for f in self._faults.get(site, ()))

    # ----------------------------------------------------------------- clock
    def skew_clock(self, seconds):
        """Shift the injected monotonic clock forward (test-controlled time:
        deadline and breaker-cooldown expiry without real sleeps)."""
        with self._lock:
            self._skew += float(seconds)

    def monotonic(self) -> float:
        with self._lock:
            return time.monotonic() + self._skew
