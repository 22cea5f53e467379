"""Flight recorder: a bounded ring of per-tick scheduler snapshots.

The port's own copy of ``paddle_tpu/observability/flightrecorder.py``
(pure Python).

The continuous scheduler calls ``record()`` once per tick (after the decode
phase) with a plain-dict snapshot of the slot map (tenant/adapter/phase per
slot), batch widths, KV-cache block accounting, paused/pending depths, and
the QoS ledger's fair-share ratios. The ring is the postmortem the scrape
can't be: when an SLO burn-rate alert fires, when an operator hits
``/debug/ticks``, or when a chaos test fails, ``dump()`` serializes the
newest N ticks so the breach window's actual slot state ships with the
failure instead of dying with the process.

Capture cost is a handful of dict builds per tick under the slot lock —
the card's serving phase records the recorder-on against recorder-off
rate. The recorder itself takes no locks
of the scheduler's; thread safety of its own ring is a single mutex.

Module-level ``live_recorders()`` / ``dump_all()`` expose every live
recorder through a WeakSet so a test fixture can dump rings it
never got a handle to (recorders die with their schedulers; the registry
holds no references).
"""
from __future__ import annotations

import collections
import json
import threading
import time
import weakref

__all__ = ["FlightRecorder", "live_recorders", "dump_all"]

_LIVE: "weakref.WeakSet[FlightRecorder]" = weakref.WeakSet()


def live_recorders():
    """All currently-live recorders (weakly tracked, creation order lost)."""
    return list(_LIVE)


def dump_all(last=None):
    """Dump every live recorder, keyed by name (chaos-fixture entrypoint)."""
    return {rec.name: rec.dump(last=last) for rec in live_recorders()}


class FlightRecorder:
    """Bounded ring of per-tick snapshots with alert/dump plumbing.

    capacity  max retained ticks (oldest evicted; overhead and memory are
              O(capacity), dump size is the operator's to bound via `last`).
    clock     injectable monotonic clock, seconds (chaos skew compatible).
    name      dump-key / metric disambiguator; auto-numbered if omitted.
    """

    _seq = 0
    _seq_lock = threading.Lock()

    def __init__(self, capacity=512, clock=time.monotonic, name=None):
        if int(capacity) <= 0:
            raise ValueError("flight-recorder capacity must be positive")
        if name is None:
            with FlightRecorder._seq_lock:
                FlightRecorder._seq += 1
                name = f"flightrec-{FlightRecorder._seq}"
        self.name = str(name)
        self._capacity = int(capacity)
        self._clock = clock
        self._ring: collections.deque = collections.deque(
            maxlen=self._capacity)
        self._lock = threading.Lock()
        self._recorded = 0          # lifetime ticks, for dropped accounting
        self._alerts: collections.deque = collections.deque(maxlen=32)
        _LIVE.add(self)

    # --------------------------------------------------------------- capture
    def record(self, snapshot: dict):
        """Append one tick snapshot (a plain JSON-serializable dict). The
        recorder stamps ``t`` and a monotonically increasing ``tick``."""
        with self._lock:
            self._recorded += 1
            entry = {"tick": self._recorded, "t": round(self._clock(), 6)}
            entry.update(snapshot)
            self._ring.append(entry)

    def mark_alert(self, slo, **context):
        """Note an SLO alert edge (kept alongside the ring so a dump shows
        *when* the page fired relative to the ticks it contains)."""
        with self._lock:
            self._alerts.append({
                "t": round(self._clock(), 6), "slo": str(slo),
                "at_tick": self._recorded, **context,
            })

    # ------------------------------------------------------------ inspection
    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def occupancy(self) -> int:
        with self._lock:
            return len(self._ring)

    @property
    def dropped(self) -> int:
        """Ticks evicted from the ring (lifetime recorded - retained)."""
        with self._lock:
            return max(0, self._recorded - len(self._ring))

    def dump(self, last=None) -> dict:
        """JSON-ready artifact: newest-last ticks (optionally only the last
        `last`), alert marks, and ring accounting."""
        with self._lock:
            ticks = list(self._ring)
            alerts = list(self._alerts)
            recorded = self._recorded
        dropped = max(0, recorded - len(ticks))
        if last is not None:
            ticks = ticks[-int(last):]
        return {
            "name": self.name,
            "capacity": self._capacity,
            "recorded": recorded,
            "dropped": dropped,
            "occupancy": len(ticks),
            "alerts": alerts,
            "ticks": ticks,
        }

    def dump_json(self, last=None) -> str:
        return json.dumps(self.dump(last=last), sort_keys=True)

    def clear(self):
        with self._lock:
            self._ring.clear()
            self._alerts.clear()
