"""``ElasticManager``: the node registry and scale events over the
launcher's TCP store — the counterpart of
``paddle_tpu/distributed/fleet/elastic/manager.py`` (reference
fleet/elastic/manager.py:125 etcd TTL registry, :177-186 fault-tolerance
levels, :33-34 exit codes 101 / 102). The elastic exit codes are defined
here once; ``framework.checkpoint`` and the launcher import them."""
from __future__ import annotations

import enum
import time

#: worker/controller exit code meaning "elastic event — restart me, this is
#: not a crash" (reference manager.py:33)
ELASTIC_EXIT_CODE = 101
#: auto-parallel re-shard restart (reference manager.py:34)
ELASTIC_AUTO_PARALLEL_EXIT_CODE = 102


class ElasticStatus(enum.Enum):
    COMPLETED = "completed"
    ERROR = "error"
    HOLD = "hold"          # below min nodes: wait for joiners
    RESTART = "restart"    # node set changed: re-rendezvous
    EXIT = "exit"


def parse_np(np_spec) -> tuple[int, int]:
    """'4' -> (4, 4); '2:4' -> (2, 4) (reference PADDLE_ELASTIC_NP format)."""
    s = str(np_spec)
    if ":" in s:
        lo, hi = s.split(":", 1)
        lo, hi = int(lo), int(hi)
    else:
        lo = hi = int(s)
    if not 0 < lo <= hi:
        raise ValueError(f"invalid np spec {np_spec!r}")
    return lo, hi


class ElasticManager:
    """TTL liveness + scale decisions. Every node (its launch controller)
    registers under a slot key and heartbeats a timestamp; a node whose
    timestamp goes stale past `ttl` is considered gone (lease expiry). The
    alive set maps to dense ranks in slot order, so a re-admitted or newly
    joined node gets a deterministic rank."""

    #: NOTE on clocks: liveness compares the writer's wall-clock timestamp
    #: against the reader's — nodes must be NTP-synchronized to well within
    #: `ttl`. A store-server-side lease would remove the assumption; the
    #: TCP store has no server clock API yet.
    def __init__(self, store, node_id: str, np_spec="1", ttl: float = 10.0,
                 max_slots: int | None = None):
        self.store = store
        self.node_id = str(node_id)
        self.min_np, self.max_np = parse_np(np_spec)
        self.ttl = float(ttl)
        self.max_slots = max_slots or self.max_np
        self._registered_slot = None

    # ---------------------------------------------------------------- slots
    def _slot_key(self, slot):
        return f"elastic/slot/{slot}"

    def _hb_key(self, slot):
        return f"elastic/hb/{slot}"

    def register(self) -> int:
        """Claim the first free (or own, on re-admission) slot; returns it.

        Claims are ATOMIC via the store's server-side add(): the first node to
        increment a slot's claim counter owns it (two concurrently joining
        nodes cannot both win). Reclaiming an expired slot races through a
        per-generation reclaim counter: the winner bumps the generation and
        takes the slot; losers move to the next slot."""
        for slot in range(self.max_slots):
            raw = self.store.get(self._slot_key(slot), wait=False)
            owner = raw.decode() if raw is not None else None
            if owner == self.node_id:  # re-admission of this same node
                self._registered_slot = slot
                self.heartbeat()
                return slot
            if owner is None:
                # virgin slot: the atomic claim counter decides; a loser must
                # NOT fall through to reclaim (the winner may not have written
                # its owner key / heartbeat yet — that is not staleness)
                if self.store.add(f"elastic/claim/{slot}", 1) == 1:
                    self.store.set(self._slot_key(slot), self.node_id)
                    self._registered_slot = slot
                    self.heartbeat()
                    return slot
                continue
            if owner == "" or not self._slot_alive(slot):
                # "" = deregister tombstone; otherwise a stale lease. Race the
                # reclaim through a per-generation counter.
                gen_raw = self.store.get(f"elastic/gen/{slot}", wait=False)
                gen = int(gen_raw.decode()) if gen_raw else 0
                if self.store.add(f"elastic/reclaim/{slot}/{gen}", 1) == 1:
                    self.store.set(f"elastic/gen/{slot}", str(gen + 1))
                    self.store.set(self._slot_key(slot), self.node_id)
                    self._registered_slot = slot
                    self.heartbeat()
                    return slot
        raise RuntimeError(
            f"no free elastic slot for {self.node_id} (max {self.max_slots})")

    def heartbeat(self):
        if self._registered_slot is None:
            raise RuntimeError("register() first")
        self.store.set(self._hb_key(self._registered_slot), repr(time.time()))

    def deregister(self):
        if self._registered_slot is not None:
            self.store.delete_key(self._hb_key(self._registered_slot))
            # tombstone ("" owner) marks the slot re-claimable via the
            # generation counter; deleting it would make the slot look virgin
            # while its one-shot claim counter stays spent
            self.store.set(self._slot_key(self._registered_slot), "")
            self._registered_slot = None

    def _slot_alive(self, slot) -> bool:
        raw = self.store.get(self._hb_key(slot), wait=False)
        if raw is None:
            return False
        try:
            return time.time() - float(raw.decode()) <= self.ttl
        except ValueError:
            return False

    # ------------------------------------------------------------- topology
    def alive_slots(self) -> list[int]:
        return [s for s in range(self.max_slots) if self._slot_alive(s)]

    def rank_assignment(self) -> dict[str, int]:
        """Dense node-rank per alive node, in slot order (deterministic across
        observers — the reference's rank re-assign on scale events)."""
        out = {}
        for rank, slot in enumerate(self.alive_slots()):
            raw = self.store.get(self._slot_key(slot), wait=False)
            if raw:
                out[raw.decode()] = rank
        return out

    def decide(self, current_world: int) -> tuple[ElasticStatus, int]:
        """(status, alive_count) given the currently running world size."""
        n = len(self.alive_slots())
        if n < self.min_np:
            return ElasticStatus.HOLD, n
        if n != current_world:
            return ElasticStatus.RESTART, n   # scale in/out event
        return ElasticStatus.COMPLETED, n
