"""Runtime lock witness: the dynamic half of the thread lint — the
counterpart of ``paddle_tpu/analysis/lockwitness.py``, with its rules.

The static pass (``analysis/threads.py``) proves properties of the SOURCE —
which locks *can* be acquired while which are held, which fields *should* be
guarded. This module witnesses what actually happens at runtime, in the style
of Eraser's lockset discipline (Savage et al., SOSP 1997): every lock the
port's runtime modules create goes through :func:`make_lock` /
:func:`make_rlock`, which normally hand back a plain ``threading`` lock with
no overhead — but while a :class:`LockWitness` is activated (the port's
chaos serving tests and ``chip_smoke.py``'s analysis phase do this), each
acquisition records

* the **acquisition-order edge** ``held -> acquired`` (per thread, with the
  acquiring source line), and
* an **inversion** the moment some thread acquires ``A`` while holding ``B``
  after any thread acquired ``B`` while holding ``A`` — the classic
  two-thread deadlock witnessed live, even when the interleaving happened to
  not deadlock this run;

plus an Eraser-style **lockset per shared field** for code that calls
:meth:`LockWitness.note_field` at its shared accesses: the candidate lockset
is the intersection of the locksets across all accesses, and an empty
intersection after accesses from two distinct threads is a race candidate.

``check_static(static_edges)`` closes the loop with the static pass: the
union of witnessed and statically-inferred edges must still be acyclic, so a
runtime ordering that *combined with* a path the tests never exercised would
deadlock is caught too (``analysis.threads.lock_order_graph()``).

Edges are keyed by lock NAME (``"kv_cache.PagedKVCache._lock"``),
aggregating instances of the same class; nested acquisition of two
same-named locks of different instances is skipped rather than reported
(per-instance handover patterns would otherwise self-report). Re-entrant
acquisition of the same RLock instance records nothing. A lock is wrapped
when it is CREATED under an active witness, and a lock made while the
witness was active keeps reporting to it after ``deactivate()``. A lock a
module makes at import comes from ``make_module_lock``: it reports to the
witness active at each acquisition (a port-only addition).
"""
from __future__ import annotations

import threading

__all__ = ["LockWitness", "make_lock", "make_rlock", "make_module_lock",
           "make_module_rlock", "activate", "deactivate", "active_witness"]

_ACTIVE: "LockWitness | None" = None
_ACTIVE_LOCK = threading.Lock()


def activate(witness: "LockWitness") -> "LockWitness":
    """Make `witness` the process-wide witness: every lock subsequently
    created through make_lock/make_rlock is wrapped. Returns the witness."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = witness
    return witness


def deactivate() -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = None


def active_witness() -> "LockWitness | None":
    return _ACTIVE


def make_lock(name: str):
    """A ``threading.Lock`` for production use, witness-wrapped while a
    LockWitness is active; a plain lock otherwise."""
    base = threading.Lock()
    w = _ACTIVE
    return base if w is None else _WitnessedLock(base, name, w)


def make_rlock(name: str):
    """Re-entrant twin of :func:`make_lock`."""
    base = threading.RLock()
    w = _ACTIVE
    return base if w is None else _WitnessedLock(base, name, w)


def make_module_lock(name: str):
    """A lock a module makes at import, before any witness can exist
    (``graphs._CAPTURE_LOCK``, ``generation._SWAP_LOCK``): it reports each
    acquisition to the witness active AT THAT ACQUISITION, if any. Not in
    JAX, whose module-level locks stay plain for good; the port's capture
    and swap locks are taken inside a runner's lock, the order the witness
    must see. Costs one global read per acquisition when no witness is
    active."""
    return _ModuleLock(threading.Lock(), name)


def make_module_rlock(name: str):
    """Re-entrant twin of :func:`make_module_lock`."""
    return _ModuleLock(threading.RLock(), name)


class _Held:
    """One thread's current lock stack: [(wrapper, count)]."""

    __slots__ = ("stack",)

    def __init__(self):
        self.stack = []     # list of [wrapper, reentry_count]


class LockWitness:
    """Collects acquisition-order edges, inversions, and field locksets."""

    def __init__(self):
        self._mu = threading.Lock()
        self._tls = threading.local()
        # (held_name, acquired_name) -> "file:line" of the first acquisition
        self.edges: dict = {}
        # [{"edge": (a, b), "site": ..., "prior_site": ...}, ...]
        self.inversions: list = []
        self.acquisitions = 0
        # field -> {"lockset": frozenset | None (= not yet seen),
        #           "threads": set, "races": [...]}
        self._fields: dict = {}

    # ------------------------------------------------------------- recording
    def _held(self) -> _Held:
        h = getattr(self._tls, "held", None)
        if h is None:
            h = self._tls.held = _Held()
        return h

    @staticmethod
    def _site():
        import sys

        # walk out of this module's frames to the caller's acquire site
        f = sys._getframe(1)
        while f is not None and f.f_globals.get("__name__") == __name__:
            f = f.f_back
        if f is None:
            return "?"
        return f"{f.f_code.co_filename}:{f.f_lineno}"

    def _on_acquired(self, wrapper):
        held = self._held()
        for entry in held.stack:
            if entry[0] is wrapper:         # re-entrant: no edge, count up
                entry[1] += 1
                return
        site = self._site()
        with self._mu:
            self.acquisitions += 1
            for entry in held.stack:
                a = entry[0].name
                b = wrapper.name
                if a == b:      # same-named pair of different instances:
                    continue    # aggregation would self-report; skip
                if (a, b) not in self.edges:
                    self.edges[(a, b)] = site
                if (b, a) in self.edges:
                    self.inversions.append({
                        "edge": (a, b), "site": site,
                        "prior_site": self.edges[(b, a)]})
        held.stack.append([wrapper, 1])

    def _on_released(self, wrapper):
        held = self._held()
        for i in range(len(held.stack) - 1, -1, -1):
            if held.stack[i][0] is wrapper:
                held.stack[i][1] -= 1
                if held.stack[i][1] == 0:
                    del held.stack[i]
                return

    # ---------------------------------------------------------- field lockset
    def note_field(self, field: str):
        """Eraser lockset refinement for one shared-field access: intersect
        the candidate lockset with the locks the calling thread holds NOW.
        An empty candidate after accesses from >= 2 threads is recorded in
        ``races`` (the access that emptied it carries the site)."""
        held = frozenset(e[0].name for e in self._held().stack)
        tid = threading.get_ident()
        with self._mu:
            st = self._fields.setdefault(
                field, {"lockset": None, "threads": set(), "races": []})
            st["threads"].add(tid)
            st["lockset"] = (held if st["lockset"] is None
                             else st["lockset"] & held)
            if not st["lockset"] and len(st["threads"]) > 1:
                st["races"].append({"field": field, "site": self._site()})

    def field_lockset(self, field: str):
        with self._mu:
            st = self._fields.get(field)
            return None if st is None else st["lockset"]

    def race_candidates(self) -> list:
        with self._mu:
            return [r for st in self._fields.values() for r in st["races"]]

    # ------------------------------------------------------------ validation
    def check_static(self, static_edges) -> list:
        """Cycles in (witnessed ∪ static) acquisition-order edges — orderings
        that would deadlock against a path the tests never interleaved.
        `static_edges` is an iterable of (a, b) pairs (or a dict keyed by
        them, e.g. ``analysis.threads.lock_order_graph()``). Returns a list
        of cycles (each a list of lock names); empty means consistent."""
        adj: dict = {}
        with self._mu:
            pairs = set(self.edges)
        pairs.update(tuple(e) for e in static_edges)
        for a, b in pairs:
            adj.setdefault(a, set()).add(b)
        return _find_cycles(adj)

    def summary(self) -> dict:
        with self._mu:
            return {"acquisitions": self.acquisitions,
                    "edges": len(self.edges),
                    "inversions": list(self.inversions),
                    "race_candidates": [r for st in self._fields.values()
                                        for r in st["races"]]}


def _find_cycles(adj: dict) -> list:
    """Distinct elementary cycles (one representative per SCC loop) via
    iterative DFS; enough to NAME the deadlock, not enumerate every path."""
    WHITE, GREY, BLACK = 0, 1, 2
    color = {n: WHITE for n in adj}
    cycles, stack = [], []

    def dfs(start):
        path = [start]
        iters = [iter(adj.get(start, ()))]
        color[start] = GREY
        while path:
            try:
                nxt = next(iters[-1])
            except StopIteration:
                color[path[-1]] = BLACK
                path.pop()
                iters.pop()
                continue
            c = color.get(nxt, WHITE)
            if c == GREY:
                cycles.append(path[path.index(nxt):] + [nxt])
            elif c == WHITE:
                color[nxt] = GREY
                path.append(nxt)
                iters.append(iter(adj.get(nxt, ())))

    for node in list(adj):
        if color.get(node, WHITE) == WHITE:
            dfs(node)
    # canonicalize (rotate to min element) and dedupe
    seen, out = set(), []
    for cyc in cycles:
        body = cyc[:-1]
        i = body.index(min(body))
        canon = tuple(body[i:] + body[:i])
        if canon not in seen:
            seen.add(canon)
            out.append(list(canon) + [canon[0]])
    return out


class _WitnessedLock:
    """Context-manager/acquire-release proxy feeding a LockWitness. Supports
    both Lock and RLock semantics (re-entrancy tracked by instance)."""

    __slots__ = ("_base", "name", "_w")

    def __init__(self, base, name, witness):
        self._base = base
        self.name = name
        self._w = witness

    def acquire(self, blocking=True, timeout=-1):
        ok = self._base.acquire(blocking, timeout)
        if ok:
            self._w._on_acquired(self)
        return ok

    def release(self):
        self._w._on_released(self)
        self._base.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._base.locked()

    def __repr__(self):
        return f"WitnessedLock({self.name})"


class _ModuleLock:
    """A plain lock that feeds whichever witness is active when it is
    acquired (``make_module_lock``). A release under no witness, or under
    another one than the acquisition's, records nothing."""

    __slots__ = ("_base", "name")

    def __init__(self, base, name):
        self._base = base
        self.name = name

    def acquire(self, blocking=True, timeout=-1):
        ok = self._base.acquire(blocking, timeout)
        w = _ACTIVE
        if ok and w is not None:
            w._on_acquired(self)
        return ok

    def release(self):
        w = _ACTIVE
        if w is not None:
            w._on_released(self)
        self._base.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"ModuleLock({self.name})"
