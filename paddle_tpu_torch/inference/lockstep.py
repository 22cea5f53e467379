"""Tensor-parallel serving in lockstep: every rank of the model-parallel
group runs each step program, rank 0 decides which.

The JAX package serves a tensor-parallel model from one controller, whose
step programs GSPMD splits over the "tp" axis. In the port each rank is a
process holding its head shard of the model and of the paged pool, so
every rank must launch the same step program with the same inputs, in the
same order, or the collectives inside the forward (the row-parallel
all-reduces, the vocab gather before the sampler) pair with the wrong
partners and hang.

``ContinuousGenerateBatchingPredictor`` runs on every rank. On rank 0 its
scheduler owns admission, the block tables and the tick; its model is a
``LockstepLeader``, which sends each step-program call (the name and the
host arguments: tokens, lengths, tables, sampler knobs and the sampling
seed) to the group before running it. The other ranks' predictors run no
scheduler: a ``follow`` thread receives each call and runs it on the
rank's own model and pool. Every rank then gathers the same logits and
draws from the same uniforms (the seed rides the call), so every rank
picks the same token. ``stop()`` ends the followers; an idle leader sends
a keepalive every ``KEEPALIVE_S`` so a follower's wait never reaches the
group's collective timeout.

The self-drafter's dense ``generate`` calls are step calls too, so a
speculative scheduler drafts in lockstep. LoRA: each rank's
``AdapterRegistry`` holds its cut of the bank; a step call's registry
rides as a marker (each rank passes its own) beside the adapter slots,
and the leader's registry sends its loads and frees through
``mirrored`` before it writes them, so every follower's bank rows change
between the same two step calls as the leader's.
"""
from __future__ import annotations

import threading

from ..analysis.lockwitness import make_lock
from ..distributed.collective import broadcast_object_list
from .kv_cache import PagedKVCache

__all__ = ["LockstepLeader", "follow", "STEP_CALLS", "KEEPALIVE_S"]

# the model calls the continuous scheduler (and its warmup) makes that
# run a forward on the device
STEP_CALLS = ("prefill_chunk", "decode_step", "verify_step", "generate")
KEEPALIVE_S = 1.0
_POOL = "<the rank's own pool>"
_ADAPTERS = "<the rank's own adapter registry>"
_NOOP = "noop"


def _portable(args, kwargs):
    """The call's arguments as the other ranks can take them: the pool and
    the adapter registry replaced by markers (each rank passes its own),
    the host timing hook dropped."""
    from .adapters import AdapterRegistry

    def mark(v):
        if isinstance(v, PagedKVCache):
            return _POOL
        return _ADAPTERS if isinstance(v, AdapterRegistry) else v

    kw = {k: mark(v) for k, v in kwargs.items() if k != "timing_hook"}
    return tuple(mark(a) for a in args), kw


class LockstepLeader:
    """Stands for the model in rank 0's scheduler: a step-program call is
    sent to the group, then run; every other attribute is the model's."""

    def __init__(self, model, group):
        self._model = model
        self._group = group
        self._lock = make_lock("lockstep.LockstepLeader._lock")
        self._sent = threading.Event()
        self._stopped = threading.Event()
        self._keepalive = threading.Thread(target=self._keep_alive,
                                           name="tp-lockstep-keepalive",
                                           daemon=True)
        self._keepalive.start()

    def __getattr__(self, name):
        attr = getattr(self._model, name)
        if name not in STEP_CALLS:
            return attr

        def call(*args, **kwargs):
            msg = (name, *_portable(args, kwargs))
            with self._lock:
                if self._stopped.is_set():
                    raise RuntimeError("the tensor-parallel group stopped")
                self._send(msg)
                return attr(*args, **kwargs)
        return call

    def mirrored(self, name, args, fn):
        """Send ``(name, args)`` to the followers, then run ``fn()`` here,
        with no step call between the two (an adapter registry's load or
        free: the followers apply it in the same place of the call
        stream)."""
        with self._lock:
            if self._stopped.is_set():
                raise RuntimeError("the tensor-parallel group stopped")
            self._send((name, args, {}))
            return fn()

    def _send(self, msg):
        broadcast_object_list([msg], src=self._group.ranks[0],
                              group=self._group)
        self._sent.set()

    def _keep_alive(self):
        while not self._stopped.wait(KEEPALIVE_S):
            if self._sent.is_set():
                self._sent.clear()
                continue
            with self._lock:
                if not self._stopped.is_set():
                    self._send(_NOOP)

    def stop(self):
        """End the followers' loops (once)."""
        with self._lock:
            if self._stopped.is_set():
                return
            self._stopped.set()
            self._send(None)
        self._keepalive.join(timeout=10)


def follow(model, kv_cache, group, adapters=None):
    """A follower rank's loop: run every call rank 0 sends on this rank's
    ``model``, ``kv_cache`` and ``adapters`` (its ``AdapterRegistry``)
    until it sends the stop. Returns the number of step programs run."""
    runs = 0
    mine = {_POOL: kv_cache, _ADAPTERS: adapters}
    while True:
        box = [None]
        broadcast_object_list(box, src=group.ranks[0], group=group)
        msg = box[0]
        if msg is None:
            return runs
        if msg == _NOOP:
            continue
        name, args, kwargs = msg
        if name.startswith("adapters."):
            getattr(adapters, "_mirror_" + name.split(".", 1)[1])(*args)
            continue
        own = (lambda v: mine[v] if isinstance(v, str) and v in mine
               else v)
        getattr(model, name)(*(own(a) for a in args),
                             **{k: own(v) for k, v in kwargs.items()})
        runs += 1
