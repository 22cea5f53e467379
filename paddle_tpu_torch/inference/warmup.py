"""Warmup ahead of traffic and the post-ready capture sentinel — the
counterpart of ``paddle_tpu/inference/warmup.py``.

* ``program_keys(predictor)`` derives the closed set of step-program keys
  a continuous scheduler's configuration can request: ``prefill_chunk
  [S, C]``, ``decode_step [S, decode_steps]`` and, with ``spec_k > 0``,
  ``verify_step [S, K + 1]``, each over the scheduler's table width, pool,
  eos, decode kernel and decode state — the port's counterpart of
  ``ServingConfig.program_keys`` (``paddle_tpu/analysis/compilesurface.py:
  303-353``), derived from ``GenerationMixin._step_runner``'s key layout.
* ``Warmup`` runs each of those programs once with every slot idle
  (``chunk_lens == 0``, ``active == False``), so each key's runner is
  built — on CUDA its first run is its body and its graph is captured —
  before the scheduler admits a request. An idle run writes only the
  pool's scratch page: the live pages keep their bytes.
* The sentinel: once a warmup covered every key, any later capture is a
  violation. The scheduler counts it in
  ``paddle_serving_recompiles_total{component, program}`` and reports it
  to the active ``CompileSentinel`` (``activate`` / ``deactivate``).

A CUDA graph holds device addresses and cannot be written to disk, so the
JAX package's persistent compile cache (``compile_cache_dir``) has no
counterpart here.
"""
from __future__ import annotations

import collections
import threading
import time

import numpy as np

__all__ = ["Warmup", "CompileSentinel", "program_keys", "active_paths",
           "activate", "deactivate", "notify"]


class CompileSentinel:
    """Records post-ready captures as (component, program) pairs."""

    def __init__(self):
        self.violations = collections.deque(maxlen=256)

    def record(self, component, program):
        self.violations.append((component, program))


_ACTIVE = None
_ACTIVE_LOCK = threading.Lock()


def activate(sentinel: CompileSentinel) -> CompileSentinel:
    """Install ``sentinel`` as the process-wide witness."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = sentinel
    return sentinel


def deactivate():
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = None


def notify(component, program):
    """Called by the scheduler's timing hook on a post-ready capture."""
    s = _ACTIVE
    if s is not None:
        s.record(component, program)


def active_paths(pred):
    """The step programs a continuous scheduler's configuration runs."""
    paths = ["prefill_chunk", "decode_step"]
    if pred.spec_k > 0:
        paths.append("verify_step")
    return tuple(paths)


def _shape(pred, path):
    S = pred.max_slots
    return {"prefill_chunk": (S, pred.prefill_chunk),
            "decode_step": (S, pred.decode_steps),
            "verify_step": (S, pred.spec_k + 1)}[path]


def program_keys(pred):
    """Every runner key the scheduler ``pred`` can request (the layout of
    ``GenerationMixin._step_runner``: kind, shape, table width, pool
    signature, eos, ids dtype, decode kernel, pool, decode state)."""
    kv = pred.kv_cache
    _, state_key = pred.model._state_for_key(kv.dtype)
    eos = -1 if pred.eos_token_id is None else int(pred.eos_token_id)
    keys = []
    for path in active_paths(pred):
        keys.append((path, *_shape(pred, path), pred.table_width,
                     kv.signature(), -1 if path == "verify_step" else eos,
                     "int64", pred.decode_kernel, ("pool", kv.uid),
                     state_key))
    return keys


class Warmup:
    """Build every program of a continuous scheduler before it is ready.

    ``run()`` launches each active program once with idle inputs, then
    checks that every derived key is in the model's runner cache. Its stats
    are what the scheduler's ``warm_stats()`` returns:

        programs          keys this configuration derives
        captured          runners this run built (on CUDA: graphs captured)
        missing           derived keys not in the runner cache afterwards
        seconds           wall time of the warmup
        program_seconds   {program: wall time of its launch}
    """

    def __init__(self, predictor):
        self._pred = predictor

    def _launch(self, path):
        pred = self._pred
        model, kv, kern = pred.model, pred.kv_cache, pred.decode_kernel
        S, W = pred.max_slots, pred.table_width
        tables = np.zeros((S, W), np.int32)
        zeros = np.zeros(S, np.int64)
        idle = np.zeros(S, bool)
        if path == "prefill_chunk":
            model.prefill_chunk(np.zeros((S, pred.prefill_chunk), np.int64),
                                zeros, zeros, kv, tables,
                                eos_token_id=pred.eos_token_id,
                                decode_kernel=kern)
        elif path == "decode_step":
            model.decode_step(zeros, zeros, idle, kv, tables,
                              steps=pred.decode_steps, max_lens=zeros,
                              eos_token_id=pred.eos_token_id,
                              decode_kernel=kern)
        else:
            model.verify_step(np.zeros((S, pred.spec_k + 1), np.int64),
                              zeros, zeros, idle, kv, tables,
                              max_lens=zeros, decode_kernel=kern)

    def run(self) -> dict:
        pred = self._pred
        t0 = time.perf_counter()
        keys = program_keys(pred)
        before = set(pred.model._runner_cache())
        per = {}
        for path in active_paths(pred):
            if pred._stop.is_set():     # closing mid-warmup: stop cleanly
                break
            t = time.perf_counter()
            self._launch(path)
            per[path] = time.perf_counter() - t
        after = set(pred.model._runner_cache())
        return {"programs": len(keys), "captured": len(after - before),
                "missing": [k for k in keys if k not in after],
                "seconds": time.perf_counter() - t0,
                "program_seconds": per}
