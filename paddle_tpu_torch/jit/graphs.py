"""Captured step programs: one CUDA graph per cache key, then replays.

The JAX package compiles each step program once per cache key and runs
the compiled program for every later call of that key
(``paddle_tpu/models/generation.py:195-220``). The port's counterpart is
``StepRunner``: a program's body reads only static device buffers and
writes static ones, so a CUDA graph captured from it once serves every
later call with new inputs.

* A runner's inputs share one byte buffer on the device, with a pinned
  host twin on CUDA, so filling all of them is one host-to-device copy;
  its outputs share another, read back in one copy.
* On CUDA a program's first run is its body, run eagerly on a side
  stream: that run gives the call its result (and warms cuBLAS and the
  kernels' libraries). Its graph is captured right after (a capture
  records kernels and runs none) and every later run replays it. A
  failure to capture or to replay raises; nothing falls back to eager.
* On the CPU, which the caller asks for explicitly (the tests do), the
  same body runs on the same buffers every time, without capture.
* Kernel launches that the wrappers count (``ops._build.count_launch``)
  are recorded at capture (those the capture's stream receives, from any
  thread) and added to the wrappers' counts on every replay, so the counts
  stay launches on the device.
* ``first_run_then_capture`` and ``Capture`` are the two halves any
  captured program uses; ``jit.train.TrainStep`` captures a whole training
  step with them.
* A runner's buffers are its state: callers hold ``lock`` across fill,
  run and read-back. The runners of one model share one graph memory
  pool; every body writes its results into preallocated buffers, and the
  replays are ordered by the stream they are issued to, so no replay
  overwrites memory another runner still needs.
"""
from __future__ import annotations

import contextlib
import gc
import math
import time
import warnings

import numpy as np
import torch

from ..analysis.lockwitness import make_lock, make_module_lock
from ..ops._build import recording_launches

__all__ = ["StaticBuffers", "StepRunner", "Capture", "CaptureError",
           "poisoned",
           "first_run_then_capture"]

_ALIGN = 16                 # bytes: every view starts on a 16-byte line
# one capture (and its first run) at once
_CAPTURE_LOCK = make_module_lock("graphs._CAPTURE_LOCK")
_SIDE_STREAMS: dict = {}            # device -> the stream captures run on
_UNDERWAY = False                   # a capture is being recorded
_DEFERRED: list = []                # graphs released during it
_POOL_FAILURES: dict = {}           # pool -> its first failed capture


def _side_stream(device):
    """The stream first runs and captures use on ``device`` (called under
    ``_CAPTURE_LOCK``)."""
    s = _SIDE_STREAMS.get(device)
    if s is None:
        s = _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return s


class CaptureError(RuntimeError):
    """The capture of a body failed (the body ran eagerly first, so it is
    not the body's own error): it synchronised with the host, or read a
    value a graph cannot hold. The original error is its ``__cause__``;
    ``pool`` is the graph pool the capture allocated from, which is
    poisoned from then on (``poisoned``)."""

    def __init__(self, msg, pool=None):
        super().__init__(msg)
        self.pool = pool


def poisoned(pool):
    """Whether a capture into ``pool`` failed. Such a pool stays marked as
    recording (``capture_end`` raises before it ends the recording), so
    every later capture into it fails: its owner (a model's runners, a
    ``TrainStep``, a ``to_static`` function) moves to a fresh
    ``torch.cuda.graph_pool_handle()`` and drops what it captured into the
    old one."""
    return pool is not None and pool in _POOL_FAILURES


class Capture:
    """One captured CUDA graph: ``graph``; ``result``, what the captured
    body returned (tensors in the graph's pool that every replay rewrites);
    ``launches``, {wrapper: kernel launches} of one replay; ``seconds``, the
    capture's host time."""

    def __init__(self, graph, result, launches, seconds):
        self.graph = graph
        self.result = result
        self.launches = launches
        self.seconds = seconds

    def replay(self):
        """Launch the graph on the current stream; the wrappers' counts grow
        by the launches it holds."""
        self.graph.replay()
        for wrapper, n in self.launches.items():
            wrapper.launches += n

    def __del__(self):
        # destroying a graph is a call a capture forbids: one released
        # during a capture (its last reference dropped on any thread) is
        # kept until the capture ends
        if _UNDERWAY:
            _DEFERRED.append(self.graph)


@contextlib.contextmanager
def _recording():
    """Within: a capture is underway. The cyclic collector is off, so that
    it cannot run the finalizers of dead runners (and destroy their graphs)
    on the capturing thread, and ``Capture.__del__`` defers a graph's
    destruction to the end of the capture. A graph destroyed during a
    capture makes the capture fail."""
    global _UNDERWAY
    collecting = gc.isenabled()
    gc.disable()
    _UNDERWAY = True
    try:
        yield
    finally:
        _UNDERWAY = False
        if collecting:
            gc.enable()
        _DEFERRED.clear()


def first_run_then_capture(device, first, body, pool=None,
                           error_mode="thread_local", generators=()):
    """(first's result, ``Capture`` of ``body``): ``first()`` runs eagerly
    on the side stream (ordered after the current stream's work; the run
    that gives a call its result and warms cuBLAS and the kernels'
    libraries), then ``body()`` is captured on the same stream into a new
    graph allocating from ``pool``, under ``capture_error_mode``
    ``error_mode``. Each CUDA generator of ``generators`` is registered
    with the graph (``CUDAGraph.register_generator_state``): the body may
    draw from it, and every replay draws anew from its current state (an
    unregistered generator makes the capture raise). A failed capture
    raises ``CaptureError``."""
    with _CAPTURE_LOCK:
        side = _side_stream(device)
        cur = torch.cuda.current_stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = first()
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        t0 = time.perf_counter()
        try:
            with _recording(), recording_launches(side.cuda_stream) as \
                    launched:
                with torch.cuda.graph(graph, pool=pool, stream=side,
                                      capture_error_mode=error_mode):
                    result = body()
        except BaseException as e:
            if generators:
                _end_generator_capture(generators, side)
            if isinstance(e, Exception):
                raise CaptureError(_failure(pool, e), pool) from e
            raise
        return out, Capture(graph, result, dict(launched),
                            time.perf_counter() - t0)


def _failure(pool, error):
    """The message of a failed capture into ``pool``. A failed capture
    leaves its pool marked as recording (``capture_end`` raises before it
    ends the recording), so every later capture into the pool fails with
    "already recording"; their messages name the pool's first failure."""
    said = str(error).splitlines()[0] if str(error) else repr(error)
    msg = f"CUDA graph capture failed: {error}"
    if pool is not None:
        first = _POOL_FAILURES.setdefault(pool, said)
        if first != said:
            msg += f" (the first failed capture into this pool: {first})"
    return msg


def _end_generator_capture(generators, stream):
    """Take ``generators`` out of capture mode after a failed capture.

    A failed capture raises in ``capture_end`` before it ends the capture of
    the generator states it registered, which stay in capture mode: every
    later draw from them outside a capture would raise. An empty capture
    with them registered begins and ends their capture again."""
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # "The CUDA Graph is empty"
        with torch.cuda.graph(graph, stream=stream):
            pass


class StaticBuffers:
    """Named tensors packed into one byte buffer on ``device`` (with a
    pinned host twin on CUDA), so that filling or reading all of them is one
    copy. ``spec``: {name: (shape, dtype)}; ``dev`` holds the device views
    the bodies read and write."""

    def __init__(self, spec, device):
        self.device = torch.device(device)
        layout, off = {}, 0
        for name, (shape, dtype) in spec.items():
            shape = tuple(int(d) for d in shape)
            n = math.prod(shape) * torch.empty(0, dtype=dtype).element_size()
            layout[name] = (off, n, shape, dtype)
            off += -(-n // _ALIGN) * _ALIGN
        cuda = self.device.type == "cuda"
        self._dev_bytes = torch.zeros(max(off, _ALIGN), dtype=torch.uint8,
                                      device=self.device)
        self._host_bytes = (torch.zeros(max(off, _ALIGN), dtype=torch.uint8,
                                        pin_memory=True)
                            if cuda else self._dev_bytes)
        self._copied = torch.cuda.Event() if cuda else None
        self.dev = self._views(self._dev_bytes, layout)
        self._host = self._views(self._host_bytes, layout)

    @staticmethod
    def _views(buf, layout):
        return {name: buf[off:off + n].view(dtype).view(shape)
                for name, (off, n, shape, dtype) in layout.items()}

    def fill(self, values):
        """Copy {name: value} into the buffers: host values (numpy arrays,
        numbers, CPU tensors) through the host twin and one copy, tensors
        already on the device by a device copy. Names not given keep their
        contents."""
        if self._copied is not None:
            self._copied.synchronize()     # the last copy has left the twin
        on_dev = {}
        for name, v in values.items():
            if isinstance(v, torch.Tensor) and v.device == self.device:
                on_dev[name] = v
            else:
                self._host[name].copy_(v if isinstance(v, torch.Tensor)
                                       else torch.from_numpy(np.array(v)))
        if self._copied is not None:
            self._dev_bytes.copy_(self._host_bytes, non_blocking=True)
            self._copied.record()
        for name, v in on_dev.items():
            self.dev[name].copy_(v)

    def read(self):
        """{name: numpy array} of every buffer: one device-to-host copy,
        which waits for the work queued before it."""
        if self._copied is not None:
            self._host_bytes.copy_(self._dev_bytes)
        return {name: t.numpy().copy() for name, t in self._host.items()}


class StepRunner:
    """One step program at one cache key.

    ``programs``: {name: body(inputs, outputs)} where ``inputs`` and
    ``outputs`` are the ``dev`` views of the two ``StaticBuffers``; a body
    reads only static buffers (and what the caller's closure holds for the
    runner's lifetime: pools, caches, parameters) and writes its results
    into them. ``run(name)`` runs one program as the module docstring says.
    ``pool`` is the graph memory pool the captures allocate from (None on
    the CPU). ``flops`` holds the FLOPs of one run of each program that a
    caller asked to count (``run(name, count_flops=True)``)."""

    def __init__(self, device, inputs, outputs, programs, pool=None):
        self.device = torch.device(device)
        self.inputs = StaticBuffers(inputs, self.device)
        self.outputs = StaticBuffers(outputs, self.device)
        self.programs = dict(programs)
        self.pool = pool
        self.lock = make_lock("graphs.StepRunner.lock")
        self.graphs: dict = {}          # name -> Capture
        self.flops: dict = {}           # name -> FLOPs of one run
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0
        self._bodies_only = False

    def fill(self, **values):
        self.inputs.fill(values)

    def read(self):
        return self.outputs.read()

    def run(self, name, count_flops=False):
        """Run program ``name`` on the current buffers. ``count_flops``:
        if ``flops`` has no count for it yet, this run is the body, under
        ``torch.utils.flop_counter.FlopCounterMode`` (aten products only:
        the hand-written attention kernels are not counted)."""
        count = count_flops and name not in self.flops
        if self.device.type != "cuda" or self._bodies_only:
            self._body(name, count)
            return
        graph = self.graphs.get(name)
        if graph is None:
            self._first_run(name, count)
            return
        if count:
            self._body(name, True)
            return
        graph.replay()
        self.replays += 1

    @contextlib.contextmanager
    def _eager(self):
        """Within: ``run`` runs the bodies without capture or replay. The
        reference a replay is held to on the card; not a user option."""
        prev, self._bodies_only = self._bodies_only, True
        try:
            yield self
        finally:
            self._bodies_only = prev

    def _body(self, name, count_flops=False):
        body = self.programs[name]
        if not count_flops:
            body(self.inputs.dev, self.outputs.dev)
            return
        from torch.utils.flop_counter import FlopCounterMode

        with FlopCounterMode(display=False) as counter:
            body(self.inputs.dev, self.outputs.dev)
        self.flops[name] = float(counter.get_total_flops())

    def _first_run(self, name, count_flops):
        """The body eagerly on the side stream (this run's result), then the
        capture of its graph on the same stream."""
        _, cap = first_run_then_capture(
            self.device, lambda: self._body(name, count_flops),
            lambda: self.programs[name](self.inputs.dev, self.outputs.dev),
            self.pool)
        self.capture_s += cap.seconds
        self.graphs[name] = cap
        self.captures += 1
