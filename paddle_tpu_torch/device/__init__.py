"""paddle.device — the counterpart of ``paddle_tpu/device/__init__.py``.
Reference: python/paddle/device/.

On the card every call is ``torch.cuda``'s: ``synchronize``, the memory
statistics (``memory_allocated`` is ``torch.cuda.memory_allocated``,
``max_memory_allocated`` its peak, ``memory_reserved`` the caching
allocator's pool), ``Stream`` / ``Event`` over torch's streams and events,
``current_stream``, ``stream_guard`` and ``set_stream``. On the CPU (the
current place, or no CUDA) each returns what the JAX package's returns for
a host device: ``memory_stats`` empty, streams that are program-ordered
no-ops, events that time with the host clock; the byte counts are 0
(torch keeps no statistics of host memory; JAX sums its live arrays).
``cuda`` is the ``paddle.device.cuda`` namespace over the same functions.
"""
from __future__ import annotations

import contextlib
import time

import torch

from ..framework.device import (  # noqa: F401
    CPUPlace, CUDAPlace, Place, TPUPlace, XPUPlace, device_count, get_device,
    get_place, is_compiled_with_cuda, is_compiled_with_xpu, set_device,
)

__all__ = ["set_device", "get_device", "get_all_device_type",
           "get_all_custom_device_type", "get_available_device",
           "get_available_custom_device", "device_count", "synchronize",
           "cuda", "Stream", "Event", "stream_guard", "current_stream",
           "set_stream", "memory_stats", "memory_allocated",
           "max_memory_allocated", "memory_reserved", "max_memory_reserved",
           "empty_cache",
           "is_compiled_with_cuda", "is_compiled_with_xpu",
           "is_compiled_with_tpu", "is_compiled_with_rocm",
           "is_compiled_with_cinn", "is_compiled_with_ipu",
           "is_compiled_with_custom_device", "is_compiled_with_distribute",
           "get_cudnn_version"]


def _cuda(device=None) -> torch.device | None:
    """The CUDA device ``device`` names (None: the current place's), or
    None when that is the CPU or there is no card."""
    if not torch.cuda.is_available():
        return None
    if device is None:
        dev = get_place().device
    elif isinstance(device, int):
        dev = torch.device("cuda", device)
    elif isinstance(device, Place):
        dev = device.device
    else:
        plat, _, idx = str(device).partition(":")
        if plat == "cpu":
            return None
        dev = torch.device("cuda", int(idx or 0))
    return dev if dev.type == "cuda" else None


def get_all_device_type():
    return ["cpu", "gpu"] if torch.cuda.is_available() else ["cpu"]


def get_all_custom_device_type():
    return []


def get_available_device():
    devs = [f"gpu:{i}" for i in range(torch.cuda.device_count())]
    return devs or ["cpu:0"]


def get_available_custom_device():
    return []


def synchronize(device=None):
    """Wait until the device's queued work has finished."""
    dev = _cuda(device)
    if dev is not None:
        torch.cuda.synchronize(dev)


# ------------------------------------------------------------------ memory
def memory_stats(device=None):
    """The caching allocator's statistics (``torch.cuda.memory_stats``);
    {} on the CPU."""
    dev = _cuda(device)
    return dict(torch.cuda.memory_stats(dev)) if dev is not None else {}


def memory_allocated(device=None):
    """Bytes of tensors alive on the device."""
    dev = _cuda(device)
    return torch.cuda.memory_allocated(dev) if dev is not None else 0


def max_memory_allocated(device=None):
    """Peak of ``memory_allocated`` since the start or the last reset."""
    dev = _cuda(device)
    return torch.cuda.max_memory_allocated(dev) if dev is not None else 0


def memory_reserved(device=None):
    """Bytes the caching allocator holds from the driver."""
    dev = _cuda(device)
    return torch.cuda.memory_reserved(dev) if dev is not None else 0


def max_memory_reserved(device=None):
    dev = _cuda(device)
    return torch.cuda.max_memory_reserved(dev) if dev is not None else 0


def empty_cache():
    """Return the caching allocator's unused blocks to the driver."""
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


# ------------------------------------------------------------ streams, events
class Stream:
    """A CUDA stream (``torch.cuda.Stream``) on the card; on the CPU a
    program-ordered stand-in whose waits do nothing."""

    def __init__(self, device=None, priority=2, stream=None):
        dev = _cuda(device)
        self.device = dev
        if stream is not None:
            self._stream = stream
        elif dev is not None:
            # paddle's priority 1 is high, 2 normal; torch's -1 high, 0 normal
            self._stream = torch.cuda.Stream(dev, priority=-1 if priority == 1
                                             else 0)
        else:
            self._stream = None

    def synchronize(self):
        if self._stream is not None:
            self._stream.synchronize()

    def wait_event(self, event):
        if self._stream is not None and event._event is not None:
            self._stream.wait_event(event._event)

    def wait_stream(self, stream):
        if self._stream is not None and stream._stream is not None:
            self._stream.wait_stream(stream._stream)

    def record_event(self, event=None):
        event = event or Event()
        event.record(self)
        return event

    def query(self):
        return self._stream.query() if self._stream is not None else True


class Event:
    """A CUDA event (``torch.cuda.Event``) on the card; on the CPU an event
    that synchronises and reads the host clock, so ``elapsed_time`` is
    wall time between the records, in ms."""

    def __init__(self, enable_timing=True, blocking=False, interprocess=False,
                 device=None):
        if _cuda(device) is not None:
            self._event = torch.cuda.Event(enable_timing=enable_timing,
                                           blocking=blocking,
                                           interprocess=interprocess)
        else:
            self._event = None
        self._ts = None

    def record(self, stream=None):
        if self._event is not None:
            s = stream._stream if isinstance(stream, Stream) else stream
            self._event.record(s)
        else:
            self._ts = time.perf_counter()

    def query(self):
        return self._event.query() if self._event is not None else True

    def synchronize(self):
        if self._event is not None:
            self._event.synchronize()

    def elapsed_time(self, end_event):
        """Milliseconds between this record() and ``end_event``'s."""
        if self._event is not None:
            return self._event.elapsed_time(end_event._event)
        if self._ts is None or end_event._ts is None:
            raise RuntimeError("both events must be recorded before "
                               "elapsed_time")
        return (end_event._ts - self._ts) * 1e3


def current_stream(device=None):
    """The stream work is queued on (torch's current stream)."""
    dev = _cuda(device)
    if dev is None:
        return Stream(device="cpu")
    return Stream(dev, stream=torch.cuda.current_stream(dev))


def set_stream(stream=None):
    """Make ``stream`` current; returns the previous one."""
    prev = current_stream()
    if stream is not None and stream._stream is not None:
        torch.cuda.set_stream(stream._stream)
    return prev


@contextlib.contextmanager
def stream_guard(stream):
    """Within the block, ``stream`` is current (``torch.cuda.stream``)."""
    if stream is None or stream._stream is None:
        yield
        return
    with torch.cuda.stream(stream._stream):
        yield


class cuda:
    """``paddle.device.cuda``: the same functions for the card."""

    Stream = Stream
    Event = Event
    device_count = staticmethod(device_count)
    synchronize = staticmethod(synchronize)
    current_stream = staticmethod(current_stream)
    stream_guard = staticmethod(stream_guard)
    memory_allocated = staticmethod(memory_allocated)
    max_memory_allocated = staticmethod(max_memory_allocated)
    memory_reserved = staticmethod(memory_reserved)
    max_memory_reserved = staticmethod(max_memory_reserved)
    empty_cache = staticmethod(empty_cache)


# ------------------------------------------------------------ build answers
def is_compiled_with_tpu():
    return False


def is_compiled_with_rocm():
    return torch.version.hip is not None


def is_compiled_with_cinn():
    return False


def is_compiled_with_ipu():
    return False


def is_compiled_with_custom_device(device_name=None):
    return False


def is_compiled_with_distribute():
    import torch.distributed as dist

    return dist.is_available()


def get_cudnn_version():
    """cuDNN's version as paddle reports it (an int), None without it."""
    v = torch.backends.cudnn.version() if torch.cuda.is_available() else None
    return int(v) if v else None
