"""Build and load the port's CUDA kernels.

Each source under ``paddle_tpu_torch/csrc/`` is compiled by ``nvcc`` into
its own shared library with a plain C interface, at first use, into
``paddle_tpu_torch/_build/`` (listed in ``.gitignore``), and loaded with
``ctypes``. Library names carry a hash of the source and of the shared
headers (``csrc/*.cuh``), so an edited source or header builds anew and a
stale library is never loaded. Nothing here runs when the
module is imported: the CPU tests import every module on machines without
``nvcc``.

``build_all()`` starts one ``nvcc`` per source, all at once, and waits for
them; ``load(name)`` returns the loaded library, building it if needed.

Every kernel wrapper counts its launches on its own ``.launches`` through
``count_launch``, naming the stream it launched on. While a CUDA graph
records a stream (``jit.graphs``, under ``recording_launches``), a kernel
put on that stream is recorded into the graph, not launched: the count
goes to the recording, and each replay of the graph adds it to the
wrappers. The recording follows the stream, not the thread, so the kernels
that autograd's device thread puts on the stream during a captured
``backward()`` are recorded with the forward's.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["SOURCES", "build_all", "load", "nvcc_path", "count_launch",
           "recording_launches"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# kernel name -> (source file, {C function: (argtypes, restype)})
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SOURCES = {
    "paged_attention": (
        "paged_attention.cu",
        {
            "paged_attention_forward": (
                [_P] * 9 + [_I] * 9 + [_F] + [_I] * 2 + [_P], ctypes.c_int),
            "paged_attention_error_string": ([_I], ctypes.c_char_p),
        },
    ),
    "flash_attention": (
        "flash_attention.cu",
        {
            # the tensors, then the FlashMask sri (null: unmasked); B, S,
            # H, D, dtype; scale; causal, n, H'; the stream
            "flash_attention_forward": (
                [_P] * 6 + [_I] * 5 + [_F] + [_I] * 3 + [_P], ctypes.c_int),
            "flash_attention_backward_dq": (
                [_P] * 8 + [_I] * 5 + [_F] + [_I] * 3 + [_P], ctypes.c_int),
            "flash_attention_backward_dkv": (
                [_P] * 9 + [_I] * 5 + [_F] + [_I] * 3 + [_P], ctypes.c_int),
            "flash_attention_error_string": ([_I], ctypes.c_char_p),
        },
    ),
    "decode_attention": (
        "decode_attention.cu",
        {
            # q, caches, lengths; the uniform length; partials, out;
            # B, S, Hq, Hkv, T, D, dtype; scale; form, tiles per split,
            # splits; the stream
            "decode_attention_forward": (
                [_P] * 4 + [_I] + [_P] * 4 + [_I] * 7 + [_F] + [_I] * 3
                + [_P], ctypes.c_int),
            "decode_attention_error_string": ([_I], ctypes.c_char_p),
        },
    ),
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict = {}
build_log: dict = {}     # name -> {"seconds": float, "ptxas": str}
_recordings: dict = {}   # captured stream handle -> {wrapper: n}


def count_launch(wrapper, stream):
    """One launch of ``wrapper``'s kernel on ``stream`` (a cudaStream_t
    handle): ``wrapper.launches`` grows by one, or, while a CUDA graph
    records that stream, the recording's count for ``wrapper`` does (its
    replays launch the kernel)."""
    rec = _recordings.get(stream)
    if rec is None:
        wrapper.launches += 1
    else:
        rec[wrapper] = rec.get(wrapper, 0) + 1


@contextlib.contextmanager
def recording_launches(stream):
    """Within: wrapper launches onto ``stream`` (a cudaStream_t handle),
    from any thread, go to the yielded {wrapper: count} dict instead of
    the wrappers' counts."""
    rec = _recordings[stream] = {}
    try:
        yield rec
    finally:
        del _recordings[stream]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels (put nvcc on PATH)")


def _lib_path(name) -> Path:
    """The library's path, named by a hash of its source and of every
    header under ``csrc/`` (the sources include them)."""
    h = hashlib.sha256((CSRC / SOURCES[name][0]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name):
    """Start nvcc for one source; returns (Popen, out path, start time) or
    None when the library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC / SOURCES[name][0])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name, started):
    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    build_log[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}


def build_all() -> dict:
    """Compile every kernel source in parallel (one nvcc each); returns
    ``build_log``. Already-built libraries are not rebuilt."""
    with _lock:
        started = {n: _start(n) for n in SOURCES}
        for name, st in started.items():
            if st is not None:
                _finish(name, st)
    return build_log


def load(name):
    """The ctypes library of kernel ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        st = _start(name)
        if st is not None:
            _finish(name, st)
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, (argtypes, restype) in SOURCES[name][1].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = restype
        _libs[name] = lib
        return lib
