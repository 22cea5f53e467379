"""Build and load the port's CUDA kernels.

Each source under ``paddle_tpu_torch/csrc/`` is compiled by ``nvcc`` into
its own shared library with a plain C interface, at first use, into
``paddle_tpu_torch/_build/`` (listed in ``.gitignore``), and loaded with
``ctypes``. Library names carry a hash of the source, so an edited source
builds anew and a stale library is never loaded. Nothing here runs when the
module is imported: the CPU tests import every module on machines without
``nvcc``.

``build_all()`` starts one ``nvcc`` per source, all at once, and waits for
them; ``load(name)`` returns the loaded library, building it if needed.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["SOURCES", "build_all", "load", "nvcc_path"]

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
                [_P] * 9 + [_I] * 9 + [_F] + [_I] * 3 + [_P], ctypes.c_int),
            "paged_attention_error_string": ([_I], ctypes.c_char_p),
        },
    ),
    "flash_attention": (
        "flash_attention.cu",
        {
            "flash_attention_forward": (
                [_P] * 5 + [_I] * 5 + [_F, _I, _P], ctypes.c_int),
            "flash_attention_backward_dq": (
                [_P] * 7 + [_I] * 5 + [_F, _I, _P], ctypes.c_int),
            "flash_attention_backward_dkv": (
                [_P] * 8 + [_I] * 5 + [_F, _I, _P], ctypes.c_int),
            "flash_attention_error_string": ([_I], ctypes.c_char_p),
        },
    ),
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict = {}
build_log: dict = {}     # name -> {"seconds": float, "ptxas": str}


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
    src = CSRC / SOURCES[name][0]
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


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
