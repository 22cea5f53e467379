"""Global flags: ``paddle.set_flags`` / ``paddle.get_flags`` — the
counterpart of ``paddle_tpu/framework/flags.py``.

The same registry and the same names. Flags that map onto the backend's
configuration apply at once through a setter: ``FLAGS_matmul_precision``
sets torch's float32 matmul precision (and with it whether float32
products may run in TF32), ``FLAGS_cudnn_deterministic`` turns on
``torch.use_deterministic_algorithms``. The rest are typed state that
subsystems read: ``FLAGS_check_nan_inf`` is consulted by the op dispatcher
(``ops.apply_op``). Environment variables named FLAGS_* seed the values.
"""
from __future__ import annotations

import os
from typing import Any, Callable

import torch

__all__ = ["set_flags", "get_flags", "flag"]


class _Flag:
    def __init__(self, name, default, typ, help_str="",
                 on_set: Callable | None = None):
        self.name = name
        self.type = typ
        self.help = help_str
        self.on_set = on_set
        env = os.environ.get(name)
        self.value = self._coerce(env) if env is not None else default

    def _coerce(self, v):
        if self.type is bool:
            if isinstance(v, str):
                return v.lower() in ("1", "true", "yes", "on")
            return bool(v)
        return self.type(v)

    def set(self, v):
        self.value = self._coerce(v)
        if self.on_set is not None:
            self.on_set(self.value)


# JAX's names for matmul precision -> torch's float32 matmul precision
# ("highest": full f32; "high": TF32 allowed; "medium": bf16 allowed)
_PRECISION = {"default": "highest", "highest": "highest", "float32": "highest",
              "high": "high", "tensorfloat32": "high", "bfloat16": "medium"}


def _set_matmul_precision(val: str):
    if val in _PRECISION:
        torch.set_float32_matmul_precision(_PRECISION[val])


def _set_deterministic(val: bool):
    torch.use_deterministic_algorithms(bool(val))


_REGISTRY: dict[str, _Flag] = {}


def _define(name, default, typ, help_str="", on_set=None):
    _REGISTRY[name] = _Flag(name, default, typ, help_str, on_set)


# numerics / debugging
_define("FLAGS_check_nan_inf", False, bool,
        "scan op outputs for NaN/Inf at eager dispatch (debugging)")
_define("FLAGS_check_nan_inf_level", 0, int,
        "0: error on NaN/Inf; 1+: warn only")
_define("FLAGS_cudnn_deterministic", False, bool,
        "deterministic device kernels", _set_deterministic)
_define("FLAGS_matmul_precision", "default", str,
        "default|high|highest — float32 matmul precision",
        _set_matmul_precision)
# memory (informational: the caching allocator owns allocation)
_define("FLAGS_fraction_of_gpu_memory_to_use", 0.92, float,
        "device memory fraction")
_define("FLAGS_allocator_strategy", "auto_growth", str,
        "allocator strategy")
_define("FLAGS_eager_delete_tensor_gb", 0.0, float, "GC threshold")
# execution
_define("FLAGS_use_mkldnn", False, bool, "no-op")
_define("FLAGS_benchmark", False, bool, "sync-and-time every op")
_define("FLAGS_paddle_num_threads", 1, int, "host threads per op")
# distributed
_define("FLAGS_call_stack_level", 1, int, "error verbosity")
_define("FLAGS_log_memory_stats", False, bool,
        "log live/peak memory each step")


def set_flags(flags: dict[str, Any]):
    """Unknown names raise ValueError."""
    if not isinstance(flags, dict):
        raise TypeError("set_flags expects a dict of {flag_name: value}")
    for k, v in flags.items():
        if k not in _REGISTRY:
            raise ValueError(
                f"flag {k!r} is not defined (see paddle.get_flags())")
        _REGISTRY[k].set(v)


def get_flags(flags=None) -> dict[str, Any]:
    """None: every flag."""
    if flags is None:
        return {k: f.value for k, f in _REGISTRY.items()}
    if isinstance(flags, str):
        flags = [flags]
    out = {}
    for k in flags:
        if k not in _REGISTRY:
            raise ValueError(f"flag {k!r} is not defined")
        out[k] = _REGISTRY[k].value
    return out


def flag(name: str):
    """Fast internal accessor (no dict copy)."""
    return _REGISTRY[name].value
