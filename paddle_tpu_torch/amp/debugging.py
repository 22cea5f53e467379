"""AMP debugging tools — the counterpart of ``paddle_tpu/amp/debugging.py``.
Reference: python/paddle/amp/debugging.py (operator stats collection, tensor
checker, accuracy compare).

Operator statistics are recorded where the port dispatches an op by name:
``ops.apply_op`` and ``ops.apply_like`` (the op layer and the nn
functionals), bucketed by the dtype of the first output leaf as JAX's
``_dtype_bucket`` does, and the torch-level models' AMP seams
(``amp._amp_cast`` / ``_amp_add`` at JAX's op names), bucketed by the
dtype the seam casts to (its first floating input's when it casts
nothing). With collection off a record costs one global load and a None
check; it never reads a value. While a CUDA graph is captured it records
nothing: a captured step's ops are recorded once, by its first run (as
JAX's trace records them once), and replays run no Python. The tensor
checker rides ``FLAGS_check_nan_inf`` (level 0 raises, level 1 warns),
which the op layer's scan reads."""
from __future__ import annotations

import contextlib
import enum
import json
from collections import defaultdict

__all__ = [
    "DebugMode", "TensorCheckerConfig", "enable_operator_stats_collection",
    "disable_operator_stats_collection", "collect_operator_stats",
    "enable_tensor_checker", "disable_tensor_checker", "compare_accuracy",
]


class DebugMode(enum.Enum):
    """Reference debugging.py DebugMode (check levels)."""

    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL_FOR_OVERFLOW = 2
    CHECK_ALL = 3


class TensorCheckerConfig:
    """Reference debugging.py TensorCheckerConfig (subset: enable flag +
    debug_mode; op skip-list)."""

    def __init__(self, enable=True,
                 debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT,
                 skipped_op_list=None, **kwargs):
        self.enable = enable
        self.debug_mode = debug_mode
        self.skipped_op_list = list(skipped_op_list or [])


# ------------------------------------------------------------- op stats
_stats: dict | None = None


_BUCKETS = {"torch.float16": "float16", "torch.bfloat16": "bfloat16",
            "torch.float32": "float32"}


def _leaves(out):
    if isinstance(out, (tuple, list)):
        for o in out:
            yield from _leaves(o)
    elif isinstance(out, dict):
        for o in out.values():
            yield from _leaves(o)
    elif out is not None:
        yield out


def _dtype_bucket(out):
    """float16 / bfloat16 / float32 / other, by the dtype of the first leaf
    of ``out`` that has one (JAX ``_dtype_bucket``)."""
    for leaf in _leaves(out):
        d = getattr(leaf, "dtype", None)
        if d is not None:
            return _BUCKETS.get(str(d), "other")
    return "other"


def _capturing():
    import torch

    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def _record_op(name, out):
    if _stats is not None and not _capturing():
        _stats[name][_dtype_bucket(out)] += 1


def _record_seam(name, target, tensors):
    """A model seam's record: op ``name`` in ``target`` (the seam's cast
    dtype), or, when it casts nothing, its first floating input's."""
    if _stats is None or _capturing():
        return
    if target is None:
        target = next((t.dtype for t in tensors
                       if getattr(t, "is_floating_point", None) is not None
                       and t.is_floating_point()), None)
    _stats[name][_BUCKETS.get(str(target), "other")] += 1


def enable_operator_stats_collection():
    """Start counting op calls per compute dtype (reference
    debugging.py enable_operator_stats_collection)."""
    global _stats
    _stats = defaultdict(lambda: defaultdict(int))


def disable_operator_stats_collection():
    """Stop collecting and print the per-op dtype table; returns the raw
    stats dict {op: {dtype: calls}} (the reference prints only)."""
    global _stats
    stats = _stats
    _stats = None
    if stats is None:
        return {}
    out = {op: dict(buckets) for op, buckets in sorted(stats.items())}
    cols = ("float16", "bfloat16", "float32", "other")
    print("<------------------------------ op list "
          "------------------------------->")
    print(f"{'op':<32} " + " ".join(f"{c:>9}" for c in cols))
    for op, buckets in out.items():
        print(f"{op:<32} "
              + " ".join(f"{buckets.get(c, 0):>9}" for c in cols))
    print("<----------------------------------- end "
          "------------------------------>")
    return out


@contextlib.contextmanager
def collect_operator_stats():
    """Context form (reference debugging.py collect_operator_stats)."""
    enable_operator_stats_collection()
    try:
        yield
    finally:
        disable_operator_stats_collection()


def operator_stats_snapshot():
    """Live view of the currently collected stats (for dumps/tests)."""
    if _stats is None:
        return {}
    return {op: dict(buckets) for op, buckets in _stats.items()}


# --------------------------------------------------------- tensor checker
def enable_tensor_checker(checker_config: TensorCheckerConfig):
    """Turn on per-op nan/inf scanning (reference enable_tensor_checker;
    rides FLAGS_check_nan_inf — level 0 aborts, level >=1 reports)."""
    from ..framework.flags import set_flags

    if not checker_config.enable:
        return
    level = 0 if checker_config.debug_mode is DebugMode.CHECK_NAN_INF_AND_ABORT else 1
    set_flags({"FLAGS_check_nan_inf": True,
               "FLAGS_check_nan_inf_level": level})


def disable_tensor_checker():
    from ..framework.flags import set_flags

    # reset the level too: a leftover level>=1 would silently downgrade a
    # later FLAGS_check_nan_inf=True from abort to warn-only
    set_flags({"FLAGS_check_nan_inf": False, "FLAGS_check_nan_inf_level": 0})


# -------------------------------------------------------- accuracy compare
def compare_accuracy(dump_path, another_dump_path, output_filename,
                     loss_scale=1, dump_all_tensors=False):
    """Compare two operator-stats dumps (JSON files of {op: {dtype: calls}})
    and write an XLSX-role CSV/JSON report of ops whose dtype mix differs —
    the reference's workflow diffs fp16 vs fp32 run logs the same way
    (debugging.py compare_accuracy)."""
    with open(dump_path) as f:
        a = json.load(f)
    with open(another_dump_path) as f:
        b = json.load(f)
    rows = []
    for op in sorted(set(a) | set(b)):
        da, db = a.get(op, {}), b.get(op, {})
        if da != db:
            rows.append({"op": op, "run1": da, "run2": db})
    with open(output_filename, "w") as f:
        json.dump({"mismatched_ops": rows,
                   "num_ops_run1": len(a), "num_ops_run2": len(b)}, f,
                  indent=2)
    return rows
