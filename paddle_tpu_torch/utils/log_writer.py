"""Scalar/metric logging (VisualDL LogWriter role) — the port's copy of
``paddle_tpu/utils/log_writer.py``, record for record: one JSON object a
line (``type``, ``tag``, ``value`` / ``counts`` ..., ``step``,
``wall_time``), so either package reads the other's logs.

Reference: the training stack logs through visualdl.LogWriter
(add_scalar/add_histogram) — an external package. This build ships a
dependency-free writer with the same surface: JSONL records under a run
directory, append-only and crash-safe, plus a reader for analysis/plotting.
"""
from __future__ import annotations

import json
import os
import time


class LogWriter:
    def __init__(self, logdir="./log", file_name="", flush_secs=5, **kwargs):
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        name = file_name or f"vdlrecords.{int(time.time())}.log"
        self.path = os.path.join(logdir, name)
        # block-buffered so flush_secs actually batches writes; flush() and
        # close() make records durable
        self._f = open(self.path, "a")
        self._flush_secs = flush_secs
        self._last_flush = time.monotonic()

    # ------------------------------------------------------------------ records
    def _write(self, record, walltime=None):
        record["wall_time"] = time.time() if walltime is None else walltime
        self._f.write(json.dumps(record) + "\n")
        if time.monotonic() - self._last_flush > self._flush_secs:
            self.flush()

    def add_scalar(self, tag, value, step=None, walltime=None):
        self._write({"type": "scalar", "tag": tag, "value": float(value),
                     "step": step}, walltime=walltime)

    def add_scalars(self, main_tag, tag_value_dict, step=None):
        for k, v in tag_value_dict.items():
            self.add_scalar(f"{main_tag}/{k}", v, step)

    def add_histogram(self, tag, values, step=None, buckets=10):
        import numpy as np

        arr = np.asarray(values, dtype="float64").reshape(-1)
        counts, edges = np.histogram(arr, bins=buckets)
        self._write({"type": "histogram", "tag": tag, "step": step,
                     "counts": counts.tolist(), "edges": edges.tolist(),
                     "min": float(arr.min()), "max": float(arr.max()),
                     "mean": float(arr.mean())})

    def add_text(self, tag, text, step=None):
        self._write({"type": "text", "tag": tag, "text": str(text), "step": step})

    def add_hparams(self, hparams_dict, metrics_list=(), **kwargs):
        self._write({"type": "hparams", "hparams": dict(hparams_dict),
                     "metrics": list(metrics_list)})

    # ------------------------------------------------------------------ lifecycle
    def flush(self):
        self._f.flush()
        self._last_flush = time.monotonic()

    def close(self):
        if self._f:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def read_log(path):
    """Load a LogWriter file back as a list of record dicts."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def scalars(path, tag=None):
    """(step, value) series for `tag` (or {tag: series} for all scalars)."""
    recs = [r for r in read_log(path) if r["type"] == "scalar"]
    if tag is not None:
        return [(r["step"], r["value"]) for r in recs if r["tag"] == tag]
    series: dict = {}
    for r in recs:
        series.setdefault(r["tag"], []).append((r["step"], r["value"]))
    return series
