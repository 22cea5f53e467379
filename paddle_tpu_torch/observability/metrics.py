"""Typed metrics registry with Prometheus text exposition — the port's own
copy of ``paddle_tpu/observability/metrics.py`` (pure Python; the same
families, children and renderer, so the same registry operations render the
same text on both sides).

Contracts:

* a metric NAME owns one type forever — re-registering with a different
  type, help string or label set raises (get-or-create otherwise, so the
  serving layer can bind families idempotently across restarts);
* counters are monotonic (negative ``inc`` raises);
* gauges may read through a callback (``set_function``) so pool state is
  sampled at scrape time instead of maintained by hand;
* histograms render cumulative ``_bucket{le=...}`` series plus ``_sum`` /
  ``_count`` (le values formatted so a Prometheus parser round-trips them);
* ``render_prometheus(*registries)`` merges families across registries,
  emitting each ``# HELP``/``# TYPE`` block exactly once and raising on
  duplicate series — the /metrics endpoint serves several components
  (generator, KV pool, HTTP layer) as ONE valid exposition.
"""
from __future__ import annotations

import math
import re
import threading

__all__ = ["MetricsRegistry", "render_prometheus", "DEFAULT_LATENCY_BUCKETS"]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# latency-in-seconds buckets spanning admission-check (~us) to decode (~s)
DEFAULT_LATENCY_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                           0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(v: float) -> str:
    """Float -> exposition value: integers render bare (counter idiom).
    NaN is a legal exposition value (a NaN loss gauge must render, not
    crash the scrape)."""
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    if math.isnan(f):
        return "NaN"
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class _Child:
    """One labeled series of a family."""

    __slots__ = ("_family", "_lock", "_value", "_fn", "_buckets", "_counts",
                 "_sum")

    def __init__(self, family):
        self._family = family
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn = None
        if family.type == "histogram":
            self._buckets = family.buckets
            self._counts = [0] * (len(family.buckets) + 1)  # +Inf last
            self._sum = 0.0

    # ---------------------------------------------------------------- counter
    def inc(self, n=1):
        if self._family.type not in ("counter", "gauge"):
            raise TypeError(f"inc() on a {self._family.type}")
        if self._family.type == "counter" and n < 0:
            raise ValueError("counters are monotonic; inc() must be >= 0")
        with self._lock:
            self._value += n

    # ------------------------------------------------------------------ gauge
    def dec(self, n=1):
        if self._family.type != "gauge":
            raise TypeError(f"dec() on a {self._family.type}")
        with self._lock:
            self._value -= n

    def set(self, v):
        if self._family.type != "gauge":
            raise TypeError(f"set() on a {self._family.type}")
        with self._lock:
            self._value = float(v)

    def set_function(self, fn):
        """Read this series through `fn()` at scrape time (pool state)."""
        if self._family.type not in ("gauge", "counter"):
            raise TypeError(f"set_function() on a {self._family.type}")
        with self._lock:
            self._fn = fn

    # -------------------------------------------------------------- histogram
    def observe(self, v):
        if self._family.type != "histogram":
            raise TypeError(f"observe() on a {self._family.type}")
        v = float(v)
        with self._lock:
            self._sum += v
            for i, b in enumerate(self._buckets):
                if v <= b:
                    self._counts[i] += 1
                    break
            else:
                self._counts[-1] += 1

    # ------------------------------------------------------------------ value
    @property
    def value(self):
        with self._lock:
            return float(self._fn()) if self._fn is not None else self._value

    def histogram_state(self):
        with self._lock:
            return list(self._counts), self._sum


class _Family:
    def __init__(self, name, help, type, labelnames, buckets=None):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln) or ln.startswith("__"):
                raise ValueError(f"invalid label name {ln!r}")
        if type == "histogram":
            if "le" in labelnames:
                raise ValueError("'le' is reserved on histograms")
            buckets = tuple(sorted(float(b) for b in (buckets or
                                                      DEFAULT_LATENCY_BUCKETS)))
            if not buckets:
                raise ValueError("histogram needs at least one bucket")
        self.name = name
        self.help = help
        self.type = type
        self.labelnames = tuple(labelnames)
        self.buckets = buckets
        self._lock = threading.Lock()
        self._children: dict[tuple, _Child] = {}

    def labels(self, *values, **kv) -> _Child:
        if kv:
            if values:
                raise ValueError("pass label values positionally OR by name")
            try:
                values = tuple(kv[ln] for ln in self.labelnames)
            except KeyError as e:
                raise ValueError(f"missing label {e} for {self.name}") from e
            if len(kv) != len(self.labelnames):
                raise ValueError(f"unexpected labels for {self.name}: "
                                 f"{sorted(set(kv) - set(self.labelnames))}")
        values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} takes {len(self.labelnames)} label values, "
                f"got {len(values)}")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._children[values] = _Child(self)
            return child

    # the no-labels family IS its only child
    def inc(self, n=1):
        self.labels().inc(n)

    def dec(self, n=1):
        self.labels().dec(n)

    def set(self, v):
        self.labels().set(v)

    def set_function(self, fn):
        self.labels().set_function(fn)

    def observe(self, v):
        self.labels().observe(v)

    @property
    def value(self):
        return self.labels().value

    def children(self):
        with self._lock:
            return list(self._children.items())


class MetricsRegistry:
    """Name -> family map with get-or-create typed registration."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    def _get_or_create(self, name, help, type, labels, buckets=None):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if (fam.type != type or fam.labelnames != tuple(labels)
                        or (help and fam.help and fam.help != help)):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.type}{fam.labelnames} — cannot re-register as "
                        f"{type}{tuple(labels)}")
                return fam
            fam = _Family(name, help, type, labels, buckets)
            self._families[name] = fam
            return fam

    def counter(self, name, help="", labels=()) -> _Family:
        return self._get_or_create(name, help, "counter", labels)

    def gauge(self, name, help="", labels=()) -> _Family:
        return self._get_or_create(name, help, "gauge", labels)

    def histogram(self, name, help="", labels=(), buckets=None) -> _Family:
        return self._get_or_create(name, help, "histogram", labels, buckets)

    def families(self):
        with self._lock:
            return list(self._families.values())

    def render(self) -> str:
        return render_prometheus(self)


def _series_line(name, labelnames, labelvalues, value, extra=None):
    pairs = [f'{ln}="{_escape_label(lv)}"'
             for ln, lv in zip(labelnames, labelvalues)]
    if extra:
        pairs.append(f'{extra[0]}="{_escape_label(extra[1])}"')
    lbl = "{" + ",".join(pairs) + "}" if pairs else ""
    return f"{name}{lbl} {_fmt(value)}"


def render_prometheus(*registries) -> str:
    """One valid text exposition (format 0.0.4) over several registries.

    Families sharing a name across registries must agree on type/labels (the
    batcher and generator deliberately share families, disambiguated by a
    ``component`` label); a genuinely duplicated series raises instead of
    silently rendering an invalid exposition."""
    merged: dict[str, list] = {}
    order: list[str] = []
    seen_regs = []
    for reg in registries:
        if reg is None or any(reg is r for r in seen_regs):
            continue  # same registry wired to several components: render once
        seen_regs.append(reg)
        for fam in reg.families():
            if fam.name in merged:
                ref = merged[fam.name][0]
                if (ref.type != fam.type
                        or ref.labelnames != fam.labelnames):
                    raise ValueError(
                        f"conflicting definitions of metric {fam.name!r}")
                merged[fam.name].append(fam)
            else:
                merged[fam.name] = [fam]
                order.append(fam.name)

    lines = []
    for name in order:
        fams = merged[name]
        ref = fams[0]
        help_text = next((f.help for f in fams if f.help), "")
        lines.append(f"# HELP {name} {help_text}".rstrip())
        lines.append(f"# TYPE {name} {ref.type}")
        seen_series = set()

        def emit(full_name, labelvalues, value, extra=None):
            key = (full_name, labelvalues, extra[1] if extra else None)
            if key in seen_series:
                raise ValueError(f"duplicate series {full_name}{labelvalues}")
            seen_series.add(key)
            lines.append(_series_line(full_name, ref.labelnames, labelvalues,
                                      value, extra))

        for fam in fams:
            for labelvalues, child in fam.children():
                if ref.type == "histogram":
                    counts, total = child.histogram_state()
                    cum = 0
                    for b, c in zip(ref.buckets, counts):
                        cum += c
                        emit(f"{name}_bucket", labelvalues, cum,
                             extra=("le", _fmt(b)))
                    cum += counts[-1]
                    emit(f"{name}_bucket", labelvalues, cum,
                         extra=("le", "+Inf"))
                    emit(f"{name}_sum", labelvalues, total)
                    emit(f"{name}_count", labelvalues, cum)
                else:
                    emit(name, labelvalues, child.value)
    return "\n".join(lines) + ("\n" if lines else "")
