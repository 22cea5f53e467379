"""The port's metrics registry (``paddle_tpu_torch/observability/
metrics.py``) and its serving counters held against the JAX package's.

The same registry operations go through both modules and must render the
same Prometheus text, byte for byte; the registry's contracts (one type
per name, monotonic counters, no duplicate series across registries,
valid names) must fail the same way on both sides; and
``ServingMetrics`` must give the same exposition and legacy JSON for the
same events and latencies.
"""
import re

import pytest

from paddle_tpu.inference import resilience as jres
from paddle_tpu.observability import metrics as jmet
from paddle_tpu_torch.inference import resilience as tres
from paddle_tpu_torch.observability import metrics as tmet

# one sample line of the text format 0.0.4: name, optional labels, value
SAMPLE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*")*)?\})? '
    r'(-?[0-9.e+-]+|[+-]Inf|NaN)$')


def _counters(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("paddle_x_total", "events by kind",
                    labels=("component", "event"))
    c.labels("a", "b").inc()
    c.labels("a", "c").inc(2.5)
    c.labels(component="z", event="q").inc(3)
    c.labels("a", "b").inc(4)
    reg.counter("paddle_plain_total", "no labels").inc(7)
    reg.counter("paddle_fn_total", "read at scrape",
                labels=("pool",)).labels("kv").set_function(lambda: 11)
    return mod.render_prometheus(reg)


def _gauges(mod):
    reg = mod.MetricsRegistry()
    g = reg.gauge("paddle_pool_blocks", "blocks by state",
                  labels=("pool", "state"))
    g.labels("kv", "live").set(4)
    g.labels("kv", "free").set_function(lambda: 7)
    g.labels("kv", "evictable").inc(2)
    g.labels("kv", "evictable").dec(0.5)
    reg.gauge("paddle_nan", "a NaN must render").set(float("nan"))
    reg.gauge("paddle_inf", "infinities").set(float("inf"))
    reg.gauge("paddle_big", "no int form").set(3e17)
    reg.gauge("paddle_frac", "").set(0.125)
    return mod.render_prometheus(reg)


def _histograms(mod):
    reg = mod.MetricsRegistry()
    h = reg.histogram("paddle_lat_seconds", "latency",
                      labels=("component",), buckets=(1.0, 0.01, 0.1))
    for v in (0.001, 0.05, 0.5, 5.0, 0.01, 0.1):
        h.labels("gen").observe(v)
    h.labels("other").observe(2)
    d = reg.histogram("paddle_default_seconds", "default buckets")
    for v in (0.0005, 0.3, 40.0):
        d.observe(v)
    return mod.render_prometheus(reg)


def _merged(mod):
    a, b = mod.MetricsRegistry(), mod.MetricsRegistry()
    for reg, comp in ((a, "r0"), (b, "r1")):
        reg.counter("paddle_ev_total", "events",
                    labels=("component",)).labels(comp).inc(3)
        reg.gauge("paddle_slots", "", labels=("component", "phase")).labels(
            comp, "free").set(2)
    b.gauge("paddle_only_b", "b only").set(1)
    return mod.render_prometheus(a, b, a, None)     # a twice: rendered once


def _escapes(mod):
    reg = mod.MetricsRegistry()
    reg.gauge("paddle_esc", "labels escaped",
              labels=("path",)).labels('a"b\\c\nd').set(1)
    return reg.render()


SCENARIOS = {"counters": _counters, "gauges": _gauges,
             "histograms": _histograms, "merged": _merged,
             "escapes": _escapes}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_render_prometheus_same_text_as_jax(name):
    got = SCENARIOS[name](tmet)
    assert got == SCENARIOS[name](jmet)
    for line in got.splitlines():
        assert line.startswith("# HELP ") or line.startswith("# TYPE ") \
            or SAMPLE.match(line), line


def _conflicting_type(mod):
    reg = mod.MetricsRegistry()
    reg.counter("paddle_a_total", "x", labels=("k",))
    reg.gauge("paddle_a_total", "x", labels=("k",))


def _conflicting_labels(mod):
    reg = mod.MetricsRegistry()
    reg.counter("paddle_a_total", "x", labels=("k",))
    reg.counter("paddle_a_total", "x", labels=("j",))


def _negative_inc(mod):
    mod.MetricsRegistry().counter("paddle_a_total", "x").inc(-1)


def _bad_name(mod):
    mod.MetricsRegistry().gauge("9bad", "x")


def _reserved_le(mod):
    mod.MetricsRegistry().histogram("paddle_h", "x", labels=("le",))


def _label_arity(mod):
    mod.MetricsRegistry().gauge("paddle_g", "x", labels=("a", "b")).labels(
        "only-one")


def _duplicate_series(mod):
    a, b = mod.MetricsRegistry(), mod.MetricsRegistry()
    for reg in (a, b):
        reg.counter("paddle_ev_total", "x", labels=("c",)).labels("r0").inc()
    mod.render_prometheus(a, b)


def _cross_registry_conflict(mod):
    a, b = mod.MetricsRegistry(), mod.MetricsRegistry()
    a.counter("paddle_ev_total", "x")
    b.gauge("paddle_ev_total", "x")
    mod.render_prometheus(a, b)


def _observe_on_counter(mod):
    mod.MetricsRegistry().counter("paddle_a_total", "x").observe(1.0)


CONTRACTS = {"conflicting_type": _conflicting_type,
             "conflicting_labels": _conflicting_labels,
             "negative_inc": _negative_inc, "bad_name": _bad_name,
             "reserved_le": _reserved_le, "label_arity": _label_arity,
             "duplicate_series": _duplicate_series,
             "cross_registry_conflict": _cross_registry_conflict,
             "observe_on_counter": _observe_on_counter}


@pytest.mark.parametrize("name", sorted(CONTRACTS))
def test_registry_contracts_fail_as_jax_does(name):
    errors = []
    for mod in (jmet, tmet):
        with pytest.raises((ValueError, TypeError)) as ei:
            CONTRACTS[name](mod)
        errors.append(type(ei.value))
    assert errors[0] is errors[1]


def test_get_or_create_returns_the_same_family():
    reg = tmet.MetricsRegistry()
    fam = reg.counter("paddle_a_total", "x", labels=("k",))
    assert reg.counter("paddle_a_total", "x", labels=("k",)) is fam
    assert fam.labels("v") is fam.labels(k="v")


def _serving(mod):
    reg = mod.MetricsRegistry()
    sm = mod.ServingMetrics(registry=reg, component="continuous")
    for name, n in (("accepted", 3), ("completed", 2), ("timeouts", 1),
                    ("prefix_hit_tokens", 64), ("completed", 0)):
        sm.inc(name, n)
    for v in (0.004, 0.2, 0.03, 1.5):
        sm.observe_latency(v)
    return reg, sm


def test_serving_metrics_same_exposition_and_json_as_jax():
    (jreg, jsm), (treg, tsm) = _serving(jres), _serving(tres)
    assert tmet.render_prometheus(treg) == jmet.render_prometheus(jreg)
    assert tsm.snapshot() == jsm.snapshot()
    assert tsm.get("completed") == 2 and tsm.get("missing") == 0
