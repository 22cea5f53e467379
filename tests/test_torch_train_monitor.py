"""The training monitor (``observability.StepMonitor`` over
``jit.TrainStep``) of the port against the JAX package's on the CPU: the
bodies of ``tests/test_train_monitor.py`` over ``gpt_tiny()`` in both
packages, the same weights (bridged from the JAX model) and batches.

Compared: the Prometheus text line for line (HELP / TYPE lines and series
keys exactly; counter values exactly; the loss gauge within 1e-5 relative,
f32 sums in another order), except values that are clock readings (step
seconds, rates, MFU, goodput) and the two families whose numbers differ by
design: ``paddle_train_model_flops_per_step`` (XLA's cost analysis against
``torch.utils.flop_counter``) and ``paddle_train_hbm_bytes`` (XLA's
memory-analysis kinds against the port's ``argument`` and, on the card,
``peak``). Span names and counts, recompile reasons, anomaly events and
the LogWriter records are compared exactly. The comparisons run with the
lint off (``Kit.monitor``); the graph lint is held on its own
(``paddle_tpu_torch.analysis`` over an FX graph of the step, once at the
first launch). JAX's answers are computed once per scenario in module
fixtures.
"""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.train import TrainStep as JaxTrainStep
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.observability import StepMonitor as JaxMonitor
import paddle_tpu_torch as port
from paddle_tpu_torch import from_paddle_tpu_state
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.observability import (
    MetricsRegistry,
    NumericsAnomalyDetector,
    StepMonitor,
    export_joined_chrome,
    render_prometheus,
)
from port_bodies import on_cpu  # noqa: F401

LOSS_RTOL = 1e-5
# series whose values are clock readings: compared by key only
CLOCK = {"paddle_train_step_seconds_bucket", "paddle_train_step_seconds_sum",
         "paddle_train_samples_per_sec", "paddle_train_tokens_per_sec",
         "paddle_train_mfu", "paddle_train_goodput",
         "paddle_train_checkpoint_seconds_bucket",
         "paddle_train_checkpoint_seconds_sum"}
# series whose numbers differ by design (module docstring)
DESIGN = ("paddle_train_model_flops_per_step", "paddle_train_hbm_bytes")


def _state(seed=11):
    with paddle.utils.unique_name.guard():
        paddle.seed(seed)
        jm = jgpt.GPTForCausalLM(jgpt.gpt_tiny())
    return {k: np.asarray(v) for k, v in jm.gpt.raw_state().items()}


STATE = _state()


class Kit:
    """One package's side of a body: a gpt_tiny TrainStep under AdamW from
    the shared weights, batches, and its StepMonitor."""

    def __init__(self, pkg):
        self.pkg = pkg

    def step(self):
        if self.pkg == "jax":
            with paddle.utils.unique_name.guard():
                jm = jgpt.GPTForCausalLM(jgpt.gpt_tiny())
            jm.gpt.load_raw_state(STATE)
            opt = paddle.optimizer.AdamW(1e-3, parameters=jm.parameters())
            return JaxTrainStep(jm, lambda logits, loss: loss, opt)
        tm = from_paddle_tpu_state(STATE, tgpt.gpt_tiny(), device="cpu")
        opt = topt.AdamW(learning_rate=1e-3, parameters=tm.parameters())
        return TrainStep(tm, lambda logits, loss: loss, opt)

    def batch(self, B=2, S=16, seed=0):
        ids = np.random.default_rng(seed).integers(0, 1024, (B, S))
        labels = np.roll(ids, -1, axis=1)
        if self.pkg == "jax":
            return (paddle.to_tensor(ids),), {
                "labels": paddle.to_tensor(labels)}
        return (torch.from_numpy(ids),), {"labels": torch.from_numpy(labels)}

    def monitor(self, **kw):
        kw.setdefault("lint", False)
        return (JaxMonitor if self.pkg == "jax" else StepMonitor)(**kw)

    def poison(self, step):
        """A NaN planted in the final norm's weight."""
        if self.pkg == "jax":
            t = step.model.gpt.ln_f.weight
            t._value = t._value.at[0].set(np.nan)
        else:
            with torch.no_grad():
                step.model.gpt.ln_f.weight[0] = float("nan")


def prom(text):
    """The exposition as comparable items (see the module docstring)."""
    out = []
    for line in text.splitlines():
        if line.startswith("#"):
            out.append(line)
            continue
        key, value = line.rsplit(" ", 1)
        name = key.split("{")[0]
        if name.startswith(DESIGN):
            continue
        if name in CLOCK:
            out.append(key)
        elif name == "paddle_train_loss":
            out.append((key, float(value)))
        else:
            out.append(line)
    return out


def assert_prom_equal(got, want):
    got, want = prom(got), prom(want)
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            assert g[0] == w[0]
            np.testing.assert_allclose(g[1], w[1], rtol=LOSS_RTOL)
        else:
            assert g == w


def names(mon):
    return [s.name for s in mon.tracer.spans()]


# ------------------------------------------------------------- scenarios
def live_mfu(pkg):
    kit = Kit(pkg)
    step = kit.step()
    args, kw = kit.batch()
    step.aot_prime(*args, **kw)
    mon = kit.monitor(samples_per_step=2, tokens_per_step=32,
                      peak_flops=1e9)
    mon.bind(step)
    losses = [float(step(*args, **kw)) for _ in range(3)]
    f = mon.last_fields
    assert f["step"] == 3 and f["step_time_s"] > 0
    assert f["ips"] == pytest.approx(2 / f["step_time_s"])
    assert f["tokens_per_sec"] == pytest.approx(32 / f["step_time_s"])
    assert f["mfu"] == pytest.approx(
        mon.flops_per_step / f["step_time_s"] / 1e9)
    assert mon.flops_per_step > 0 and mon.recompiles == 0
    mon.detach(step)
    assert step._monitor is None
    return dict(text=mon.render(), spans=names(mon), losses=losses,
                fields=sorted(f), hbm=dict(mon.hbm_stats))


def shape_change(pkg):
    kit = Kit(pkg)
    step = kit.step()
    mon = kit.monitor(peak_flops=None)
    mon.bind(step)
    a, k = kit.batch(B=2)
    step(*a, **k)
    step(*a, **k)
    r0 = mon.recompiles
    a2, k2 = kit.batch(B=1, seed=1)
    step(*a2, **k2)
    r1 = mon.recompiles
    step(*a2, **k2)
    return dict(text=mon.render(), recompiles=[r0, r1, mon.recompiles],
                reasons=[s.tags["reason"] for s in mon.tracer.spans()
                         if s.name == "compile"])


def aot_fallback(pkg):
    kit = Kit(pkg)
    step = kit.step()
    a, k = kit.batch(B=2)
    step.aot_prime(*a, **k)
    mon = kit.monitor(peak_flops=None)
    mon.bind(step)
    step(*a, **k)
    r0 = mon.recompiles
    a2, k2 = kit.batch(B=1, seed=2)
    step(*a2, **k2)
    return dict(text=mon.render(), recompiles=[r0, mon.recompiles],
                reasons=[s.tags["reason"] for s in mon.tracer.spans()
                         if s.name == "compile"])


def run_steps(pkg):
    kit = Kit(pkg)
    step = kit.step()
    mon = kit.monitor(samples_per_step=2)
    mon.bind(step)
    a, k = kit.batch()
    losses = step.run_steps(3, *a, **k)
    r0 = mon.recompiles
    step.run_steps(2, *a, **k)
    return dict(text=mon.render(), shape=tuple(losses.shape),
                spans=names(mon), recompiles=[r0, mon.recompiles],
                step=mon.last_fields["step"])


def inert(pkg):
    kit = Kit(pkg)
    step = kit.step()
    a, k = kit.batch()
    base = float(step(*a, **k))
    mon = kit.monitor(enabled=False)
    mon.bind(step)
    second = float(step(*a, **k))
    text = mon.render()
    assert "# TYPE paddle_train_steps_total counter" in text
    assert "\npaddle_train_steps_total " not in text
    return dict(text=text, spans=names(mon), fields=mon.last_fields,
                losses=[base, second])


def nan_step(pkg):
    kit = Kit(pkg)
    step = kit.step()
    mon = kit.monitor(peak_flops=None)
    mon.bind(step)
    a, k = kit.batch()
    step(*a, **k)
    kit.poison(step)
    step(*a, **k)
    return dict(text=mon.render(),
                kinds=[e.kind for e in mon.anomalies],
                events=[s.tags["kind"] for s in mon.tracer.spans()
                        if s.name == "anomaly"])


SCENARIOS = {f.__name__: f for f in (live_mfu, shape_change, aot_fallback,
                                     run_steps, inert, nan_step)}


def _jax_answer(name):
    """A module fixture with the JAX package's answer of scenario
    ``name`` (computed in the setup, once)."""
    @pytest.fixture(scope="module")
    def answer():
        return SCENARIOS[name]("jax")
    return answer


for _name in SCENARIOS:
    globals()[f"jax_{_name}"] = _jax_answer(_name)


# ------------------------------------------------------------- the legs
def test_metrics_spans_and_live_mfu(on_cpu, jax_live_mfu):
    got, want = SCENARIOS["live_mfu"]("torch"), jax_live_mfu
    assert_prom_equal(got["text"], want["text"])
    assert got["spans"] == want["spans"]
    assert got["spans"].count("step") == 3 and got["spans"].count("h2d") == 3
    assert got["spans"].count("compile") == 1
    assert got["fields"] == want["fields"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    # the kinds the port records on the CPU: argument bytes, no peak
    assert got["hbm"]["argument_bytes"] > 0 and "peak_bytes" not in got["hbm"]
    assert 'paddle_train_hbm_bytes{kind="argument"}' in got["text"]
    assert 'kind="peak"' not in got["text"]


def test_recompile_sentinel_detects_shape_change(on_cpu, jax_shape_change):
    got, want = SCENARIOS["shape_change"]("torch"), jax_shape_change
    assert got["recompiles"] == want["recompiles"] == [0, 1, 1]
    assert got["reasons"] == want["reasons"] == ["first", "new_shape"]
    assert_prom_equal(got["text"], want["text"])
    assert 'paddle_train_recompiles_total{reason="new_shape"} 1' \
        in got["text"]


def test_recompile_sentinel_flags_aot_fallback(on_cpu, jax_aot_fallback):
    got, want = SCENARIOS["aot_fallback"]("torch"), jax_aot_fallback
    assert got["recompiles"] == want["recompiles"] == [0, 1]
    assert got["reasons"] == want["reasons"]
    assert_prom_equal(got["text"], want["text"])
    assert 'paddle_train_recompiles_total{reason="aot_fallback"} 1' \
        in got["text"]


def test_run_steps_monitored_counts_all_steps(on_cpu, jax_run_steps):
    got, want = SCENARIOS["run_steps"]("torch"), jax_run_steps
    assert got["shape"] == want["shape"] == (3,)
    assert got["spans"] == want["spans"]
    assert "run_steps" in got["spans"]
    assert got["recompiles"] == want["recompiles"] == [0, 1]
    assert got["step"] == want["step"] == 5
    assert_prom_equal(got["text"], want["text"])


def test_monitor_disabled_and_unbound_are_inert(on_cpu, jax_inert):
    got, want = SCENARIOS["inert"]("torch"), jax_inert
    assert got["spans"] == want["spans"] == []
    assert got["fields"] == want["fields"] == {}
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    assert_prom_equal(got["text"], want["text"])


def test_nan_loss_detected_from_a_real_training_step(on_cpu, jax_nan_step):
    got, want = SCENARIOS["nan_step"]("torch"), jax_nan_step
    assert got["kinds"] == want["kinds"] == ["nan_loss"]
    assert got["events"] == want["events"] == ["nan_loss"]
    assert_prom_equal(got["text"], want["text"])


def test_anomaly_detector_matches_jax_on_one_sequence():
    from paddle_tpu.observability import NumericsAnomalyDetector as JaxDet

    seq = [("loss", 1.0 + 0.01 * i) for i in range(6)] + [
        ("loss", float("nan")), ("loss", float("inf")), ("loss", 50.0),
        ("loss", 50.0), ("loss", 1.02)] + [("grad_norm", 0.5)] * 6 + [
        ("grad_norm", 500.0), ("grad_norm", float("nan"))]

    def events(det):
        out = []
        for i, (name, v) in enumerate(seq):
            for e in det.check(i, **{name: v}):
                out.append((e.kind, e.step, repr(e.value), e.threshold))
        return out

    kw = dict(window=16, spike_factor=10.0, min_history=4)
    got, want = events(NumericsAnomalyDetector(**kw)), events(JaxDet(**kw))
    assert got == want
    assert [k for k, *_ in got] == ["nan_loss", "inf_loss", "loss_spike",
                                    "loss_spike", "grad_norm_spike",
                                    "nan_grad_norm"]


def test_monitor_routes_anomalies_to_counter_and_trace():
    def body(mon):
        for i in range(8):
            mon.observe_scalars(step=i, loss=2.0)
        events = mon.observe_scalars(step=9, loss=float("nan"))
        return [e.kind for e in events], mon.render()

    kinds, text = body(StepMonitor(peak_flops=None))
    jkinds, jtext = body(JaxMonitor(peak_flops=None))
    assert kinds == jkinds == ["nan_loss"]
    assert text == jtext
    assert 'paddle_train_anomalies_total{kind="nan_loss"} 1' in text


def test_joined_chrome_export_has_step_phases_next_to_profiler_events(
        on_cpu, tmp_path):
    kit = Kit("torch")
    step = kit.step()
    a, k = kit.batch()
    mon = StepMonitor(peak_flops=None)
    mon.bind(step)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with mon.phase("data_wait"):
            pass
        with torch.profiler.record_function("host_marker"):
            step(*a, **k)
    path = str(tmp_path / "joined.json")
    export_joined_chrome(path, tracer=mon.tracer, profiler=prof)
    events = json.load(open(path))["traceEvents"]
    names_ = [e["name"] for e in events]
    for expected in ("data_wait", "h2d", "step", "host_marker"):
        assert expected in names_, f"missing {expected}"
    ts = [e["ts"] for e in events]
    assert ts == sorted(ts)


def test_graph_lint_is_item_6(on_cpu):
    """The counterpart of JAX's test_monitor_lints_step_once_at_first_
    compile: StepMonitor(lint=True, the default) runs analysis over the
    bound step at its FIRST launch only — a Report lands on the monitor,
    findings count into paddle_analysis_findings_total{rule,severity} and a
    graph_lint span joins the timeline. The lint changes nothing the step
    computes: its losses are bit-equal to an unmonitored twin's."""
    kit = Kit("torch")
    step = kit.step()
    twin = kit.step()
    a, k = kit.batch()
    mon = StepMonitor(samples_per_step=2).bind(step)
    losses = [step(*a, **k)]
    rep = mon.lint_report
    assert rep is not None and rep.name == "train_step:GPTForCausalLM"
    assert rep.high() == []                 # the in-repo step is clean
    lint = [s for s in mon.tracer.spans() if s.name == "graph_lint"]
    assert len(lint) == 1 and "error" not in lint[0].tags
    assert lint[0].tags["findings"] == len(rep.findings)
    assert lint[0].tags["high"] == 0
    losses.append(step(*a, **k))            # second step: no re-lint
    assert [s.name for s in mon.tracer.spans()].count("graph_lint") == 1
    assert step.optimizer._step_count == 2 and step._seed == 2
    for got, want in zip(losses, [twin(*a, **k), twin(*a, **k)]):
        assert torch.equal(got, want)
    text = mon.render()
    assert "# TYPE paddle_analysis_findings_total counter" in text
    for rule, n in rep.by_rule().items():
        assert f'paddle_analysis_findings_total{{rule="{rule}"' in text
    quiet = kit.step()
    off = StepMonitor(lint=False).bind(quiet)
    quiet(*a, **k)
    assert off.lint_report is None and "graph_lint" not in names(off)


def test_monitor_counters_ride_export_and_import(on_cpu):
    """The step number survives export_state / import_state; restored
    before a bind, it waits in _pending_monitor_counters (JAX :425-483)."""
    kit = Kit("torch")
    step = kit.step()
    a, k = kit.batch()
    mon = StepMonitor(peak_flops=None).bind(step)
    for _ in range(3):
        step(*a, **k)
    saved = step.export_state()
    assert saved["meta"]["monitor"] == {"step_n": 3}
    fresh = kit.step()
    fresh.import_state(saved)
    assert fresh._pending_monitor_counters == {"step_n": 3}
    mon2 = StepMonitor(peak_flops=None).bind(fresh)
    assert fresh._pending_monitor_counters is None
    fresh(*a, **k)
    assert mon2.last_fields["step"] == 4
    bound = kit.step()
    mon3 = StepMonitor(peak_flops=None).bind(bound)
    bound.import_state(saved)
    assert mon3.export_counters() == {"step_n": 3}
    assert mon.export_counters() == {"step_n": 3}


# ----------------------------------------------------------- hapi surface
def _fit_model(P):
    X = np.random.default_rng(0).standard_normal((48, 8)).astype("float32")
    Y = np.random.default_rng(1).integers(0, 4, (48, 1))

    class DS(P.io.Dataset):
        def __len__(self):
            return 48

        def __getitem__(self, i):
            return X[i], Y[i]

    nn = P.nn
    net = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))
    rng = np.random.default_rng(3)
    net.set_state_dict({k: (rng.standard_normal(t.shape) * 0.3)
                        .astype("float32")
                        for k, t in net.state_dict().items()})
    model = P.Model(net)
    model.prepare(P.optimizer.Adam(1e-2, parameters=net.parameters()),
                  nn.CrossEntropyLoss())
    return model, DS()


def _fit_with_monitor(P, logdir):
    from importlib import import_module

    cb = import_module(P.__name__ + ".hapi.callbacks")
    model, ds = _fit_model(P)
    mon_cb = cb.MonitorCallback(log_dir=logdir, samples_per_step=16,
                                loss_every=1, log_freq=1, lint=False)
    model.fit(ds, batch_size=16, epochs=2, verbose=0, shuffle=False,
              callbacks=[mon_cb, cb.ProgBarLogger(verbose=0)])
    mon = mon_cb.monitor
    assert model._step_monitor is mon
    assert model._train_step is not None
    assert model._train_step._monitor is None          # detached at on_end
    fname = [f for f in os.listdir(logdir) if f.startswith("vdlrecords")][0]
    return mon, os.path.join(logdir, fname)


def test_monitor_callback_binds_streams_and_spans(on_cpu, tmp_path):
    from paddle_tpu.utils.log_writer import read_log as jax_read_log
    from paddle_tpu.utils.log_writer import scalars as jax_scalars
    from paddle_tpu_torch.utils.log_writer import scalars

    mon, path = _fit_with_monitor(port, str(tmp_path / "port"))
    jmon, jpath = _fit_with_monitor(paddle, str(tmp_path / "jax"))
    assert "paddle_train_steps_total 6" in mon.render()    # 3 batches x 2
    assert_prom_equal(mon.render(), jmon.render())
    for expected in ("data_wait", "h2d", "step", "callbacks"):
        assert expected in names(mon), expected
    assert sorted(set(names(mon))) == sorted(set(names(jmon)))
    # one file format: each package reads the other's log
    series, jseries = scalars(path), jax_scalars(jpath)
    assert jax_scalars(path).keys() == series.keys() == jseries.keys()
    assert len(series["train/loss"]) == 6 and "train/ips" in series
    np.testing.assert_allclose([v for _, v in series["train/loss"]],
                               [v for _, v in jseries["train/loss"]],
                               rtol=1e-5)
    assert [sorted(r) for r in jax_read_log(path)] == [
        sorted(r) for r in jax_read_log(jpath)]


def test_progbar_surfaces_monitor_fields_only_when_active(capsys):
    from paddle_tpu.hapi.callbacks import ProgBarLogger as JaxBar
    from paddle_tpu_torch.hapi.callbacks import ProgBarLogger

    def lines(cls):
        class FakeModel:
            _step_monitor = None

        pb = cls(log_freq=1, verbose=2)
        pb.set_model(FakeModel())
        pb.on_epoch_begin(0)
        pb.on_batch_end("train", 0, {"loss": 0.5})
        plain = capsys.readouterr().out

        class FakeMon:
            last_fields = {"ips": 123.4, "tokens_per_sec": 2048.0,
                           "mfu": 0.415}

        FakeModel._step_monitor = FakeMon()
        pb.on_batch_end("train", 1, {"loss": 0.5})
        live = capsys.readouterr().out
        return plain.split(" (")[0], live.split(" (")[0]

    plain, live = lines(ProgBarLogger)
    assert (plain, live) == lines(JaxBar)
    assert "mfu" not in plain and "ips:" not in plain
    assert "ips: 123.4" in live and "mfu: 41.5%" in live
    assert "tok/s: 2048" in live


def test_train_registry_merges_with_serving_registries():
    from paddle_tpu_torch.inference.resilience import ServingMetrics

    sm = ServingMetrics(component="generator")
    sm.inc("accepted")
    mon = StepMonitor(peak_flops=None)
    text = render_prometheus(sm.registry, mon.registry, MetricsRegistry())
    assert "# TYPE paddle_serving_events_total counter" in text
    assert text.count("# TYPE paddle_train_steps_total counter") == 1


def test_bound_monitor_leaves_losses_and_parameters_bit_equal(on_cpu):
    """The same steps from one saved state, unbound and bound: the same
    losses and parameters, bit for bit, and one program."""
    kit = Kit("torch")
    step = kit.step()
    a, k = kit.batch()
    start = step.export_state()
    bare = [step(*a, **k) for _ in range(3)]
    bare_params = [p.detach().clone() for p in step.model.parameters()]
    step.import_state(start)
    StepMonitor(samples_per_step=2, peak_flops=None).bind(step)
    watched = [step(*a, **k) for _ in range(3)]
    assert torch.equal(torch.stack(watched), torch.stack(bare))
    assert all(torch.equal(p, q) for p, q in
               zip(step.model.parameters(), bare_params))
    assert len(step._programs) == 1
