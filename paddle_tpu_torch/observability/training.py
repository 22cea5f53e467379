"""Training-side telemetry: ``StepMonitor`` over ``jit.TrainStep`` — the
port's counterpart of ``paddle_tpu/observability/training.py``, with the
same metric names (``paddle_train_*``, ``paddle_analysis_findings_total``),
help strings, labels, buckets, span names and goodput arithmetic.

The step calls back into the monitor at three points (``step_begin`` /
``before_launch`` (``before_scan_launch`` in ``run_steps``) /
``step_end``); with no monitor bound it pays attribute checks only, and
the captured program is the same. Where the port differs:

* **MFU's numerator** (``observe_compiled``) is ``StepProgram.flops``,
  the ``torch.utils.flop_counter`` count of one body run that
  ``TrainStep.aot_prime`` takes, where JAX reads XLA's ``cost_analysis``. The counter sees aten
  operators only: the hand-written attention kernels' products are not
  in it on the card (only the flash forward's custom operator has a
  formula); on the CPU, where the kernels' plain versions run their
  einsums, they are. As in JAX, the gauge is set only for an
  ``aot_prime``d step (or ``flops_per_step=``).
* **HBM gauges** (``paddle_train_hbm_bytes{kind}``): ``argument`` (the
  parameters, the accumulators and the program's staged inputs) and, on
  the card, ``peak`` (the allocator's watermark read right after the
  program's first run and capture, over everything since its last reset).
  ``output``, ``temp`` and ``generated_code`` have no counterpart in a
  CUDA graph's allocations and stay unset.
* **The recompile sentinel** fingerprints the arguments only
  (``jit.fingerprint.aval_fingerprint``), as JAX does. The port's key also
  holds the parameters' and accumulators' addresses: a replaced tensor
  captures anew without counting as a recompile. ``run_steps`` keys as
  JAX's scan cache does, ``("scan", n_steps, flags, avals)``: a new
  ``n_steps`` counts as a recompile although the port replays the same
  graph n times.
* **The graph lint** (``lint=True``) needs ``paddle_tpu.analysis``, whose
  port is ROADMAP item 6: the ``graph_lint`` event carries the
  ``NotImplementedError`` that JAX's guard would record,
  ``lint_report`` stays None and ``paddle_analysis_findings_total`` stays
  empty.
* **The loss fetch** (``loss_every``) reads the loss the step returns (a
  copy of the capture's own tensor, made before the next replay), outside
  any capture; ``loss_every=0`` adds no host synchronisation.
* ``peak_flops="auto"`` reads the bound step's device
  (``observability.device.device_peak_flops``): None on the CPU, so MFU
  is absent there rather than made up.
"""
from __future__ import annotations

import math
import statistics
import time
from collections import deque
from contextlib import contextmanager

from .device import device_peak_flops
from .metrics import MetricsRegistry
from .trace import Tracer, new_trace_id

__all__ = ["StepMonitor", "NumericsAnomalyDetector", "AnomalyEvent",
           "TRAIN_STEP_BUCKETS"]

# step wall-time buckets: sub-ms eager smoke steps .. minute-long scans
TRAIN_STEP_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                      0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class AnomalyEvent:
    """One typed numerics anomaly: ``kind`` ∈ nan_loss | inf_loss |
    loss_spike | nan_grad_norm | inf_grad_norm | grad_norm_spike."""

    __slots__ = ("kind", "step", "value", "threshold")

    def __init__(self, kind, step, value, threshold=None):
        self.kind = kind
        self.step = int(step)
        self.value = float(value)
        self.threshold = None if threshold is None else float(threshold)

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"AnomalyEvent({self.kind}, step={self.step}, "
                f"value={self.value!r})")


class NumericsAnomalyDetector:
    """NaN/Inf and spike detection over scalar training signals.

    Spikes are judged against the rolling MEDIAN of the last ``window``
    healthy values (median, not mean: one earlier spike must not drag the
    baseline up and mask the next one). Detection starts after
    ``min_history`` healthy observations; NaN/Inf fire immediately and are
    never added to the baseline."""

    def __init__(self, window=64, spike_factor=10.0, min_history=8):
        self.spike_factor = float(spike_factor)
        self.min_history = int(min_history)
        self._hist = {"loss": deque(maxlen=int(window)),
                      "grad_norm": deque(maxlen=int(window))}

    def _check_one(self, name, step, value):
        v = float(value)
        if math.isnan(v):
            return AnomalyEvent(f"nan_{name}", step, v)
        if math.isinf(v):
            return AnomalyEvent(f"inf_{name}", step, v)
        hist = self._hist[name]
        event = None
        if len(hist) >= self.min_history:
            base = statistics.median(hist)
            threshold = self.spike_factor * max(abs(base), 1e-12)
            if abs(v) > threshold:
                event = AnomalyEvent(f"{name}_spike", step, v, threshold)
        if event is None:
            hist.append(v)  # only healthy values extend the baseline
        return event

    def check(self, step, loss=None, grad_norm=None):
        """Returns the (possibly empty) list of AnomalyEvents for this step."""
        events = []
        for name, value in (("loss", loss), ("grad_norm", grad_norm)):
            if value is None:
                continue
            ev = self._check_one(name, step, value)
            if ev is not None:
                events.append(ev)
        return events


class StepMonitor:
    """Live telemetry attached to a ``TrainStep``.

    Usage (bare loop)::

        mon = StepMonitor(samples_per_step=B, tokens_per_step=B * S)
        mon.bind(step)                       # step = TrainStep(...)
        for x, y in loader:
            loss = step(x, labels=y)         # spans + metrics emitted here
        print(mon.last_fields)               # {'step': ..., 'ips': ..., 'mfu': ...}

    ``Model.fit`` users bind it through ``hapi.callbacks.MonitorCallback``.
    ``enabled=False`` turns every hook into an early return (JAX's design
    target for the on-vs-off cost is 3% of the step).  Pass ``log_writer=LogWriter(...)`` to stream the scalar
    series (``train/loss``, ``train/step_time_s``, ``train/ips``,
    ``train/mfu``) to the VisualDL-role log.
    """

    def __init__(self, registry=None, tracer=None, *, samples_per_step=None,
                 tokens_per_step=None, peak_flops="auto", flops_per_step=None,
                 detector=None, log_writer=None, log_freq=1, loss_every=1,
                 lint=True, enabled=True, clock=time.perf_counter):
        self.enabled = bool(enabled)
        # graph lint at the first launch (ROADMAP item 6: not ported; the
        # graph_lint event carries the error). lint=False opts out.
        self.lint = bool(lint)
        self.lint_report = None
        self._lint_pending = self.lint
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer(clock=clock)
        self.detector = (detector if detector is not None
                         else NumericsAnomalyDetector())
        self.log_writer = log_writer
        self.log_freq = max(1, int(log_freq))
        self.loss_every = max(0, int(loss_every))  # 0: never fetch the loss
        self.samples_per_step = samples_per_step
        self.tokens_per_step = tokens_per_step
        self._peak_flops = peak_flops
        self._flops_per_step = flops_per_step
        self._clock = clock
        self._trace_id = new_trace_id()
        self._seen_avals: set = set()
        self._step_n = 0
        self._recompiles = 0
        self._launch_us = None
        self._last_step_end_us = None
        self.last_fields: dict = {}
        self.anomalies: deque = deque(maxlen=256)
        self.hbm_stats: dict = {}

        reg = self.registry
        self._m_steps = reg.counter(
            "paddle_train_steps_total", "optimizer steps executed")
        self._m_step_seconds = reg.histogram(
            "paddle_train_step_seconds",
            "per-step wall time (launch to loss readback)",
            buckets=TRAIN_STEP_BUCKETS)
        self._m_ips = reg.gauge(
            "paddle_train_samples_per_sec", "samples/sec of the last step")
        self._m_tps = reg.gauge(
            "paddle_train_tokens_per_sec", "tokens/sec of the last step")
        self._m_mfu = reg.gauge(
            "paddle_train_mfu",
            "live MFU: cost_analysis FLOPs / wall / chip bf16 peak")
        self._m_loss = reg.gauge("paddle_train_loss", "last fetched loss")
        self._m_flops = reg.gauge(
            "paddle_train_model_flops_per_step",
            "compiled-step FLOPs per cost_analysis")
        self._m_hbm = reg.gauge(
            "paddle_train_hbm_bytes",
            "compiled-step HBM footprint per memory_analysis",
            labels=("kind",))
        self._m_recompiles = reg.counter(
            "paddle_train_recompiles_total",
            "XLA recompiles after the first (new argument shapes)",
            labels=("reason",))
        self._m_anomalies = reg.counter(
            "paddle_train_anomalies_total",
            "numerics anomalies (NaN/Inf/spike on loss and grad norm)",
            labels=("kind",))
        self._m_findings = reg.counter(
            "paddle_analysis_findings_total",
            "graph-lint findings on the bound step at first compile",
            labels=("rule", "severity"))
        # ---- preemption-tolerance accounting (framework.checkpoint feeds
        # the phase timings; steps feed the useful-time numerator)
        self._m_goodput = reg.gauge(
            "paddle_train_goodput",
            "useful-step time / wall time since first activity "
            "(wall includes checkpoint snapshots and restore)")
        self._m_ckpt_seconds = reg.histogram(
            "paddle_train_checkpoint_seconds",
            "checkpoint phase wall (snapshot blocks the loop; serialize/"
            "commit overlap compute; restore is resume cost)",
            labels=("phase",), buckets=TRAIN_STEP_BUCKETS)
        self._m_ckpts = reg.counter(
            "paddle_train_checkpoints_total",
            "checkpoints by terminal result",
            labels=("result",))
        self._useful_s = 0.0
        self._ckpt_s = 0.0
        self._wall_t0_us = None
        self._device = None

    # ------------------------------------------------------------------ time
    def now_us(self) -> float:
        return self._clock() * 1e6

    # -------------------------------------------------------------- binding
    def bind(self, step):
        """Attach to a ``jit/train.py:TrainStep``: the step's hooks start
        reporting here. An AOT-primed executable is introspected immediately
        (FLOPs + HBM gauges) and its avals seed the recompile sentinel."""
        step._monitor = self
        self._device = getattr(step, "device", None)
        pending = getattr(step, "_pending_monitor_counters", None)
        if pending is not None:
            # the step was checkpoint-restored before any monitor was bound:
            # adopt its counters so the metric series stays continuous
            self.import_counters(pending)
            step._pending_monitor_counters = None
        if getattr(step, "_compiled_avals", None) is not None:
            # the AOT program was compiled before we were watching: seed the
            # sentinel with an event but never count it as a recompile
            self._sentinel(step._compiled_avals, "aot_prime", self.now_us(),
                           count=False)
        if getattr(step, "_compiled", None) is not None:
            self.observe_compiled(step._compiled)
        return self

    def detach(self, step):
        if getattr(step, "_monitor", None) is self:
            step._monitor = None

    # ------------------------------------------------- compiled introspection
    def observe_compiled(self, compiled):
        """Pull the FLOP count and memory of a ``TrainStep``'s primed
        ``StepProgram`` into the flops + HBM gauges (the kinds the program
        records: ``argument``, and ``peak`` on the card; see the module
        docstring)."""
        if not self.enabled:
            return
        flops = compiled.flops
        if flops:
            self._flops_per_step = flops
            self._m_flops.set(flops)
        mem = compiled.memory
        if mem:
            self.hbm_stats = mem
            for kind in ("argument", "output", "temp", "generated_code",
                         "peak"):
                if f"{kind}_bytes" in mem:
                    self._m_hbm.labels(kind).set(mem[f"{kind}_bytes"])

    @property
    def flops_per_step(self):
        return self._flops_per_step

    @property
    def hbm_peak_bytes(self):
        return self.hbm_stats.get("peak_bytes", 0)

    @property
    def recompiles(self) -> int:
        """Compiles triggered by a NEW argument fingerprint after the first
        program was built (the silent-retrace bug class)."""
        return self._recompiles

    def set_throughput_units(self, samples_per_step=None, tokens_per_step=None):
        if samples_per_step is not None:
            self.samples_per_step = samples_per_step
        if tokens_per_step is not None:
            self.tokens_per_step = tokens_per_step

    def peak_flops(self):
        if self._peak_flops == "auto":
            if self._device is None:
                return None        # resolved once a step is bound
            self._peak_flops = device_peak_flops(self._device)
        return self._peak_flops

    # ------------------------------------------------------- TrainStep hooks
    def step_begin(self):
        """Hook 1/3 (TrainStep.__call__ entry). Returns the t0 token."""
        if not self.enabled:
            return None
        now = self.now_us()
        if self._wall_t0_us is None:
            self._wall_t0_us = now
        return now

    def _sentinel(self, key, reason_if_new, when_us, count=True):
        """New fingerprint == XLA built a new program: count (except the
        very first compile) and emit a point trace event either way."""
        if key in self._seen_avals:
            return
        first = not self._seen_avals
        self._seen_avals.add(key)
        reason = "first" if first else reason_if_new
        if count and not first:
            self._recompiles += 1
            self._m_recompiles.labels(reason).inc()
        self.tracer.record("compile", when_us, when_us, self._trace_id,
                           tags={"reason": reason, "step": self._step_n + 1,
                                 "shapes": repr(key[-1])[:200]})

    def before_launch(self, step, args, kwargs, aot_hit, t0):
        """Hook 2/3 (inputs staged, about to launch): closes the ``h2d``
        span and runs the recompilation sentinel over the argument avals."""
        if not self.enabled or t0 is None:
            return
        now = self.now_us()
        self._launch_us = now
        self.tracer.record("h2d", t0, now, self._trace_id,
                           tags={"step": self._step_n + 1})
        reason = ("aot_fallback" if (step._compiled is not None
                                     and not aot_hit) else "new_shape")
        self._sentinel(step._arg_avals(args, kwargs), reason, now)
        if self._lint_pending:
            self._run_lint(step, args, kwargs)

    def before_scan_launch(self, step, n_steps, flags, args, kwargs, t0):
        """run_steps twin of before_launch: the fingerprint also covers the
        scan length and the stacked/const split (each combination is its own
        compiled program in the scan cache)."""
        if not self.enabled or t0 is None:
            return
        now = self.now_us()
        self._launch_us = now
        self.tracer.record("h2d", t0, now, self._trace_id,
                           tags={"step": self._step_n + 1,
                                 "n_steps": n_steps})
        self._sentinel(("scan", n_steps, flags,
                        step._arg_avals(args, kwargs)), "new_shape", now)
        if self._lint_pending:
            self._run_lint(step, args, kwargs)

    # ---------------------------------------------------------- graph lint
    def _run_lint(self, step, args, kwargs):
        """The graph lint, once at the first launch. JAX runs
        ``paddle_tpu.analysis`` over the step here; its port is ROADMAP
        item 6, so the ``graph_lint`` event carries the
        ``NotImplementedError`` that JAX's guard would record. Never
        raises: telemetry must not take down the loop."""
        self._lint_pending = False
        now = self.now_us()
        err = NotImplementedError("StepMonitor graph lint: paddle_tpu.analysis"
                                  " is not ported (ROADMAP item 6)")
        self.tracer.record("graph_lint", now, self.now_us(), self._trace_id,
                           tags={"error": repr(err)[:200]})

    def step_end(self, step, loss_val, t0, n_steps=1):
        """Hook 3/3 (state written back): closes the ``step`` span, updates
        throughput/MFU gauges, fetches the loss (every ``loss_every`` steps)
        and feeds the anomaly detector."""
        if not self.enabled or t0 is None:
            return
        # fetch the loss BEFORE stamping the end time: the fetch is the
        # honest step boundary (it blocks on the device), and the step wall /
        # goodput useful-time must include the compute it waits for — with a
        # periodic cadence (loss_every=K) the fetch step absorbs the queued
        # compute of the K-1 async-dispatched steps before it, so the SUM of
        # step walls stays right even when each individual one is not
        loss_f = None
        if self.loss_every and (self._step_n + n_steps) % self.loss_every \
                == 0 and loss_val is not None:
            try:
                loss_f = float(loss_val)
            except Exception:
                loss_f = None
        end = self.now_us()
        launch = self._launch_us if self._launch_us is not None else t0
        self._launch_us = None
        self._step_n += n_steps
        self._last_step_end_us = end
        name = "step" if n_steps == 1 else "run_steps"
        self.tracer.record(name, launch, end, self._trace_id,
                           tags={"step": self._step_n, "n_steps": n_steps})
        dt_s = max((end - t0) / 1e6, 1e-12) / n_steps
        self._m_steps.inc(n_steps)
        self._m_step_seconds.observe(dt_s)
        self._useful_s += (end - t0) / 1e6
        fields = {"step": self._step_n, "step_time_s": dt_s}
        gp = self._goodput_at(end)
        if gp is not None:
            fields["goodput"] = gp
            self._m_goodput.set(gp)
        if self.samples_per_step:
            fields["ips"] = self.samples_per_step / dt_s
            self._m_ips.set(fields["ips"])
        if self.tokens_per_step:
            fields["tokens_per_sec"] = self.tokens_per_step / dt_s
            self._m_tps.set(fields["tokens_per_sec"])
        peak = self.peak_flops()
        if self._flops_per_step and peak:
            fields["mfu"] = self._flops_per_step / dt_s / peak
            self._m_mfu.set(fields["mfu"])
        if loss_f is not None:
            fields["loss"] = loss_f
            self._m_loss.set(loss_f)
            self.observe_scalars(self._step_n, loss=loss_f)
        self.last_fields = fields
        if self.log_writer is not None and self._step_n % self.log_freq == 0:
            for tag in ("loss", "step_time_s", "ips", "tokens_per_sec",
                        "mfu"):
                if tag in fields:
                    self.log_writer.add_scalar(f"train/{tag}", fields[tag],
                                               step=self._step_n)

    # ------------------------------------------- checkpointing & goodput
    def _goodput_at(self, now_us):
        """useful-step seconds / wall seconds since the first activity this
        monitor saw (a step, a checkpoint phase, or a restore). Wall time
        includes checkpoint snapshots, restore, data waits — everything a
        preemption-tolerant run pays that is not a training step."""
        if self._wall_t0_us is None:
            return None
        wall = (now_us - self._wall_t0_us) / 1e6
        if wall <= 0:
            return None
        return min(1.0, self._useful_s / wall)

    @property
    def goodput(self):
        return self._goodput_at(self.now_us())

    @property
    def useful_step_seconds(self):
        return self._useful_s

    @property
    def checkpoint_seconds(self):
        """Total seconds spent in checkpoint phases (all phases, incl.
        restore) reported to this monitor."""
        return self._ckpt_s

    def checkpoint_phase(self, phase, seconds):
        """``framework.checkpoint.CheckpointManager`` hook: one finished
        phase (``snapshot`` | ``serialize`` | ``commit`` | ``restore``).
        Lands in the phase histogram, a span on the step timeline, and the
        goodput wall window (a restore that happened before the first step
        backdates the window so resume cost counts against goodput)."""
        if not self.enabled:
            return
        seconds = max(0.0, float(seconds))
        now = self.now_us()
        start = now - seconds * 1e6
        if self._wall_t0_us is None or start < self._wall_t0_us:
            self._wall_t0_us = start
        self._ckpt_s += seconds
        self._m_ckpt_seconds.labels(phase).observe(seconds)
        self.tracer.record(f"ckpt_{phase}", start, now, self._trace_id,
                           tags={"step": self._step_n})
        gp = self._goodput_at(now)
        if gp is not None:
            self._m_goodput.set(gp)

    def checkpoint_result(self, ok=True, step=None):
        """One checkpoint reached a terminal result (manifest committed, or
        the async writer failed)."""
        if not self.enabled:
            return
        self._m_ckpts.labels("committed" if ok else "failed").inc()

    def export_counters(self):
        """Counters that survive a preemption inside a checkpoint (the
        ``TrainStep.export_state`` meta): the step number keeps the metric
        series continuous across resume. Time windows (goodput) restart per
        process — resume cost is charged to the NEW process's window."""
        return {"step_n": int(self._step_n)}

    def import_counters(self, counters):
        self._step_n = int(counters.get("step_n", self._step_n))

    # ---------------------------------------------------------- numerics
    def observe_scalars(self, step=None, loss=None, grad_norm=None):
        """Feed scalar signals to the anomaly detector (the step hook feeds
        the loss automatically; callers with a host-side grad norm — e.g. a
        clip-by-global-norm readback — feed it here)."""
        if not self.enabled:
            return []
        events = self.detector.check(
            self._step_n if step is None else step, loss=loss,
            grad_norm=grad_norm)
        for ev in events:
            self.anomalies.append(ev)
            self._m_anomalies.labels(ev.kind).inc()
            t = self.now_us()
            self.tracer.record("anomaly", t, t, self._trace_id,
                               tags={"kind": ev.kind, "step": ev.step,
                                     "value": ev.value})
        return events

    # -------------------------------------------------------------- phases
    @contextmanager
    def phase(self, name, **tags):
        """Span a host-side phase (``data_wait``, ``callbacks``) onto the
        same step timeline::

            with mon.phase("data_wait"):
                batch = next(it)
        """
        if not self.enabled:
            yield self
            return
        t0 = self.now_us()
        try:
            yield self
        finally:
            self.tracer.record(name, t0, self.now_us(), self._trace_id,
                               tags=dict(tags, step=self._step_n + 1))

    def record_phase(self, name, start_us, end_us, **tags):
        """Explicit-timestamp phase (cross-callback intervals)."""
        if not self.enabled:
            return
        self.tracer.record(name, start_us, end_us, self._trace_id,
                           tags=dict(tags, step=self._step_n + 1))

    @property
    def last_step_end_us(self):
        return self._last_step_end_us

    # -------------------------------------------------------------- export
    def render(self) -> str:
        """This monitor's registry as a Prometheus text exposition (merge
        with serving registries via ``render_prometheus``)."""
        return self.registry.render()
