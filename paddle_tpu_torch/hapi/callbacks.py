"""hapi callbacks — the counterpart of ``paddle_tpu/hapi/callbacks.py``.
Reference: python/paddle/hapi/callbacks.py.

``MonitorCallback`` differs: the JAX package's binds its ``StepMonitor``
(not ported) to the compiled step. The port's times the fit loop's phases
on the host clock itself (``data_wait``: from one batch's end to the next
one's start, the loader's share; ``step``: a batch's start to its end,
which holds the step and its loss read) and gives ``ProgBarLogger`` its
``ips``; a ``monitor`` object with JAX's ``record_phase(name, start_us,
end_us)`` / ``now_us()`` receives the same phases.
"""
from __future__ import annotations

import os
import time

import numpy as np

__all__ = ["Callback", "CallbackList", "ProgBarLogger", "ModelCheckpoint",
           "LRScheduler", "EarlyStopping", "MonitorCallback", "VisualDL"]


def _first(v):
    return float(np.asarray(v).reshape(-1)[0])


class Callback:
    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params

    def on_begin(self, mode, logs=None):
        pass

    def on_end(self, mode, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_batch_begin(self, mode, step, logs=None):
        pass

    def on_batch_end(self, mode, step, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks=None):
        self.callbacks = list(callbacks or [])

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def __getattr__(self, name):
        def dispatch(*args, **kwargs):
            for c in self.callbacks:
                getattr(c, name)(*args, **kwargs)

        if name.startswith("on_"):
            return dispatch
        raise AttributeError(name)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = 0
        self.start = time.time()

    def _monitor_items(self):
        """``ips`` of a bound MonitorCallback; [] without one (the line is
        then as without a monitor)."""
        mon = getattr(getattr(self, "model", None), "_step_monitor", None)
        fields = getattr(mon, "last_fields", None) if mon is not None else None
        if not fields:
            return []
        return [f"ips: {fields['ips']:.1f}"] if "ips" in fields else []

    def on_batch_end(self, mode, step, logs=None):
        self.steps += 1
        if self.verbose and step % self.log_freq == 0:
            parts = [f"{k}: {_first(v):.4f}" if not isinstance(v, str)
                     else f"{k}: {v}" for k, v in (logs or {}).items()]
            parts.extend(self._monitor_items())
            ips = self.steps / max(time.time() - self.start, 1e-9)
            print(f"[train] epoch {self.epoch} step {step}: "
                  f"{', '.join(parts)} ({ips:.1f} steps/s)")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            print(f"[train] epoch {epoch} done in "
                  f"{time.time() - self.start:.1f}s")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            self.model.save(f"{self.save_dir}/{epoch}")


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        from ..optimizer.lr import LRScheduler as Sched

        opt = getattr(self.model, "_optimizer", None)
        if opt and isinstance(opt._learning_rate, Sched):
            return opt._learning_rate
        return None

    def on_batch_end(self, mode, step, logs=None):
        if mode == "train" and self.by_step:
            s = self._sched()
            if s:
                s.step()

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            s = self._sched()
            if s:
                s.step()


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        self.monitor = monitor
        self.patience = patience
        self.min_delta = min_delta
        self.best = None
        self.wait = 0
        self.mode = "min" if mode in ("auto", "min") else "max"

    def on_epoch_end(self, epoch, logs=None):
        val = (logs or {}).get(self.monitor)
        if val is None:
            return
        val = _first(val)
        improved = (
            self.best is None
            or (self.mode == "min" and val < self.best - self.min_delta)
            or (self.mode == "max" and val > self.best + self.min_delta))
        if improved:
            self.best = val
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


class MonitorCallback(Callback):
    """Host-clock phases of the fit loop (see the module docstring):
    ``phases`` {name: [seconds per batch]}, ``last_fields`` ({"ips": batches
    a second over the last batch's begin to begin}), ``checkpoints`` (the
    checkpoint phases' seconds and results, in order). ``monitor``: an
    object with ``now_us()`` and ``record_phase(name, start_us, end_us)``
    that receives the phases too."""

    def __init__(self, monitor=None, **kwargs):
        self.monitor = monitor
        self.phases = {"data_wait": [], "step": []}
        self.checkpoints = []       # (phase, seconds) / (result, step)
        self.last_fields = {}
        self._prev_end = None
        self._begin = None
        self._prev_begin = None

    def _now_us(self):
        if self.monitor is not None:
            return self.monitor.now_us()
        return time.perf_counter() * 1e6

    def _record(self, name, start, end):
        self.phases[name].append((end - start) / 1e6)
        if self.monitor is not None:
            self.monitor.record_phase(name, start, end)

    def on_begin(self, mode, logs=None):
        if mode == "train":
            self.model._step_monitor = self
            self._prev_end = self._prev_begin = None

    def on_batch_begin(self, mode, step, logs=None):
        if mode != "train":
            return
        now = self._now_us()
        if self._prev_end is not None:
            self._record("data_wait", self._prev_end, now)
        if self._prev_begin is not None:
            self.last_fields = {"ips": 1e6 / max(now - self._prev_begin,
                                                 1e-3)}
        self._begin = self._prev_begin = now

    def on_batch_end(self, mode, step, logs=None):
        if mode != "train" or self._begin is None:
            return
        now = self._now_us()
        self._record("step", self._begin, now)
        self._prev_end = now

    def checkpoint_phase(self, phase, seconds):
        """A checkpoint phase's seconds (``fit`` hands the monitor to its
        ``CheckpointManager``; serialize and commit arrive from the writer
        thread)."""
        self.checkpoints.append((phase, seconds))

    def checkpoint_result(self, ok, step=None):
        self.checkpoints.append(("committed" if ok else "failed", step))

    def on_end(self, mode, logs=None):
        if mode == "train" and getattr(self.model, "_step_monitor",
                                       None) is self:
            self.model._step_monitor = None


class VisualDL(Callback):
    """Scalar logger writing local TSV files (``scalars.tsv`` under
    ``log_dir``: mode, step, name, value); VisualDL itself is external."""

    def __init__(self, log_dir="./log"):
        self.log_dir = log_dir
        self._fh = None

    def on_begin(self, mode, logs=None):
        os.makedirs(self.log_dir, exist_ok=True)
        self._fh = open(f"{self.log_dir}/scalars.tsv", "a")

    def on_batch_end(self, mode, step, logs=None):
        if self._fh:
            for k, v in (logs or {}).items():
                try:
                    self._fh.write(f"{mode}\t{step}\t{k}\t{_first(v)}\n")
                except (TypeError, ValueError):
                    pass

    def on_end(self, mode, logs=None):
        if self._fh:
            self._fh.close()
            self._fh = None
