"""hapi callbacks — the counterpart of ``paddle_tpu/hapi/callbacks.py``.
Reference: python/paddle/hapi/callbacks.py.

``MonitorCallback`` binds an ``observability.StepMonitor`` to the model's
``TrainStep``, as JAX's does; ``ProgBarLogger`` shows the bound monitor's
``ips`` / ``tok/s`` / ``mfu`` fields.
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
        """Live StepMonitor fields (ips / tokens per second / MFU) when a
        MonitorCallback bound one to this model; [] otherwise (the line is
        then as without a monitor)."""
        mon = getattr(getattr(self, "model", None), "_step_monitor", None)
        fields = getattr(mon, "last_fields", None) if mon is not None else None
        if not fields:
            return []
        items = []
        if "ips" in fields:
            items.append(f"ips: {fields['ips']:.1f}")
        if "tokens_per_sec" in fields:
            items.append(f"tok/s: {fields['tokens_per_sec']:.0f}")
        if "mfu" in fields:
            items.append(f"mfu: {100.0 * fields['mfu']:.1f}%")
        return items

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
    """Binds an ``observability.StepMonitor`` to ``Model.fit`` (JAX
    ``hapi/callbacks.py:168-260``).

    The monitor attaches to the model's ``TrainStep`` (made on the first
    ``train_batch``), so per-step wall time, live MFU, the recompilation
    sentinel and numerics anomalies all run inside the step itself; this
    callback adds the phases only the fit loop sees — ``data_wait`` (the
    loader's gap between batches) and ``callbacks`` (host work after the
    step) — on the same trace timeline.

    ``log_dir=`` opens a ``utils.log_writer.LogWriter`` for the scalar
    series (``train/loss``, ``train/ips``, ``train/mfu``, ...);
    ``log_writer=`` shares one, ``monitor=`` brings a configured
    ``StepMonitor``; other keyword arguments go to the ``StepMonitor``
    (``samples_per_step=...`` makes the ips gauge live). ``fit`` hands
    ``model._step_monitor`` to its ``CheckpointManager``, whose snapshot,
    serialize, commit and restore timings land in the monitor.
    """

    def __init__(self, monitor=None, log_writer=None, log_dir=None,
                 **monitor_kwargs):
        self.monitor = monitor
        self._log_writer = log_writer
        self._log_dir = log_dir
        self._monitor_kwargs = monitor_kwargs
        self._own_writer = None
        self._bound = None
        self._prev_end_us = None

    def on_begin(self, mode, logs=None):
        if mode != "train":
            return
        if self.monitor is None:
            from ..observability.training import StepMonitor

            writer = self._log_writer
            if writer is None and self._log_dir:
                from ..utils.log_writer import LogWriter

                writer = self._own_writer = LogWriter(self._log_dir)
            self.monitor = StepMonitor(log_writer=writer,
                                       **self._monitor_kwargs)
        elif self._log_writer is not None and self.monitor.log_writer is None:
            self.monitor.log_writer = self._log_writer
        self.model._step_monitor = self.monitor

    def _try_bind(self):
        """The TrainStep exists once ``prepare`` and the first batch made
        it; keep trying until it does (or the model took the eager
        route)."""
        model = self.model
        step = getattr(model, "_train_step", None)
        if (step is None and getattr(model, "_optimizer", None) is not None
                and not getattr(model, "_train_step_broken", False)
                and hasattr(model, "_compiled_step")):
            try:
                step = model._compiled_step()
            except Exception:
                step = None
        if step is not None and self._bound is not step:
            self.monitor.bind(step)
            self._bound = step

    def on_batch_begin(self, mode, step, logs=None):
        if mode != "train" or self.monitor is None:
            return
        self._try_bind()
        now = self.monitor.now_us()
        if self._prev_end_us is not None:
            self.monitor.record_phase("data_wait", self._prev_end_us, now)

    def on_batch_end(self, mode, step, logs=None):
        if mode != "train" or self.monitor is None:
            return
        self._try_bind()
        now = self.monitor.now_us()
        step_end = self.monitor.last_step_end_us
        if step_end is not None and step_end <= now:
            self.monitor.record_phase("callbacks", step_end, now)
        self._prev_end_us = now

    def on_end(self, mode, logs=None):
        if mode != "train":
            return
        if self.monitor is not None and self._bound is not None:
            self.monitor.detach(self._bound)
            self._bound = None
        if self._own_writer is not None:
            self._own_writer.close()
            self._own_writer = None


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
