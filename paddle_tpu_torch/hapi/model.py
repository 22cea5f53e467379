"""``paddle.Model`` — the counterpart of ``paddle_tpu/hapi/model.py``.
Reference: python/paddle/hapi/model.py:1472 (fit), with callbacks and
metrics.

``train_batch`` runs the whole step (forward, backward, clip, update)
through ``jit.TrainStep``: on the card one CUDA graph per batch signature,
captured at its first call and replayed after; on the CPU the same step as
a body. JAX's step leaves its compiled program for the eager loop when the
forward cannot be traced; the port's counterpart is a failed capture
(``jit.graphs.CaptureError``: the forward read a value to the host, say).
``train_batch`` then warns, keeps the state the failed call restored, and
runs that step and every later one eagerly on the same device: the
forward, ``backward()``, ``optimizer.step()``. It reads ``float(loss)``
every step (one host sync a step, as in JAX).

The network is a paddle ``nn.Layer`` (given Tensors) or a torch module
such as the port's GPT (given the torch tensors inside the loader's
Tensors); the loss function gets what the network gives. ``fit`` with
``checkpoint_dir`` checkpoints through ``framework.checkpoint`` (every
``checkpoint_every`` steps, asynchronously; a synchronous flush at the
end and on SIGTERM, which then exits with ``ELASTIC_EXIT_CODE``), and with
``resume="auto"`` resumes from the newest intact checkpoint at the batch
where it stopped: in place, so a live ``TrainStep``'s captured graphs
replay on the restored state.
"""
from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from ..io import DataLoader
from ..nn.layer import Layer
from ..tensor import Tensor
from .callbacks import CallbackList, ProgBarLogger

__all__ = ["Model"]


def _torch_tree(obj):
    """``obj`` with the port's Tensors replaced by their torch tensors."""
    if isinstance(obj, Tensor):
        return obj._value
    if isinstance(obj, (list, tuple)):
        return type(obj)(_torch_tree(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _torch_tree(v) for k, v in obj.items()}
    return obj


def _scalar(loss):
    return float(getattr(loss, "_value", loss).detach().float())


def _numel(p):
    return int(np.prod(tuple(p.shape)))


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self.stop_training = False
        self._train_step = None        # the TrainStep, made on first use
        self._train_step_broken = False   # a failed capture: eager from then
        self._step_monitor = None      # set by MonitorCallback

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        if metrics is not None:
            self._metrics = (metrics if isinstance(metrics, (list, tuple))
                             else [metrics])
        self._train_step = None
        self._train_step_broken = False
        return self

    def _compute_loss(self, outputs, labels):
        if callable(self._loss):
            return self._loss(outputs, labels)
        raise RuntimeError("call prepare(loss=...) first")

    def _inputs(self, inputs):
        """The network's arguments: Tensors for a paddle Layer, their torch
        tensors for a torch module."""
        inputs = list(inputs) if isinstance(inputs, (list, tuple)) else [
            inputs]
        return inputs if isinstance(self.network, Layer) else _torch_tree(
            inputs)

    def _compiled_step(self):
        if self._train_step is None:
            from ..jit.train import TrainStep

            # split_label: the last argument is the label, whatever the
            # forward's signature could bind
            self._train_step = TrainStep(
                self.network, self._compute_loss, self._optimizer,
                return_outputs=bool(self._metrics), split_label=True)
        return self._train_step

    def _update_metrics(self, out, labels):
        for m in self._metrics:
            m.update(m.compute(out, labels))

    def train_batch(self, inputs, labels=None, update=True):
        self.network.train()
        inputs = self._inputs(inputs)
        if not isinstance(self.network, Layer):
            labels = _torch_tree(labels)
        if update and self._optimizer is not None \
                and not self._train_step_broken:
            from ..jit.graphs import CaptureError

            step = self._compiled_step()
            try:
                if self._metrics:
                    loss, out = step(*inputs, labels)
                else:
                    loss, out = step(*inputs, labels), None
            except CaptureError as e:
                warnings.warn(f"Model.fit: the step could not be captured "
                              f"({e}); running it eagerly on "
                              f"{step.device} from now on", RuntimeWarning)
                self._train_step_broken = True
            else:
                self._update_metrics(out, labels)
                return [_scalar(loss)]
        out = self.network(*inputs)
        loss = self._compute_loss(out, labels)
        loss.backward()
        if update:
            self._optimizer.step()
            self._optimizer.clear_grad()
        self._update_metrics(out, labels)
        return [_scalar(loss)]

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        inputs = self._inputs(inputs)
        if not isinstance(self.network, Layer):
            labels = _torch_tree(labels)
        with torch.no_grad():
            out = self.network(*inputs)
            loss = self._compute_loss(out, labels)
            self._update_metrics(out, labels)
        return [_scalar(loss)]

    def predict_batch(self, inputs):
        self.network.eval()
        with torch.no_grad():
            return self.network(*self._inputs(inputs))

    def _checkpoint_provider(self):
        """The CheckpointManager state provider: the TrainStep (made here
        when no step ran yet; making one captures nothing). Its export and
        import read and write the live parameters and accumulators the
        eager path updates too."""
        if self._optimizer is None:
            raise RuntimeError("checkpointing needs prepare(optimizer=...)")
        return self._compiled_step()

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            checkpoint_dir=None, checkpoint_every=0, checkpoint_keep_last=3,
            checkpoint_keep_every=0, resume="auto", **kwargs):
        """Train. With ``checkpoint_dir`` the full training state is
        checkpointed every ``checkpoint_every`` optimizer steps
        (asynchronously), flushed synchronously when fit ends (also after
        ``stop_training``) and on SIGTERM (``PreemptionFlush``: the flush
        lands at the next batch boundary, then ``PreemptionExit`` carries
        ``ELASTIC_EXIT_CODE``); ``resume="auto"`` continues from the newest
        intact checkpoint at the exact next batch, so the losses equal an
        uninterrupted run's."""
        loader = train_data if isinstance(train_data, DataLoader) else \
            DataLoader(train_data, batch_size=batch_size, shuffle=shuffle,
                       drop_last=drop_last, num_workers=num_workers)
        manager, flush = None, None
        start_epoch, skip_steps, global_step = 0, 0, 0
        if checkpoint_dir is not None:
            from ..framework.checkpoint import (CheckpointManager,
                                                PreemptionFlush)

            manager = CheckpointManager(
                checkpoint_dir, keep_last=checkpoint_keep_last,
                keep_every=checkpoint_keep_every)
            flush = PreemptionFlush().install()
            if resume == "auto":
                restored = manager.restore(self._checkpoint_provider())
                if restored is not None:
                    global_step = int(restored)
                    meta = manager.last_restored["meta"].get("fit", {})
                    start_epoch = int(meta.get("epoch", 0))
                    skip_steps = int(meta.get("step_in_epoch", 0))
        cbks = CallbackList(callbacks or [ProgBarLogger(log_freq,
                                                        verbose=verbose)])
        cbks.set_model(self)
        cbks.on_begin("train")
        last_saved = global_step
        fit_pos = (start_epoch, skip_steps)   # next (epoch, step) to run

        def _save(epoch, step_in_epoch, blocking=False):
            nonlocal last_saved
            provider = self._checkpoint_provider()
            manager.monitor = self._step_monitor

            class _FitProvider:
                """The step's state plus where the fit loop was, so a
                resume fast-forwards the loader to the next batch."""

                def export_state(self_inner):
                    snap = provider.export_state()
                    snap["meta"]["fit"] = {"epoch": epoch,
                                           "step_in_epoch": step_in_epoch}
                    return snap

                def import_state(self_inner, state):
                    provider.import_state(state)

            manager.save(_FitProvider(), global_step, blocking=blocking)
            last_saved = global_step

        try:
            for epoch in range(start_epoch, epochs):
                cbks.on_epoch_begin(epoch)
                for m in self._metrics:
                    m.reset()
                logs = {}
                for step, batch in enumerate(loader):
                    if epoch == start_epoch and step < skip_steps:
                        continue   # resumed mid-epoch: consumed batches
                    cbks.on_batch_begin("train", step, None)
                    x, y = batch[0], batch[1] if len(batch) > 1 else None
                    logs = {"loss": self.train_batch(x, y)}
                    for m in self._metrics:
                        names, vals = m.name(), m.accumulate()
                        if not isinstance(vals, (list, tuple)):
                            vals = [vals]
                            names = [names] if isinstance(names, str) \
                                else names
                        logs.update(dict(zip(names, vals)))
                    global_step += 1
                    fit_pos = (epoch, step + 1)
                    cbks.on_batch_end("train", step, logs)
                    if (manager is not None and checkpoint_every
                            and global_step % checkpoint_every == 0):
                        _save(epoch, step + 1)
                    if flush is not None and flush.preempted:
                        # SIGTERM: a synchronous flush of the state after
                        # this step, then the elastic restart code
                        _save(epoch, step + 1, blocking=True)
                        manager.close()
                        from ..framework.checkpoint import PreemptionExit

                        raise PreemptionExit(flush.exit_code())
                    if self.stop_training:
                        break
                if not self.stop_training:
                    fit_pos = (epoch + 1, 0)
                cbks.on_epoch_end(epoch, logs)
                if eval_data is not None and (epoch + 1) % eval_freq == 0:
                    self.evaluate(eval_data, batch_size=batch_size, verbose=0)
                if save_dir is not None and (epoch + 1) % save_freq == 0:
                    self.save(f"{save_dir}/epoch_{epoch}")
                if self.stop_training:
                    break
        except BaseException:
            # an ungraceful exit: drain the pending writes, snapshot nothing
            # (the SIGTERM path above flushed already)
            if manager is not None:
                try:
                    manager.close()
                except Exception:
                    pass
            raise
        finally:
            if flush is not None:
                flush.restore()
        if manager is not None:
            if global_step > last_saved:
                _save(fit_pos[0], fit_pos[1], blocking=True)
            manager.close()
        cbks.on_end("train")

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, **kwargs):
        loader = eval_data if isinstance(eval_data, DataLoader) else \
            DataLoader(eval_data, batch_size=batch_size,
                       num_workers=num_workers)
        for m in self._metrics:
            m.reset()
        losses = []
        for batch in loader:
            x, y = batch[0], batch[1] if len(batch) > 1 else None
            losses.append(self.eval_batch(x, y))
        logs = {"loss": list(np.mean(losses, axis=0)) if losses else []}
        for m in self._metrics:
            names, vals = m.name(), m.accumulate()
            if not isinstance(vals, (list, tuple)):
                vals = [vals]
                names = [names] if isinstance(names, str) else names
            logs.update(dict(zip(names, vals)))
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        loader = test_data if isinstance(test_data, DataLoader) else \
            DataLoader(test_data, batch_size=batch_size,
                       num_workers=num_workers)
        outs = []
        for batch in loader:
            x = batch[0] if isinstance(batch, (list, tuple)) else batch
            outs.append(self.predict_batch(x))
        return outs

    def save(self, path, training=True):
        """``path.pdparams`` (the network's state dict) and, with
        ``training``, ``path.pdopt`` (the optimizer's), by ``paddle.save``."""
        from ..framework.io_utils import save as _save

        _save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            _save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from ..framework.io_utils import load as _load

        state = _load(path + ".pdparams")
        if isinstance(self.network, Layer):
            self.network.set_state_dict(state)
        else:
            with torch.no_grad():
                live = self.network.state_dict(keep_vars=True)
                for k, v in _torch_tree(state).items():
                    live[k].copy_(v)
        if (not reset_optimizer and self._optimizer is not None
                and os.path.exists(path + ".pdopt")):
            self._optimizer.set_state_dict(_torch_tree(
                _load(path + ".pdopt")))

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        params = list(self.network.parameters())
        n_params = sum(_numel(p) for p in params)
        trainable = sum(_numel(p) for p in params
                        if getattr(p, "requires_grad", None)
                        or getattr(p, "stop_gradient", True) is False)
        print(f"Total params: {n_params}")
        print(f"Trainable params: {trainable}")
        return {"total_params": n_params, "trainable_params": trainable}
