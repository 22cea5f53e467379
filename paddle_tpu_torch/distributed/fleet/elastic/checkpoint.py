"""Preemption-aware autocheckpoint — the counterpart of
``paddle_tpu/distributed/fleet/elastic/checkpoint.py``.

A preemption lands as SIGTERM: the worker saves and exits with
``ELASTIC_EXIT_CODE`` so the launcher restarts it without spending its
crash budget, and training resumes from the saved step with the same
losses. The file is written through ``framework.io_utils.save`` (a
temporary file, fsync and an atomic rename), so a kill during a save
never corrupts the last checkpoint."""
from __future__ import annotations

import os
import signal

from .manager import ELASTIC_EXIT_CODE

__all__ = ["AutoCheckpointer"]


class AutoCheckpointer:
    """Periodic and on-preemption checkpoints of (model, optimizer,
    step)::

        ckpt = AutoCheckpointer(model, opt, path, save_every=50)
        start = ckpt.resume()                       # 0 on a fresh start
        for step in range(start, total):
            loss = train_step(...)
            ckpt.step(step)                         # save point + preemption check

    SIGTERM sets a flag; the next ``step()`` saves and exits with
    ``ELASTIC_EXIT_CODE`` (the handler itself must not serialize state in
    the middle of an update). Only rank 0 writes (the parameters are
    replicated). For ``TrainStep``'s asynchronous checkpoints with
    retention see ``framework.checkpoint.CheckpointManager``."""

    def __init__(self, model, optimizer=None, path="./auto_checkpoint",
                 save_every=0, rank=None, install_signal_handler=True):
        self.model = model
        self.optimizer = optimizer
        self.path = path
        self.save_every = int(save_every)
        if rank is None:
            rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        self.rank = rank
        self.preempted = False
        self._prev_handler = None
        if install_signal_handler:
            self._prev_handler = signal.signal(signal.SIGTERM, self._on_sigterm)

    # ------------------------------------------------------------- signals
    def _on_sigterm(self, signum, frame):
        self.preempted = True

    # ---------------------------------------------------------------- save
    def _ckpt_file(self):
        return os.path.join(self.path, "latest.pdckpt")

    def _inner(self):
        opt = self.optimizer
        return getattr(opt, "_inner_opt", opt)

    def _state(self, step):
        state = {"step": int(step),
                 "model": dict(self.model.state_dict())}
        if self.optimizer is not None:
            inner = self._inner()
            # accumulators by parameter name, the scheduler's state and the
            # step counter
            state["opt"] = inner.state_dict()
            mw = getattr(inner, "_master_weights", None)
            if mw:
                state["opt_master"] = {
                    inner._param_name(p): mw[id(p)].detach().clone()
                    for p in inner._params if id(p) in mw}
        return state

    def save(self, step):
        if self.rank != 0:
            return
        from ....framework.io_utils import save as paddle_save

        os.makedirs(self.path, exist_ok=True)
        paddle_save(self._state(step), self._ckpt_file())

    def resume(self) -> int:
        """Load the latest checkpoint into the model and optimizer; returns
        the step after the saved one (the next to run), or 0 on a fresh
        start."""
        f = self._ckpt_file()
        if not os.path.exists(f):
            return 0
        from ....framework.io_utils import load as paddle_load

        state = paddle_load(f)
        self.model.set_state_dict(state["model"])
        if self.optimizer is not None and "opt" in state:
            inner = self._inner()
            # the loaded values are Tensors; the optimizer takes torch's
            inner.set_state_dict({k: getattr(v, "_value", v)
                                  for k, v in state["opt"].items()})
            if "opt_master" in state:
                by_name = {inner._param_name(p): p for p in inner._params}
                inner._master_weights = {
                    id(by_name[k]): getattr(v, "_value", v).to(
                        by_name[k].device)
                    for k, v in state["opt_master"].items() if k in by_name}
        return int(state["step"]) + 1

    # ---------------------------------------------------------------- step
    def step(self, step_i):
        """Call once per training step, after the optimizer's update."""
        if self.preempted:
            self.save(step_i)
            os._exit(ELASTIC_EXIT_CODE)
        if self.save_every and (step_i + 1) % self.save_every == 0:
            self.save(step_i)
