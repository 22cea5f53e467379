"""``paddle.inference``'s load-and-serve predictor — the counterpart of
``Config``, ``Predictor``, ``create_predictor`` and ``_Handle`` in
``paddle_tpu/inference/__init__.py``. Reference: paddle/fluid/inference/
api/analysis_predictor.cc and python/paddle/inference/wrapper.py.

The predictor runs a ``jit.save`` artifact through ``jit.load`` (the
exported program, without the model's class), with the weights resident
on the device across ``run()`` calls: on the card unless the config says
``disable_gpu()``. Inputs arrive as host arrays and outputs leave as host
arrays, as in the reference's copy_from_cpu / copy_to_cpu protocol.
"""
from __future__ import annotations

import numpy as np

from ..jit.fingerprint import flatten

__all__ = ["Config", "Predictor", "create_predictor"]


class Config:
    """Model path and execution knobs (``Config("path/model")``: the side
    files are derived from the path)."""

    def __init__(self, prog_file=None, params_file=None):
        self._model_path = prog_file
        self._device = None     # None: the current place (the card)
        self._memory_optim = True

    def set_model(self, path):
        self._model_path = path

    def model_path(self):
        return self._model_path

    def disable_gpu(self):
        self._device = "cpu"

    def enable_memory_optim(self, flag=True):
        self._memory_optim = flag

    def switch_use_feed_fetch_ops(self, flag):  # accepted, nothing to switch
        pass

    def enable_custom_device(self, device_type, device_id=0):
        self._device = f"{device_type}:{device_id}"


class _Handle:
    """An input or output handle (the reference's ZeroCopyTensor role)."""

    def __init__(self):
        self._array = None

    def copy_from_cpu(self, arr):
        self._array = np.ascontiguousarray(arr)

    def copy_to_cpu(self):
        return self._array

    def reshape(self, shape):
        if self._array is not None:
            self._array = self._array.reshape(shape)


class Predictor:
    def __init__(self, config: Config):
        from ..jit import load as jit_load

        self._config = config
        self._layer = jit_load(config.model_path(), device=config._device)
        if self._layer._program is None:
            raise ValueError(
                f"{config.model_path()!r} has no serialized program; "
                "re-save the model with paddle.jit.save(layer, path, "
                "input_spec=[...])")
        self._inputs = [_Handle() for _ in
                        range(self._layer._meta["input_count"])]
        self._outputs: list[_Handle] = []

    def get_input_names(self):
        return [f"x{i}" for i in range(len(self._inputs))]

    def get_input_handle(self, name):
        return self._inputs[int(name[1:]) if name.startswith("x")
                            else int(name)]

    def get_output_names(self):
        return [f"out{i}" for i in range(len(self._outputs))]

    def get_output_handle(self, name):
        return self._outputs[int(name[3:]) if name.startswith("out")
                             else int(name)]

    def run(self, inputs=None):
        """Host arrays in, host arrays out (``run([x])``), or the handle
        protocol: ``copy_from_cpu`` -> ``run()`` -> ``copy_to_cpu``."""
        if inputs is not None:
            arrays = [np.asarray(x) for x in inputs]
        else:
            arrays = [h._array for h in self._inputs]
            if any(a is None for a in arrays):
                raise ValueError("input handles not filled; call "
                                 "copy_from_cpu first")
        leaves, _ = flatten(self._layer(*arrays))
        results = [t.numpy() for t in leaves]
        self._outputs = []
        for r in results:
            h = _Handle()
            h.copy_from_cpu(r)
            self._outputs.append(h)
        return results


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)
