"""``paddle.jit`` — the counterpart of ``paddle_tpu/jit/__init__.py``
(``to_static`` / ``StaticFunction``, ``save``, ``load``,
``TranslatedLayer``). Reference: python/paddle/jit/api.py.

* ``to_static(fn or layer)``: on the card the port's compile unit, one
  CUDA graph per input signature (``jit.fingerprint``, the training flag
  and the parameters' addresses), captured at its first call through
  ``jit.graphs`` and replayed after; its inputs are copied into static
  buffers, its outputs copied out of the graph's. A call that needs
  autograd (grad enabled and a parameter or input that requires it) runs
  eagerly: ``jit.TrainStep`` is the compile unit of training steps. On the
  CPU every call is eager, and ``enable_to_static(False)`` makes every call
  eager everywhere.
* ``save(layer, path, input_spec)`` writes JAX's three files:
  ``path.pdiparams.npz`` (the weights as numpy, bfloat16 as uint16 bits),
  ``path.pdmodel.meta`` (a pickled dict) and, with ``input_spec``,
  ``path.pdmodel``: a ``torch.export`` (``strict=False``) of the eval
  forward as a function of (weights, inputs), so the weights are stored
  once. ``None`` dims of an ``InputSpec`` become ``torch.export.Dim``s:
  the program serves any batch, as JAX's symbolic dims make its export
  batch-polymorphic. The flash forward is the custom op
  ``paddle_tpu_torch::flash_fwd`` (``ops.flash_attention``), so the program
  holds the op, not one backend's body: loaded on the card it launches the
  kernel, on the CPU it runs the plain version, wherever it was exported.
* ``load(path)`` gives a ``TranslatedLayer`` that runs the program without
  the model's class, on the current place (``torch.export.passes.
  move_to_device_pass``). A weights-only save loads too; calling it raises,
  as in JAX.
"""
from __future__ import annotations

import functools
import io
import os
import pickle

import numpy as np
import torch

from ..framework import device as _device
from ..framework.checkpoint import _readback, _storable
from ..nn.layer import Layer
from ..tensor import Tensor
from .fingerprint import aval_fingerprint, dtype_name, flatten, unflatten
from .graphs import StaticBuffers, first_run_then_capture
from .train import _leaf_spec, _map_tensors, _unwrapped

__all__ = ["to_static", "not_to_static", "ignore_module", "save", "load",
           "enable_to_static", "StaticFunction", "TranslatedLayer",
           "set_verbosity", "set_code_level"]

_to_static_enabled = True


def enable_to_static(flag: bool):
    global _to_static_enabled
    _to_static_enabled = bool(flag)


def not_to_static(fn=None):
    if fn is None:
        return lambda f: f
    fn._jit_skip = True
    return fn


def ignore_module(modules):
    return None


class _Program:
    """One input signature's capture: the static input buffer and the
    arguments' structure."""

    def __init__(self, leaves, structure, device):
        self.inputs = StaticBuffers(
            {f"a{i}": _leaf_spec(x) for i, x in enumerate(leaves)}, device)
        self.structure = structure
        self.n = len(leaves)
        self.capture = None

    def args(self):
        return unflatten(self.structure,
                         [self.inputs.dev[f"a{i}"] for i in range(self.n)])


class StaticFunction:
    """A function or a Layer (its forward, or a bound method) compiled as
    ``to_static`` says (module docstring). ``captures`` counts the graphs
    captured, ``replays`` the replays run."""

    def __init__(self, function, input_spec=None, build_strategy=None,
                 backend=None, full_graph=True):
        self._raw_fn = function
        self._layer = None
        if isinstance(function, torch.nn.Module):
            self._layer = function
        elif isinstance(getattr(function, "__self__", None), torch.nn.Module):
            self._layer = function.__self__
        self._input_spec = input_spec
        self._programs: dict = {}
        self._pool = None
        self.captures = 0
        self.replays = 0
        functools.update_wrapper(self, getattr(function, "forward", function))

    @property
    def layer(self):
        return self._layer

    def _params(self):
        return [] if self._layer is None else list(
            torch.nn.Module.parameters(self._layer))

    def _device(self, leaves):
        for t in self._params() + leaves:
            if isinstance(t, torch.Tensor):
                return t.device
        return torch.device("cpu")

    def _needs_autograd(self, leaves):
        return torch.is_grad_enabled() and any(
            t.requires_grad for t in self._params() + leaves
            if isinstance(t, torch.Tensor))

    def _call(self, args, kwargs):
        """The function on torch-level (args, kwargs); a paddle Layer gets
        Tensors and its Tensor outputs are unwrapped."""
        if isinstance(self._layer, Layer):
            args, kwargs = _map_tensors(Tensor, (args, kwargs))
        return _unwrapped(self._raw_fn(*args, **kwargs))

    def __call__(self, *args, **kwargs):
        paddle = any(isinstance(x, Tensor) for x in flatten((args, kwargs))[0])
        args, kwargs = _unwrapped((args, kwargs))
        leaves, structure = flatten((tuple(args), dict(kwargs)))
        dev = self._device(leaves)
        if (not _to_static_enabled or dev.type != "cuda"
                or self._needs_autograd(leaves)):
            out = self._call(args, kwargs)
        else:
            out = self._replayed(leaves, structure, dev)
        return _map_tensors(Tensor, out) if paddle or isinstance(
            self._layer, Layer) else out

    def _replayed(self, leaves, structure, dev):
        training = getattr(self._layer, "training", False)
        key = (aval_fingerprint(leaves), training,
               tuple(p.data_ptr() for p in self._params()))
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = _Program(leaves, structure, dev)
        prog.inputs.fill({f"a{i}": x for i, x in enumerate(leaves)})

        def body():
            a, kw = prog.args()
            return self._call(a, kw)

        if prog.capture is None:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            out, prog.capture = first_run_then_capture(dev, body, body,
                                                       self._pool)
            self.captures += 1
            return out
        prog.capture.replay()
        self.replays += 1
        return _map_tensors(torch.Tensor.clone, prog.capture.result)

    # reference API surface
    def concrete_program_specify_input_spec(self, *a, **k):
        return None

    @property
    def code(self):
        import inspect

        return inspect.getsource(getattr(self._raw_fn, "forward",
                                         self._raw_fn))


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, **kwargs):
    """Reference: python/paddle/jit/api.py:197; ``backend`` is accepted."""

    def decorate(fn):
        return StaticFunction(fn, input_spec, build_strategy, backend)

    if function is None:
        return decorate
    return decorate(function)


# ------------------------------------------------------------ save / load
class _Forward(torch.nn.Module):
    """The eval forward of ``layer`` as a function of (weights, inputs): the
    layer is held outside the module tree, so the export lifts no weight;
    ``torch.func.functional_call`` puts the given ones in."""

    def __init__(self, layer):
        super().__init__()
        self.__dict__["_layer"] = layer

    def forward(self, state, inputs):
        layer = self.__dict__["_layer"]
        if isinstance(layer, Layer):
            inputs = tuple(Tensor(x) for x in inputs)
        return _unwrapped(torch.func.functional_call(layer, state, inputs))


def _example(spec, device, dims):
    """(example tensor, its dynamic-shape dict) for one input spec: a
    ``None`` (or negative) dim becomes a new ``Dim`` ``d<n>`` traced at 2."""
    if isinstance(spec, Tensor):
        return spec._value.to(device), None
    if isinstance(spec, torch.Tensor):
        return spec.to(device), None
    if isinstance(spec, np.ndarray):
        return torch.from_numpy(spec).to(device), None
    shape, dyn = [], {}
    for i, d in enumerate(spec.shape):
        if d is None or d < 0:
            dyn[i] = torch.export.Dim(f"d{len(dims)}", min=1,
                                      max=torch.iinfo(torch.int32).max // 2)
            dims.append(dyn[i])
            shape.append(2)
        else:
            shape.append(int(d))
    return torch.zeros(shape, dtype=spec.dtype, device=device), dyn or None


def _export(layer, state, input_spec):
    """``torch.export`` of layer's eval forward over (state, inputs)."""
    device = next(iter(state.values())).device if state else \
        torch.device("cpu")
    dims: list = []
    examples = [_example(s, device, dims) for s in input_spec]
    inputs = tuple(x for x, _ in examples)
    dynamic = ({k: None for k in state}, tuple(d for _, d in examples))
    with torch.no_grad():
        return torch.export.export(_Forward(layer), (state, inputs),
                                   dynamic_shapes=dynamic, strict=False)


def save(layer, path, input_spec=None, **configs):
    """``paddle.jit.save``: the weights, the meta and, with ``input_spec``
    (``static.InputSpec``s, example Tensors or arrays), the exported eval
    forward (module docstring). Without it the save is weights-only."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if isinstance(layer, StaticFunction):
        if input_spec is None:
            input_spec = layer._input_spec
        layer = layer.layer
    state = {k: v.detach() for k, v in
             torch.nn.Module.state_dict(layer).items()}
    np.savez(path + ".pdiparams.npz",
             **{k: _storable(v.cpu()) for k, v in state.items()})
    meta = {"class_name": type(layer).__name__,
            "state_keys": list(state),
            "state_dtypes": {k: dtype_name(v.dtype) for k, v in state.items()},
            "has_program": False, "format": "torch.export"}
    if input_spec is not None:
        was_training = layer.training
        layer.eval()
        try:
            ep = _export(layer, state, input_spec)
        finally:
            if was_training:
                layer.train()
        ep.example_inputs = None        # they would hold the weights again
        buf = io.BytesIO()
        torch.export.save(ep, buf)
        blob = buf.getvalue()
        with open(path + ".pdmodel", "wb") as f:
            f.write(blob)
        meta["has_program"] = True
        meta["program_nbytes"] = len(blob)
        meta["input_count"] = len(input_spec)
    with open(path + ".pdmodel.meta", "wb") as f:
        pickle.dump(meta, f)


class TranslatedLayer(Layer):
    """A loaded ``jit.save`` artifact: its weights (Tensors on the current
    place) and, when it has one, the exported program, run by ``forward``
    without the model's class. Reference: python/paddle/jit/
    translated_layer.py."""

    def __init__(self, state, meta, program=None):
        super().__init__()
        self.__dict__["_state"] = state         # name -> torch tensor
        self.__dict__["_meta"] = meta
        self.__dict__["_program"] = program     # the program's callable

    def forward(self, *args):
        if self._program is None:
            raise RuntimeError(
                "this checkpoint was saved without a serialized program "
                "(weights only); rebuild the model class and set_state_dict, "
                "or re-save with input_spec so paddle_tpu_torch.jit.save "
                "exports one")
        dev = next(iter(self._state.values())).device if self._state \
            else _device.get_place().device
        raw = tuple((a._value if isinstance(a, Tensor) else a
                     if isinstance(a, torch.Tensor)
                     else torch.as_tensor(np.asarray(a))).to(dev)
                    for a in args)
        with torch.no_grad():
            out = self._program(self._state, raw)
        return _map_tensors(Tensor, out)

    def state_dict(self, *a, **k):
        return {n: Tensor(t) for n, t in self._state.items()}

    @property
    def program_bytes(self):
        return self._meta.get("program_nbytes")


def load(path, device=None, **configs):
    """``paddle.jit.load``: a ``TranslatedLayer`` on ``device`` (a port
    extension; None: the current place)."""
    with open(path + ".pdmodel.meta", "rb") as f:
        meta = pickle.load(f)
    dev = (_device.get_place().device if device is None
           else _device.resolve_device(device))
    dtypes = meta.get("state_dtypes", {})
    with np.load(path + ".pdiparams.npz") as data:
        state = {k: _readback(data[k], dtypes.get(k, str(data[k].dtype)))
                 .to(dev) for k in data.files}
    program = None
    if meta.get("has_program") and os.path.exists(path + ".pdmodel"):
        with open(path + ".pdmodel", "rb") as f:
            ep = torch.export.load(io.BytesIO(f.read()))
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(ep, dev).module()
    return TranslatedLayer(state, meta, program)


_verbosity = 0
_code_level = 0


def set_verbosity(level=0, also_to_stdout=False):
    """Kept for script parity: there is no source translator to log."""
    global _verbosity
    _verbosity = int(level)


def set_code_level(level=100, also_to_stdout=False):
    """Kept for script parity: there is no transformed code to print."""
    global _code_level
    _code_level = int(level)
