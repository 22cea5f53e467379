"""AMP — the counterpart of ``paddle_tpu/amp/__init__.py``: ``decorate``
(O2), ``auto_cast`` (O1), ``GradScaler`` and the numerics helpers.

* ``decorate(level="O2")`` casts a model's parameters to bf16 or f16 and
  turns on the optimizers' f32 master weights (``multi_precision``). As in
  the JAX package (``amp/__init__.py:84-93``) only the port's batch-norm
  layers (``nn._BatchNormBase``) and ``LayerNorm`` keep their dtype, so
  RMSNorm weights go to the amp dtype too.
* ``auto_cast(level="O1")`` casts by op NAME, as the JAX package's
  dispatch hook does (``paddle_tpu/ops/__init__.py:39-66``): a black-listed
  op runs in f32, a white-listed one in the amp dtype, any other in its
  inputs' dtypes; ``custom_white_list`` takes ops off the black list. The
  lists are copies of JAX's (``WHITE_LIST`` / ``BLACK_LIST``), not
  ``torch.autocast``'s: the port's ops call ``_amp_cast(name, ...)`` with
  their JAX names at the seams where the JAX package dispatches them
  (``linear`` in the fleet linears; ``lm_head_tied``, on neither list, in
  GPT's tied head; ``exp``, ``sum``, ``log`` in ``ParallelCrossEntropy``;
  ``mean`` in the loss). The cast happens inside autograd, so each
  gradient comes back in its input's dtype, as ``astype``'s VJP does in
  JAX.
* ``auto_cast(level="O2")`` casts every op of the paddle-style op layer
  (``ops.apply_op``, by the op's name, JAX's single dispatch seam) to the
  amp dtype except the black list, which runs in f32. The ported models
  do not run on the op layer yet: their seams (``_amp_cast``) raise
  ``NotImplementedError`` under O2 until the nn surface moves onto it
  (ROADMAP A).
* ``GradScaler`` is JAX's dynamic loss scaling state machine, eager as
  there (JAX's ``TrainStep`` takes no scaler); found-inf stays a device
  tensor until ``step`` or ``update`` reads it.

The amp state is read when an op runs. A ``jit.TrainStep`` captured under
``auto_cast`` keeps the casts it recorded, and its key does not hold the
amp state (JAX's key does not either: ROADMAP C).
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["auto_cast", "amp_guard", "decorate", "GradScaler",
           "is_auto_cast_enabled", "get_amp_dtype", "get_amp_level",
           "white_list", "black_list", "check_numerics",
           "is_bfloat16_supported", "is_float16_supported"]

_amp_state = {"enable": False, "dtype": torch.bfloat16, "level": "O1",
              "custom_white_list": frozenset(),
              "custom_black_list": frozenset()}

# JAX amp/__init__.py:25-28: ops that are safe in low precision (the matmul
# family) and ops that stay in f32 (softmax / norm / exp family)
WHITE_LIST = {"matmul", "mm", "bmm", "linear", "conv1d", "conv2d", "conv3d",
              "einsum"}
BLACK_LIST = {"exp", "square", "log", "mean", "sum", "cos_sim", "softmax",
              "softmax_with_cross_entropy", "sigmoid_cross_entropy_with_logits",
              "cross_entropy", "layer_norm", "batch_norm"}


def _dtype(dtype) -> torch.dtype:
    d = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    if d not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"amp dtype must be bfloat16, float16 or float32, "
                         f"got {dtype!r}")
    return d


def white_list():
    return WHITE_LIST | _amp_state["custom_white_list"]


def black_list():
    """``custom_white_list`` takes ops off the built-in black list (JAX
    :33-40)."""
    return ((BLACK_LIST - _amp_state["custom_white_list"])
            | _amp_state["custom_black_list"])


def is_auto_cast_enabled():
    return _amp_state["enable"]


def get_amp_dtype():
    return _amp_state["dtype"]


def get_amp_level():
    return _amp_state["level"]


def _op_cast_target(name):
    """The dtype op ``name`` of the op layer runs in under the current amp
    state, or None (its inputs' dtypes): JAX ``_amp_wrap``. O1: black list
    f32, white list the amp dtype; O2: every op but the black list in the
    amp dtype."""
    if not _amp_state["enable"]:
        return None
    if name in black_list():
        return torch.float32
    if _amp_state["level"] == "O2" or name in white_list():
        return _amp_state["dtype"]
    return None


def _cast_target(name):
    """``_op_cast_target`` for the ported models' seams, which cast at O1
    only: under O2 they raise, since O2 casts every op and the models do
    not run on the op layer yet."""
    if _amp_state["enable"] and _amp_state["level"] == "O2":
        raise NotImplementedError(
            f"auto_cast(level='O2') casts the ops of the paddle-style op "
            f"layer; the ported models do not run on it yet (op {name!r}; "
            f"ROADMAP A: the nn surface)")
    return _op_cast_target(name)


def _amp_cast(name, *tensors):
    """``tensors`` as op ``name`` takes them under the current amp state:
    each floating tensor cast to the op's dtype, or all as they are."""
    target = _cast_target(name)
    if target is None:
        return tensors
    return tuple(t.to(target) if isinstance(t, torch.Tensor)
                 and t.is_floating_point() and t.dtype != target else t
                 for t in tensors)


def _snapshot():
    return dict(_amp_state)


@contextlib.contextmanager
def _restored(state):
    """Within: the amp state ``state`` (a ``_snapshot``), the previous one
    after."""
    prev = dict(_amp_state)
    _amp_state.update(state)
    try:
        yield
    finally:
        _amp_state.update(prev)


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """Within: ops cast by name (see the module docstring). Nested blocks
    restore the outer state on exit."""
    if level not in ("O1", "O2"):
        raise NotImplementedError(
            f"auto_cast(level={level!r}): the port casts at O1 and O2")
    with _restored(dict(
            enable=bool(enable), dtype=_dtype(dtype),
            level=level,
            custom_white_list=frozenset(custom_white_list or ()),
            custom_black_list=frozenset(custom_black_list or ()))):
        yield


amp_guard = auto_cast


@torch.no_grad()
def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None, master_grad=False,
             excluded_layers=None):
    """O2: every floating parameter outside the port's batch-norm and
    LayerNorm layers is cast IN PLACE to ``dtype`` (bfloat16 or float16;
    the Parameter objects stay, so an optimizer built before keeps them;
    buffers, such as batch norm's running statistics, stay f32); optimizers
    get
    ``multi_precision`` unless ``master_weight`` is False. O1 leaves the
    parameters as they are, as in the JAX package. Returns the models (and
    optimizers when given)."""
    d = _dtype(dtype)
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        # the layers O2 leaves in their dtype, as JAX's (``nn`` imports
        # this module, so the layers are looked up here)
        from ..nn.layer_conv_norm import LayerNorm, _BatchNormBase

        for m in model_list:
            for layer in m.modules():
                if isinstance(layer, (_BatchNormBase, LayerNorm)):
                    continue
                for p in layer.parameters(recurse=False):
                    if p.is_floating_point():
                        p.data = p.data.to(d)
        if optimizers is not None:
            opts = (optimizers if isinstance(optimizers, (list, tuple))
                    else [optimizers])
            for o in opts:
                o._multi_precision = master_weight is not False
    elif level != "O1":
        raise ValueError(f"level must be 'O1' or 'O2', got {level!r}")
    if optimizers is None:
        return models if single else model_list
    return (models if single else model_list), optimizers


class GradScaler:
    """Dynamic loss scaling (JAX :103-203, reference
    ``python/paddle/amp/grad_scaler.py``): ``scale`` multiplies the loss;
    ``unscale_`` divides an optimizer's gradients once per step and ORs
    found-inf over optimizers (a device tensor: no host read of its own);
    ``step`` unscales, skips the optimizer's step when a gradient is not
    finite (one host read) and calls ``update``; ``update`` halves the
    scale after ``decr_every_n_nan_or_inf`` bad steps (at least 1.0) and
    doubles it after ``incr_every_n_steps`` good ones."""

    def __init__(self, enable=True, init_loss_scaling=65536.0, incr_ratio=2.0,
                 decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False         # or a bool device tensor
        self._unscaled_opts: set = set()

    def scale(self, loss):
        if not self._enable:
            return loss
        return loss * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Divide ``optimizer``'s gradients by the scale, once per step."""
        if not self._enable or id(optimizer) in self._unscaled_opts:
            return
        self._unscaled_opts.add(id(optimizer))
        inv = 1.0 / self._scale
        found = None
        for p in optimizer._params:
            if p.grad is None:
                continue
            p.grad = p.grad * inv
            bad = ~torch.isfinite(p.grad).all()
            found = bad if found is None else found | bad
        if found is not None:
            # OR, do not overwrite: a clean second optimizer must not
            # erase an inf the first one found
            self._found_inf = found | self._found_inf

    def _read_found_inf(self) -> bool:
        return bool(self._found_inf)

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._read_found_inf():
            optimizer.step()
        self.update()

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)

    def update(self):
        if not self._enable:
            return
        if not self._dynamic:
            self._found_inf = False
            self._unscaled_opts.clear()
            return
        if self._read_found_inf():
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False
        self._unscaled_opts.clear()

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio, "incr_count": self._good_steps,
                "decr_count": self._bad_steps}

    def load_state_dict(self, state):
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("incr_count", 0)
        self._bad_steps = state.get("decr_count", 0)


def check_numerics(tensor, op_type="", var_name="", debug_mode=None):
    """(NaN count, Inf count) of ``tensor``; raises FloatingPointError when
    either is not 0 (JAX :206-214). Reads the counts on the host."""
    n_nan = int(torch.isnan(tensor).sum())
    n_inf = int(torch.isinf(tensor).sum())
    if n_nan or n_inf:
        raise FloatingPointError(
            f"check_numerics failed for {op_type}:{var_name}: {n_nan} NaN, "
            f"{n_inf} Inf")
    return n_nan, n_inf


def is_bfloat16_supported(device=None):
    """bf16 runs on the CPU and on a CUDA card of compute capability 8 or
    more (the port's kernels need 9.0)."""
    dev = torch.device(device if device is not None else
                       ("cuda" if torch.cuda.is_available() else "cpu"))
    if dev.type == "cpu":
        return True
    return torch.cuda.get_device_capability(dev)[0] >= 8


def is_float16_supported(device=None):
    """f16 runs on a CUDA card (the flash kernels have f16 forms); the JAX
    package reports it for its accelerator only, and so does the port."""
    dev = torch.device(device if device is not None else
                       ("cuda" if torch.cuda.is_available() else "cpu"))
    return dev.type == "cuda"
