"""``paddle.distributed.io`` — the counterpart of
``paddle_tpu/distributed/io.py`` (Paddle ``io.py``: ``save_persistables``,
``load_persistables``, ``is_persistable``), as it is. The persistable set
is the layer's state dict, saved and loaded through ``paddle.save`` /
``paddle.load``; the executor argument is accepted and not read, and a
``Layer`` stands where Paddle takes a Program."""
import os

from ..nn.layer import Layer


def is_persistable(var):
    """Reference io.py:352. Parameters and registered buffers persist."""
    if var is None:
        return False
    if getattr(var, "persistable", None) is not None:
        return bool(var.persistable)
    return hasattr(var, "trainable")  # Parameter


def _require_layer(main_program, who):
    if isinstance(main_program, Layer):
        return main_program
    raise ValueError(
        f"{who}: there is no Program here — pass the Layer whose state "
        "should be saved/loaded in the main_program slot (the persistable "
        "set is exactly layer.state_dict())")


def save_persistables(executor, dirname, main_program=None, filename=None):
    """Reference io.py:387. `executor` is accepted for signature parity."""
    from ..framework import io_utils

    layer = _require_layer(main_program, "save_persistables")
    path = os.path.join(dirname, filename or "persistables.pdparams")
    os.makedirs(dirname, exist_ok=True)
    io_utils.save(layer.state_dict(), path)
    return path


def load_persistables(executor, dirname, main_program=None, filename=None):
    """Reference io.py:127."""
    from ..framework import io_utils

    layer = _require_layer(main_program, "load_persistables")
    path = os.path.join(dirname, filename or "persistables.pdparams")
    layer.set_state_dict(io_utils.load(path))
    return layer
