"""Devices and places — the counterpart of
``paddle_tpu/framework/device.py``.

Every entry point (models, `PagedKVCache`, the predictor, the server) takes
an explicit ``device=`` that defaults to ``"cuda"``. A machine without CUDA
raises instead of silently running the plain PyTorch path on the CPU; the
CPU is used only when the caller asks for it (``device="cpu"``), as the
tests do.

The paddle-style surface (``to_tensor``, the creation ops) puts tensors on
the current place: ``set_device("cpu")`` / ``set_device("gpu:0")`` or a
``Place``, and the card when nothing was set. ``get_place()`` resolves it
through ``resolve_device``, so without CUDA it raises unless the CPU was
asked for. ``CUDAPlace(i)`` is card i; ``TPUPlace`` has no card here and
raises.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "Place", "CPUPlace", "CUDAPlace", "TPUPlace",
           "XPUPlace", "set_device", "get_device", "get_place",
           "device_count", "is_compiled_with_cuda", "is_compiled_with_xpu"]


def resolve_device(device="cuda") -> torch.device:
    """Validate ``device`` and return it as a ``torch.device``.

    Raises RuntimeError for a CUDA device on a machine without one, and
    ValueError for device types the port does not run on."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on CUDA by default and no CUDA device "
                "is available; pass device='cpu' explicitly to run the plain "
                "PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda | cpu)")
    return dev


class Place:
    """A device handle over a ``torch.device``; compares by (type, index)."""

    def __init__(self, device="cuda"):
        self._device = resolve_device(device)

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def platform(self) -> str:
        return "gpu" if self._device.type == "cuda" else "cpu"

    def get_device_id(self) -> int:
        return self._device.index or 0

    def is_gpu_place(self) -> bool:
        return self._device.type == "cuda"

    def is_cpu_place(self) -> bool:
        return self._device.type == "cpu"

    def is_tpu_place(self) -> bool:
        return False

    def __eq__(self, other):
        return isinstance(other, Place) and other._device == self._device

    def __hash__(self):
        return hash(self._device)

    def __repr__(self):
        return f"Place({self.platform}:{self.get_device_id()})"


class CPUPlace(Place):
    def __init__(self):
        super().__init__("cpu")


class CUDAPlace(Place):
    def __init__(self, device_id: int = 0):
        super().__init__(f"cuda:{int(device_id)}")


class TPUPlace(Place):
    def __init__(self, device_id: int = 0):
        raise RuntimeError("paddle_tpu_torch runs on CUDA or the CPU; there "
                           "is no TPU place (use CUDAPlace or CPUPlace)")


XPUPlace = TPUPlace

_current: dict = {"place": None}   # None: the card, resolved at first use


def set_device(device) -> Place:
    """``paddle.set_device``: "cpu", "gpu", "gpu:0", "cuda:0" or a Place."""
    if isinstance(device, Place):
        _current["place"] = device
        return device
    name = str(device)
    plat, _, idx = name.partition(":")
    if plat == "cpu":
        place = CPUPlace()
    elif plat in ("gpu", "cuda"):
        place = CUDAPlace(int(idx or 0))
    else:
        raise ValueError(f"unsupported device {device!r} (cpu | gpu[:i])")
    _current["place"] = place
    return place


def get_place() -> Place:
    """The current place; the card when none was set (raises without CUDA,
    see ``resolve_device``)."""
    if _current["place"] is None:
        return Place("cuda")
    return _current["place"]


def get_device() -> str:
    p = get_place()
    return "cpu" if p.is_cpu_place() else f"gpu:{p.get_device_id()}"


def device_count() -> int:
    return torch.cuda.device_count()


def is_compiled_with_cuda() -> bool:
    return torch.version.cuda is not None


def is_compiled_with_xpu() -> bool:
    return False
