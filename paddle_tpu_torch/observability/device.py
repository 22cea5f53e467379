"""Device introspection for the telemetry — the CUDA counterpart of
``paddle_tpu/observability/xla.py``, under the same names.

* ``device_peak_flops`` — the card's dense bf16 peak, the denominator of
  MFU, keyed by ``torch.cuda.get_device_name``; ``None`` for a CPU device or
  a card the table does not hold, so MFU is absent rather than made up.
* ``cost_flops`` — FLOPs of one run of a captured step program: the count
  ``StepRunner`` keeps per program after one body run under
  ``torch.utils.flop_counter`` (aten products only: the hand-written
  attention kernels are not counted); 0.0 when none was taken.
* ``memory_stats`` — ``paddle_tpu_torch.device.memory_stats`` flattened to
  the ints the telemetry reads; ``{}`` on the CPU.
* ``device_interconnect_bandwidth`` — the card's one-way NVLink bytes/s
  from the published specification (JAX's ``device_ici_bandwidth``), the
  denominator of the comms lint's ``comms-over-budget``; ``None`` off the
  table.

Nothing here raises: an introspection surface a device does not implement
yields ``None`` / ``0.0`` / ``{}``.
"""
from __future__ import annotations

__all__ = ["cost_flops", "device_peak_flops", "memory_stats",
           "PEAK_BF16_FLOPS", "device_interconnect_bandwidth",
           "INTERCONNECT_BYTES_PER_S"]

# Dense bf16 tensor-core peak FLOP/s by device name prefix (NVIDIA's data
# sheet; the SXM H100, which ``torch.cuda.get_device_name`` calls "NVIDIA
# H100 80GB HBM3", at its full 700 W limit).
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


def _device_name(device):
    if isinstance(device, str) and not device.startswith(("cuda", "cpu")):
        return device
    import torch

    try:
        dev = torch.device(device)
    except (TypeError, RuntimeError):
        return getattr(device, "name", "") or ""
    if dev.type != "cuda" or not torch.cuda.is_available():
        return ""
    return torch.cuda.get_device_name(dev)


def device_peak_flops(device) -> float | None:
    """Dense bf16 peak FLOP/s of ``device`` (a ``torch.device``, a device
    string, or a card name), or None when unknown."""
    try:
        name = _device_name(device)
    except Exception:
        return None
    for prefix, peak in PEAK_BF16_FLOPS.items():
        if name.startswith(prefix):
            return peak
    return None


# NVLink bandwidth one card sends at, in bytes/s, by device name prefix: a
# published specification, not a measurement (NVIDIA's H100 SXM data sheet:
# fourth-generation NVLink, 18 links, 900 GB/s per GPU, which counts both
# directions; 450 GB/s each way). The comms lint divides the bytes one card
# PUTS on the wire per tick (analysis/comms.py ``bytes_on_wire``, ring
# formulas, per sending card) by it, so the one-way figure is the matching
# denominator: the aggregate would halve every wire time.
INTERCONNECT_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 450e9,
}


def device_interconnect_bandwidth(device) -> float | None:
    """One-way NVLink bytes/s of ``device`` (a ``torch.device``, a device
    string, or a card name), or None for the CPU and any card the table
    does not name — the comms budget rule then stays silent rather than
    invent a number, as JAX's does off the TPU."""
    try:
        name = _device_name(device)
    except Exception:
        return None
    for prefix, bw in INTERCONNECT_BYTES_PER_S.items():
        if name.startswith(prefix):
            return bw
    return None


def cost_flops(runner, program="step") -> float:
    """FLOPs of one run of ``program`` of a ``jit.graphs.StepRunner`` (0.0
    until a run counted them: ``run(program, count_flops=True)``)."""
    try:
        return float(runner.flops.get(program, 0.0))
    except Exception:
        return 0.0


_MEM_FIELDS = {
    "allocated_bytes": "allocated_bytes.all.current",
    "peak_bytes": "allocated_bytes.all.peak",
    "reserved_bytes": "reserved_bytes.all.current",
    "reserved_peak_bytes": "reserved_bytes.all.peak",
    "num_alloc_retries": "num_alloc_retries",
    "num_ooms": "num_ooms",
}


def memory_stats(device=None) -> dict:
    """The allocator's statistics (``paddle_tpu_torch.device.memory_stats``)
    flattened to ints: allocated / peak / reserved bytes and the retry and
    OOM counts. ``{}`` without a card."""
    from .. import device as _device

    try:
        st = _device.memory_stats(device)
    except Exception:
        return {}
    return {k: int(st.get(v, 0)) for k, v in _MEM_FIELDS.items()} if st \
        else {}
