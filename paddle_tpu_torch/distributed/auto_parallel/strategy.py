"""``dist.Strategy`` — the auto-parallel config tree, the counterpart of
``paddle_tpu/distributed/auto_parallel/strategy.py`` (Paddle
``auto_parallel/api.py:1973``).

Five groups with JAX's fields, defaults and errors: ``sharding`` (ZeRO),
``amp``, ``pipeline``, ``gradient_merge`` and ``fused_passes``. What
``DistModel`` reads: ``sharding.enable`` / ``stage`` (the ZeRO stage laid
over an optimizer that is not sharded yet), ``amp`` (the ``auto_cast`` its
steps run under), ``pipeline.schedule_mode`` / ``accumulate_steps`` /
``vpp_degree``. ``gradient_merge`` and ``fused_passes`` are recorded and
not read, as in JAX.
"""
from __future__ import annotations

__all__ = ["Strategy", "ShardingConfig", "AMPConfig", "PipelineConfig",
           "GradientMergeConfig", "FusedPassesConfig"]


class _ConfigGroup:
    _fields: dict = {}

    def __init__(self, **kwargs):
        for k, v in type(self)._fields.items():
            setattr(self, k, kwargs.pop(k, v))
        if kwargs:
            raise ValueError(
                f"unknown {type(self).__name__} options: {sorted(kwargs)}")

    def to_dict(self):
        return {k: getattr(self, k) for k in type(self)._fields}

    def __repr__(self):
        body = ", ".join(f"{k}={getattr(self, k)!r}" for k in type(self)._fields)
        return f"{type(self).__name__}({body})"


class ShardingConfig(_ConfigGroup):
    """ZeRO: ``stage`` in {0, 1, 2, 3}; ``degree`` -1 is the whole dp
    axis."""

    _fields = {"enable": False, "stage": 1, "degree": -1}


class AMPConfig(_ConfigGroup):
    """Mixed precision: ``level`` "o1" or "o2", ``dtype`` "bfloat16" or
    "float16"."""

    _fields = {
        "enable": False, "dtype": "bfloat16", "level": "o2",
        "init_loss_scaling": 32768.0, "use_master_grad": False,
        "custom_black_list": (), "custom_white_list": (),
    }


class PipelineConfig(_ConfigGroup):
    """``schedule_mode`` one of "1F1B", "FThenB", "Eager1F1B", "ZB-H1"
    (the pipeline's aliases too); ``vpp_degree`` > 1 interleaves
    ``p * vpp`` chunks round-robin under 1F1B."""

    _fields = {
        "enable": False, "schedule_mode": "1F1B", "micro_batch_size": 1,
        "accumulate_steps": 1, "vpp_degree": 1,
    }


class GradientMergeConfig(_ConfigGroup):
    _fields = {"enable": False, "k_steps": 1, "avg": True}


class FusedPassesConfig(_ConfigGroup):
    """Recorded, not read (JAX leaves fusion to XLA; the port's kernels
    are fused by hand)."""

    _fields = {"enable": False, "fused_passes_list": ()}


class Strategy:
    """The groups ``sharding`` / ``amp`` / ``pipeline`` /
    ``gradient_merge`` / ``fused_passes``, each from its dict in
    ``config``; an unknown group or option raises ``ValueError``."""

    def __init__(self, config: dict | None = None):
        config = dict(config or {})
        self.sharding = ShardingConfig(**config.pop("sharding", {}))
        self.amp = AMPConfig(**config.pop("amp", {}))
        self.pipeline = PipelineConfig(**config.pop("pipeline", {}))
        self.gradient_merge = GradientMergeConfig(
            **config.pop("gradient_merge", {}))
        self.fused_passes = FusedPassesConfig(**config.pop("fused_passes", {}))
        if config:
            raise ValueError(f"unknown Strategy groups: {sorted(config)}")

    def __repr__(self):
        return (f"Strategy(sharding={self.sharding}, amp={self.amp}, "
                f"pipeline={self.pipeline}, "
                f"gradient_merge={self.gradient_merge})")
