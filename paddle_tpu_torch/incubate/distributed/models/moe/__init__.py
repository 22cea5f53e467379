"""MoE, on one device or expert-parallel over a group (counterpart of
``paddle_tpu/incubate/distributed/models/moe``)."""
from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate
from .moe_layer import MoELayer

__all__ = ["MoELayer", "BaseGate", "NaiveGate", "GShardGate", "SwitchGate"]
