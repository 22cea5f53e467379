"""Elastic training — the counterpart of
``paddle_tpu/distributed/fleet/elastic``: the TTL node registry and scale
decisions over the launcher's store (``ElasticManager``, ``parse_np``),
and the preemption-aware ``AutoCheckpointer`` (SIGTERM -> save -> exit
``ELASTIC_EXIT_CODE``, which the launcher restarts for free). The
``CheckpointManager``-era hooks (``PreemptionFlush``, ``PreemptionExit``)
of ``framework.checkpoint`` are re-exported, as in JAX."""
from .manager import (  # noqa: F401
    ELASTIC_AUTO_PARALLEL_EXIT_CODE, ELASTIC_EXIT_CODE, ElasticManager,
    ElasticStatus, parse_np,
)
from .checkpoint import AutoCheckpointer  # noqa: F401


def __getattr__(name):
    # framework.checkpoint imports the exit code from here: its own names
    # are looked up when asked for
    if name in ("PreemptionExit", "PreemptionFlush"):
        from ....framework import checkpoint

        return getattr(checkpoint, name)
    raise AttributeError(name)
