"""paddle.utils — the counterpart of ``paddle_tpu/utils``: the
VisualDL-role scalar log (``log_writer``) that ``StepMonitor(log_writer=)``
and ``hapi.callbacks.MonitorCallback(log_dir=)`` write."""
from . import log_writer  # noqa: F401
from .log_writer import LogWriter, read_log, scalars  # noqa: F401

__all__ = ["log_writer", "LogWriter", "read_log", "scalars"]
