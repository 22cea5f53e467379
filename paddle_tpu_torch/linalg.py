"""``paddle.linalg`` — the counterpart of ``paddle_tpu/linalg.py``: every op
of ``ops.linalg`` and paddle's ``inv`` alias."""
from .ops.linalg import *  # noqa: F401,F403
from .ops.linalg import __all__ as _ops_all
from .ops.linalg import inverse as inv  # noqa: F401

__all__ = sorted(set(_ops_all) | {"inv"})
