"""nn.functional of the port — the counterpart of
``paddle_tpu/nn/functional``: activations, common (linear, dropout,
embedding, interpolate, ...), convolutions, normalisation, pooling,
losses, the attention dispatcher and the packed attention forms of
``extra``. Each functional runs through the op layer under the JAX op
name (``ops.apply_like``) and returns the kind it is given."""
from .activation import *  # noqa: F401,F403
from .activation import __all__ as _activation
from .common import *  # noqa: F401,F403
from .common import __all__ as _common
from .conv import *  # noqa: F401,F403
from .conv import __all__ as _conv
from .extra import flash_attn_qkvpacked, flash_attn_varlen_qkvpacked
from .flash_attention import (
    flash_attention,
    flash_attn_unpadded,
    flashmask_attention,
    get_last_attention_backend,
    scaled_dot_product_attention,
    sdp_kernel,
)
from .loss import *  # noqa: F401,F403
from .loss import __all__ as _loss
from .norm import *  # noqa: F401,F403
from .norm import __all__ as _norm
from .pooling import *  # noqa: F401,F403
from .pooling import __all__ as _pooling

__all__ = (_activation + _common + _conv + _loss + _norm + _pooling
           + ["flash_attention", "flash_attn_unpadded", "flashmask_attention",
              "flash_attn_qkvpacked", "flash_attn_varlen_qkvpacked",
              "scaled_dot_product_attention", "sdp_kernel",
              "get_last_attention_backend"])
