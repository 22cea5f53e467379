"""paddle_tpu_torch — the PyTorch + CUDA port of paddle_tpu.

Built for one NVIDIA H100 (sm_90a); the JAX package ``paddle_tpu`` beside it
stays the reference. This package imports torch and numpy only, never JAX
and never ``paddle_tpu``. Entry points run on CUDA unless the caller passes
``device="cpu"``; every kernel is built from ``csrc/`` at first use on the
card, and its plain PyTorch version runs for CPU tensors.

Slices so far: GPT (RoPE / RMSNorm / SwiGLU) served token by token through
the paged KV pool, the continuous scheduler and the HTTP server, with
attention in a hand-written paged split-KV CUDA kernel; GPT trained
through ``TrainStep`` with ``AdamW``, O2 bf16 (``amp.decorate``) and
hand-written flash-attention forward and backward CUDA kernels; and GPT
generating through dense ``generate()`` (a hand-written dense split-KV
CUDA kernel), whole-batch ``generate_paged`` behind
``GenerateBatchingPredictor``, and speculative decoding
(``generate_speculative``, ``verify_step``); and FlashMask and packed
varlen attention (``nn.functional.flashmask_attention``,
``flash_attn_unpadded`` and the qkvpacked forms), forward and backward,
through the masked forms of the flash-attention CUDA kernels. The step
programs and the training step (``jit.TrainStep``: SGD, Momentum, Adam,
AdamW, the schedulers of ``optimizer.lr``, three gradient clips) run as
CUDA graphs captured once per signature and replayed. Training also takes
dropout (masks from the port's default generator, registered with every
captured step), recompute (``distributed.fleet.recompute``), AMP O1
(``amp.auto_cast``, by the JAX package's op names) and ``GradScaler``,
float16 (the flash kernels' f16 forms), nine more optimizers (and eager
LBFGS), and packed documents through the captured step. Three model
families beside that GPT go through the same entry points: the
GPT-2-style GPT (learned positions, LayerNorm, GELU, biases;
``gpt3_1p3b``), LLaMA (``llama2_7b``) and BERT's masked LM
(``bert_base``, trained through ``TrainStep``).

The paddle-style core (slice 13) sits beside them: ``Tensor`` (a wrapper
over a ``torch.Tensor``: list shapes, ``stop_gradient`` True by default)
and ``to_tensor``, autograd over torch's (``backward``, ``grad``,
``PyLayer``), places (``set_device``; the card unless the CPU is asked
for), flags, dtypes, and the op layer (``paddle_tpu_torch.exp``,
``matmul``, ``linalg``, ... and the same ops as Tensor methods; AMP O1
and O2 cast by op name). The attention functionals take a ``Tensor``;
the GPT, LLaMA and BERT models and serving still run on ``torch.Tensor``.

The nn surface (slice 14) is paddle's: ``nn.Layer`` (a
``torch.nn.Module``), ``nn.Parameter`` (a Tensor over a
``torch.nn.Parameter``), the initializers, the conv / norm / pool / loss /
transformer layers and ``nn.functional``; ``vision.models`` builds the
ResNet family from it, trained through ``TrainStep`` and the optimizers,
which take a Layer's parameters with their per-parameter learning rates
and regularizers.
"""
from .framework.dtype import (  # noqa: F401
    bfloat16, bool_, complex64, complex128, finfo, float16, float32, float64,
    get_default_dtype, iinfo, int8, int16, int32, int64, set_default_dtype,
    uint8,
)

bool = bool_  # paddle.bool

from .framework.device import (  # noqa: E402,F401
    CPUPlace, CUDAPlace, Place, TPUPlace, XPUPlace, device_count, get_device,
    get_place, is_compiled_with_cuda, is_compiled_with_xpu, set_device,
)
from .framework.flags import get_flags, set_flags  # noqa: E402,F401
from .framework.random import (  # noqa: E402,F401
    get_rng_state, seed, set_rng_state,
)
from .tensor import Tensor, to_tensor  # noqa: E402,F401
from .autograd import (  # noqa: E402,F401
    enable_grad, grad, is_grad_enabled, no_grad, set_grad_enabled,
)
from . import ops  # noqa: E402
from .ops import *  # noqa: E402,F401,F403
from . import autograd, framework, linalg  # noqa: E402,F401
from . import amp, jit, nn, optimizer, vision  # noqa: E402
from .bridge import from_paddle_tpu_state, to_paddle_tpu_state
from .inference import (
    ContinuousGenerateBatchingPredictor,
    GenerateBatchingPredictor,
    InferenceServer,
    PagedKVCache,
)
from .models import (
    BertConfig,
    BertForMaskedLM,
    GPTConfig,
    GPTForCausalLM,
    LlamaConfig,
    LlamaForCausalLM,
    bert_base,
    bert_mlm_mask,
    bert_tiny,
    gpt3_1p3b,
    gpt_350m,
    gpt_tiny,
    llama2_7b,
    llama_tiny,
    masked_lm_loss,
)

__all__ = ["GPTConfig", "GPTForCausalLM", "gpt_tiny", "gpt_350m",
           "gpt3_1p3b", "LlamaConfig", "LlamaForCausalLM", "llama2_7b",
           "llama_tiny", "BertConfig", "BertForMaskedLM", "bert_base",
           "bert_tiny", "bert_mlm_mask", "masked_lm_loss",
           "PagedKVCache", "ContinuousGenerateBatchingPredictor",
           "GenerateBatchingPredictor",
           "InferenceServer", "from_paddle_tpu_state", "to_paddle_tpu_state",
           "amp", "jit", "nn", "optimizer", "vision", "autograd", "framework",
           "linalg", "ops", "Tensor", "to_tensor", "seed", "get_rng_state",
           "set_rng_state", "no_grad", "enable_grad", "grad",
           "is_grad_enabled", "set_grad_enabled", "set_flags", "get_flags",
           "Place", "CPUPlace", "CUDAPlace", "TPUPlace", "XPUPlace",
           "set_device", "get_device", "get_place", "device_count",
           "is_compiled_with_cuda", "is_compiled_with_xpu",
           "get_default_dtype", "set_default_dtype", "finfo", "iinfo",
           "bool", "bool_", "uint8", "int8", "int16", "int32", "int64",
           "float16", "bfloat16", "float32", "float64", "complex64",
           "complex128"] + ops.__all__
