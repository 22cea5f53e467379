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
"""
from . import amp, jit, nn, optimizer
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
           "amp", "jit", "nn", "optimizer"]
