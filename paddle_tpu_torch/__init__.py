"""paddle_tpu_torch — the PyTorch + CUDA port of paddle_tpu.

Built for one NVIDIA H100 (sm_90a); the JAX package ``paddle_tpu`` beside it
stays the reference. This package imports torch and numpy only, never JAX
and never ``paddle_tpu``. Entry points run on CUDA unless the caller passes
``device="cpu"``; every kernel is built from ``csrc/`` at first use on the
card, and its plain PyTorch version runs for CPU tensors.

Slices so far: GPT (RoPE / RMSNorm / SwiGLU) served token by token through
the paged KV pool, the continuous scheduler and the HTTP server, with
attention in a hand-written paged split-KV CUDA kernel; and GPT trained
through ``TrainStep`` with ``AdamW``, O2 bf16 (``amp.decorate``) and
hand-written flash-attention forward and backward CUDA kernels.
"""
from . import amp, jit, nn, optimizer
from .bridge import from_paddle_tpu_state, to_paddle_tpu_state
from .inference import (
    ContinuousGenerateBatchingPredictor,
    InferenceServer,
    PagedKVCache,
)
from .models import GPTConfig, GPTForCausalLM, gpt_350m, gpt_tiny

__all__ = ["GPTConfig", "GPTForCausalLM", "gpt_tiny", "gpt_350m",
           "PagedKVCache", "ContinuousGenerateBatchingPredictor",
           "InferenceServer", "from_paddle_tpu_state", "to_paddle_tpu_state",
           "amp", "jit", "nn", "optimizer"]
