"""Models of the port: GPT (both families), LLaMA and BERT, on the paged
serving path, dense generation (the causal LMs) and the cache-free
training path."""
from .bert import (
    BertConfig,
    BertForMaskedLM,
    bert_base,
    bert_mlm_mask,
    bert_tiny,
    masked_lm_loss,
)
from .gpt import GPTConfig, GPTForCausalLM, gpt3_1p3b, gpt_350m, gpt_tiny
from .llama import LlamaConfig, LlamaForCausalLM, llama2_7b, llama_tiny

__all__ = ["GPTConfig", "GPTForCausalLM", "gpt_tiny", "gpt_350m",
           "gpt3_1p3b", "LlamaConfig", "LlamaForCausalLM", "llama2_7b",
           "llama_tiny", "BertConfig", "BertForMaskedLM", "bert_base",
           "bert_tiny", "bert_mlm_mask", "masked_lm_loss"]
