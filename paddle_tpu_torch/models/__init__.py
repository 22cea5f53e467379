"""Models of the port: GPT, on the paged serving path and the cache-free
training path."""
from .gpt import GPTConfig, GPTForCausalLM, gpt_350m, gpt_tiny

__all__ = ["GPTConfig", "GPTForCausalLM", "gpt_tiny", "gpt_350m"]
