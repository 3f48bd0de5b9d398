"""Models of the port: GPT."""
from .gpt import GPT_1P3B, GPTConfig, GPTForCausalLM, GPTModel

__all__ = ["GPT_1P3B", "GPTConfig", "GPTForCausalLM", "GPTModel"]
