"""Models of the port: GPT and LLaMA, and generation over their dense KV
caches."""
from .generation import GenerationMixin, generate
from .gpt import (GPT_1P3B, GPTConfig, GPTForCausalLM, GPTModel,
                  GPTPretrainingCriterion)
from .llama import LLAMA_7B, LlamaConfig, LlamaForCausalLM, LlamaModel

__all__ = ["GenerationMixin", "generate", "GPT_1P3B", "GPTConfig",
           "GPTForCausalLM", "GPTModel", "GPTPretrainingCriterion",
           "LLAMA_7B", "LlamaConfig", "LlamaForCausalLM", "LlamaModel"]
