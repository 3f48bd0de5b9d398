"""Models of the port: GPT, and generation over its dense KV cache."""
from .generation import GenerationMixin, generate
from .gpt import (GPT_1P3B, GPTConfig, GPTForCausalLM, GPTModel,
                  GPTPretrainingCriterion)

__all__ = ["GenerationMixin", "generate", "GPT_1P3B", "GPTConfig",
           "GPTForCausalLM", "GPTModel", "GPTPretrainingCriterion"]
