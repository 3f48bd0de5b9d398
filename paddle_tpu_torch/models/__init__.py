"""Models of the port: GPT."""
from .gpt import (GPT_1P3B, GPTConfig, GPTForCausalLM, GPTModel,
                  GPTPretrainingCriterion)

__all__ = ["GPT_1P3B", "GPTConfig", "GPTForCausalLM", "GPTModel",
           "GPTPretrainingCriterion"]
