"""Models of the port: GPT, MoE-GPT and LLaMA, generation over their
dense KV caches, and the BERT/ERNIE encoders."""
from .bert import BertConfig, BertForMaskedLM, BertModel
from .ernie import (ErnieConfig, ErnieForMaskedLM,
                    ErnieForSequenceClassification, ErnieModel)
from .generation import GenerationMixin, generate
from .gpt import (GPT_1P3B, GPTConfig, GPTForCausalLM, GPTModel,
                  GPTPretrainingCriterion)
from .llama import LLAMA_7B, LlamaConfig, LlamaForCausalLM, LlamaModel
from .moe_gpt import (MoEGPTBlock, MoEGPTConfig, MoEGPTForCausalLM,
                      MoEGPTModel, MoEGPTPretrainingCriterion, MoEMLP)

__all__ = ["BertConfig", "BertForMaskedLM", "BertModel", "ErnieConfig",
           "ErnieForMaskedLM", "ErnieForSequenceClassification",
           "ErnieModel", "GenerationMixin", "generate", "GPT_1P3B",
           "GPTConfig", "GPTForCausalLM", "GPTModel",
           "GPTPretrainingCriterion", "LLAMA_7B", "LlamaConfig",
           "LlamaForCausalLM", "LlamaModel", "MoEGPTBlock", "MoEGPTConfig",
           "MoEGPTForCausalLM", "MoEGPTModel", "MoEGPTPretrainingCriterion",
           "MoEMLP"]
