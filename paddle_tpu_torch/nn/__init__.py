"""Layers, functionals and gradient clipping of the GPT, LLaMA, BERT and
ERNIE paths, LoRA's segmented epilogue (``functional.lora_segment_act``)
among them."""
from . import functional
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layers import (Dropout, Embedding, LayerList, LayerNorm, Linear,
                     RMSNorm)

__all__ = ["functional", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "Dropout", "Embedding", "LayerList",
           "LayerNorm", "Linear", "RMSNorm"]
