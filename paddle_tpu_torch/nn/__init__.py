"""Layers, functionals, initializers and gradient clipping: those of the
GPT, LLaMA, BERT and ERNIE paths (``layers``), LoRA's segmented epilogue
(``functional.lora_segment_act``) among them, and those of the vision
models (``layer``: convolutions and transposed convolutions, the norms,
activations, pools and unpooling, ``Flatten``, ``Sequential``) with
every activation and loss layer."""
from . import functional, initializer
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from . import layer as _layer
from .layer import *  # noqa: F401,F403  (its __all__)
from .layers import (Dropout, Embedding, LayerList, LayerNorm, Linear,
                     RMSNorm)

__all__ = ["functional", "initializer", "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue", "Dropout", "Embedding",
           "LayerList", "LayerNorm", "Linear", "RMSNorm", *_layer.__all__]
