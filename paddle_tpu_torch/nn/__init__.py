"""Layers, functionals, initializers, gradient clipping and ``nn.utils``:
those of the GPT, LLaMA, BERT and ERNIE paths (``layers``), LoRA's
segmented epilogue (``functional.lora_segment_act``) among them, and
(``layer``) the vision models' convolutions, norms, activations and
pools, every activation and loss layer, the common layers (dropouts,
pads, upsampling, ``Bilinear``, ``Fold``/``Unfold``, ...), the Transformer
family, the recurrent family with beam search, ``ParameterList`` and
``LayerDict``."""
from . import functional, initializer, utils
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from . import layer as _layer
from .layer import *  # noqa: F401,F403  (its __all__)
from .layers import (Dropout, Embedding, LayerList, LayerNorm, Linear,
                     RMSNorm)
from .utils import clip_grad_norm_, clip_grad_value_

__all__ = ["functional", "initializer", "utils", "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue", "Dropout", "Embedding",
           "LayerList", "LayerNorm", "Linear", "RMSNorm", "clip_grad_norm_",
           "clip_grad_value_", *_layer.__all__]
