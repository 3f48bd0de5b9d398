"""Layers, functionals, initializers and gradient clipping: those of the
GPT, LLaMA, BERT and ERNIE paths (``layers``), LoRA's segmented epilogue
(``functional.lora_segment_act``) among them, and those of the vision
models (``layer``: convolutions and transposed convolutions, the norms,
activations, pools and unpooling, ``Flatten``, ``Sequential``)."""
from . import functional, initializer
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import (AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
                    AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D,
                    AvgPool1D, AvgPool2D, AvgPool3D, BatchNorm, BatchNorm1D,
                    BatchNorm2D, BatchNorm3D, Conv1D, Conv1DTranspose,
                    Conv2D, Conv2DTranspose, Conv3D, Conv3DTranspose,
                    Flatten, GroupNorm, InstanceNorm1D, InstanceNorm2D,
                    InstanceNorm3D, LocalResponseNorm, MaxPool1D, MaxPool2D,
                    MaxPool3D, MaxUnPool1D, MaxUnPool2D, MaxUnPool3D, ReLU,
                    ReLU6, Sequential, SpectralNorm, SyncBatchNorm)
from .layers import (Dropout, Embedding, LayerList, LayerNorm, Linear,
                     RMSNorm)

__all__ = ["functional", "initializer", "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue", "Dropout", "Embedding",
           "LayerList", "LayerNorm", "Linear", "RMSNorm",
           "AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
           "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "BatchNorm", "BatchNorm1D",
           "BatchNorm2D", "BatchNorm3D", "Conv1D", "Conv2D", "Conv3D",
           "Flatten", "MaxPool1D", "MaxPool2D", "MaxPool3D", "ReLU", "ReLU6",
           "Sequential", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose", "GroupNorm", "InstanceNorm1D",
           "InstanceNorm2D", "InstanceNorm3D", "LocalResponseNorm",
           "SpectralNorm", "SyncBatchNorm", "MaxUnPool1D", "MaxUnPool2D",
           "MaxUnPool3D"]
