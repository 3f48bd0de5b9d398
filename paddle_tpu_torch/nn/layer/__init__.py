"""The layers the vision models are built from, as ``torch.nn.Module``s:
port of ``paddle_tpu/nn/layer/{conv,norm,activation_pool,common}.py``."""
from .activation_pool import (AdaptiveAvgPool1D, AdaptiveAvgPool2D,
                              AdaptiveAvgPool3D, AdaptiveMaxPool1D,
                              AdaptiveMaxPool2D, AdaptiveMaxPool3D,
                              AvgPool1D, AvgPool2D, AvgPool3D, MaxPool1D,
                              MaxPool2D, MaxPool3D, MaxUnPool1D, MaxUnPool2D,
                              MaxUnPool3D, ReLU, ReLU6)
from .common import Flatten, Sequential
from .conv import (Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
                   Conv3DTranspose)
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   GroupNorm, InstanceNorm1D, InstanceNorm2D, InstanceNorm3D,
                   LocalResponseNorm, SpectralNorm, SyncBatchNorm)

__all__ = ["AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
           "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D", "ReLU",
           "ReLU6", "Flatten", "Sequential", "Conv1D", "Conv2D", "Conv3D",
           "Conv1DTranspose", "Conv2DTranspose", "Conv3DTranspose",
           "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "GroupNorm", "InstanceNorm1D", "InstanceNorm2D",
           "InstanceNorm3D", "LocalResponseNorm", "SpectralNorm"]
