"""The layers the vision models are built from, every activation and
every loss layer, as ``torch.nn.Module``s: port of
``paddle_tpu/nn/layer/{conv,norm,activation_pool,loss,common}.py``."""
from . import activation_pool as _activation_pool
from . import loss as _loss
from .activation_pool import *  # noqa: F401,F403  (its __all__)
from .loss import *  # noqa: F401,F403  (its __all__)
from .common import Flatten, Sequential
from .conv import (Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
                   Conv3DTranspose)
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   GroupNorm, InstanceNorm1D, InstanceNorm2D, InstanceNorm3D,
                   LocalResponseNorm, SpectralNorm, SyncBatchNorm)

__all__ = [*_activation_pool.__all__, *_loss.__all__, "Flatten", "Sequential", "Conv1D", "Conv2D", "Conv3D",
           "Conv1DTranspose", "Conv2DTranspose", "Conv3DTranspose",
           "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "GroupNorm", "InstanceNorm1D", "InstanceNorm2D",
           "InstanceNorm3D", "LocalResponseNorm", "SpectralNorm"]
