"""The layers of ``nn`` as ``torch.nn.Module``s: port of
``paddle_tpu/nn/layer/{conv,norm,activation_pool,loss,common,transformer,
rnn,scanned}.py`` (the vision models' convolutions, norms and pools,
every activation and loss layer, the common layers, the Transformer
family, the recurrent family with beam search, and ``scan_layer_stack``)."""
from . import activation_pool as _activation_pool
from . import common as _common
from . import loss as _loss
from . import rnn as _rnn
from . import transformer as _transformer
from .activation_pool import *  # noqa: F401,F403  (its __all__)
from .common import *  # noqa: F401,F403  (its __all__)
from .loss import *  # noqa: F401,F403  (its __all__)
from .rnn import *  # noqa: F401,F403  (its __all__)
from .transformer import *  # noqa: F401,F403  (its __all__)
from .conv import (Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
                   Conv3DTranspose)
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   GroupNorm, InstanceNorm1D, InstanceNorm2D, InstanceNorm3D,
                   LocalResponseNorm, SpectralNorm, SyncBatchNorm)
from .scanned import scan_layer_stack

__all__ = [*_activation_pool.__all__, *_loss.__all__,
           *(n for n in _common.__all__ if n not in (
               "flatten", "attr_initializer", "attr_param")),
           *_transformer.__all__, *_rnn.__all__, "Conv1D", "Conv2D", "Conv3D",
           "Conv1DTranspose", "Conv2DTranspose", "Conv3DTranspose",
           "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "GroupNorm", "InstanceNorm1D", "InstanceNorm2D",
           "InstanceNorm3D", "LocalResponseNorm", "SpectralNorm",
           "scan_layer_stack"]
