"""The common layers: port of ``paddle_tpu/nn/layer/common.py`` (``Identity``
:24, the dropouts :94-133, ``Flatten`` :126, the upsampling layers
:147-182, the pads :185-217, ``CosineSimilarity``, ``Bilinear``,
``Unfold``, ``Fold``, ``PixelShuffle``, ``PixelUnshuffle``, ``Unflatten``,
``PairwiseDistance`` and ``ChannelShuffle`` :220-304), each over its
functional, and of the reference's ``Sequential``, ``ParameterList`` and
``LayerDict`` (``nn/layer/layers.py:457-515``) as ``torch.nn.Sequential``,
``torch.nn.ParameterList`` and ``torch.nn.ModuleDict``, whose children are
named ``0``, ``1``, ... (or by their keys) as the reference's are
(``features.0.weight``).  ``Linear``, ``Embedding`` and ``Dropout`` are
in ``nn.layers``.

``Bilinear``'s weight ``[out, in1, in2]`` is Xavier-normal over the
reference's fans of that shape and its bias ``[1, out]`` zeros, drawn
from the ``generator`` given; ``bias_attr=False`` drops the bias, an
``nn.initializer`` initializer given as an attribute replaces the default
one, and any other attribute raises.  The dropout layers draw their masks
from their ``generator``.
"""
from __future__ import annotations

import torch
from torch import nn

from ... import amp
from ...core import resolve_device
from .. import functional as F
from .. import initializer as I

__all__ = ["Identity", "Flatten", "Sequential", "ParameterList", "LayerDict",
           "Dropout2D", "Dropout3D", "AlphaDropout", "Upsample",
           "UpsamplingNearest2D", "UpsamplingBilinear2D", "Pad1D", "Pad2D",
           "Pad3D", "ZeroPad2D", "CosineSimilarity", "Bilinear", "Unfold",
           "Fold", "PixelShuffle", "PixelUnshuffle", "Unflatten",
           "PairwiseDistance", "ChannelShuffle", "flatten", "attr_initializer",
           "attr_param"]

Sequential = nn.Sequential
ParameterList = nn.ParameterList
LayerDict = nn.ModuleDict


def attr_initializer(attr, default=None):
    """The initializer a Paddle parameter attribute asks for: ``None``
    takes ``default``, an ``nn.initializer`` initializer replaces it, and
    ``False`` (no parameter) is returned as it is; any other attribute
    raises."""
    if attr is False:
        return False
    if attr is not None and not isinstance(attr, I.Initializer):
        raise NotImplementedError("parameter attributes other than False or "
                                  "an initializer are not ported yet")
    return attr or default


def attr_param(shape, attr, default, device, dtype, generator):
    """A parameter of ``shape`` initialized as `attr_initializer` says, or
    None for ``attr=False``."""
    init = attr_initializer(attr, default)
    if init is False:
        return None
    p = nn.Parameter(torch.empty(shape, device=device, dtype=dtype))
    init(p, generator)
    return p


def flatten(x, start_axis=1, stop_axis=-1):
    """Dims ``start_axis`` to ``stop_axis`` joined into one (the op
    ``flatten``, on neither O1 list)."""
    (x,) = amp.cast_inputs("flatten", x)
    return torch.flatten(x, start_axis, stop_axis)


class Identity(nn.Module):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Flatten(nn.Module):
    """`flatten` as a layer."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return flatten(x, self.start_axis, self.stop_axis)


class _RandomLayer(nn.Module):
    def __init__(self, p, generator):
        super().__init__()
        self.p = p
        self.generator = generator


class Dropout2D(_RandomLayer):
    def __init__(self, p=0.5, data_format="NCHW", name=None, *,
                 generator=None):
        super().__init__(p, generator)
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, training=self.training,
                           data_format=self.data_format,
                           generator=self.generator)


class Dropout3D(_RandomLayer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None, *,
                 generator=None):
        super().__init__(p, generator)
        self.data_format = data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, training=self.training,
                           data_format=self.data_format,
                           generator=self.generator)


class AlphaDropout(_RandomLayer):
    def __init__(self, p=0.5, name=None, *, generator=None):
        super().__init__(p, generator)

    def forward(self, x):
        return F.alpha_dropout(x, self.p, training=self.training,
                               generator=self.generator)


class Upsample(nn.Module):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.align_mode = align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0,
                         data_format)


class UpsamplingBilinear2D(Upsample):
    """Bilinear with ``align_corners=True``, as in the reference."""

    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0,
                         data_format)


class _PadNd(nn.Module):
    _data_format = "NCHW"

    def __init__(self, padding, mode="constant", value=0.0,
                 data_format=None, name=None):
        super().__init__()
        self.padding = padding
        self.mode = mode
        self.value = value
        self.data_format = data_format or self._data_format

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value,
                     self.data_format)


class Pad1D(_PadNd):
    _data_format = "NCL"


class Pad2D(_PadNd):
    pass


class Pad3D(_PadNd):
    _data_format = "NCDHW"


class ZeroPad2D(_PadNd):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class CosineSimilarity(nn.Module):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class Bilinear(nn.Module):
    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype,
                  generator=generator)
        self.weight = attr_param((out_features, in1_features, in2_features),
                                 weight_attr, I.XavierNormal(), **kw)
        self.bias = attr_param((1, out_features), bias_attr, I.Constant(0.0),
                               **kw)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class Unfold(nn.Module):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)


class Fold(nn.Module):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.output_sizes = output_sizes
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.fold(x, self.output_sizes, *self.args)


class PixelShuffle(nn.Module):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(nn.Module):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.downscale_factor = downscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor, self.data_format)


class Unflatten(nn.Module):
    """Dim ``axis`` split into ``shape``."""

    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis = axis
        self.shape = list(shape)

    def forward(self, x):
        (x,) = amp.cast_inputs("reshape", x)
        ax = self.axis if self.axis >= 0 else x.dim() + self.axis
        return x.reshape(list(x.shape[:ax]) + self.shape
                         + list(x.shape[ax + 1:]))


class PairwiseDistance(nn.Module):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return F.pairwise_distance(x, y, self.p, self.epsilon, self.keepdim)


class ChannelShuffle(nn.Module):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups = groups
        self.data_format = data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)
