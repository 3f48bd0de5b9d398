"""Convolution layers: port of ``paddle_tpu/nn/layer/conv.py:24-100``.

The weight is ``[out, in / groups, *kernel]`` drawn from
``KaimingUniform(negative_slope=sqrt(5), nonlinearity="leaky_relu")`` over
``fan_in = in / groups * prod(kernel)`` (a bound of ``1 / sqrt(fan_in)``),
the bias ``Uniform(-1 / sqrt(fan_in), 1 / sqrt(fan_in))``
(:46-58); ``bias_attr=False`` drops the bias (other parameter
attributes raise).  Both come from the ``generator`` given.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .. import functional as F
from .. import initializer as I
from ..functional.conv import ntuple

__all__ = ["Conv1D", "Conv2D", "Conv3D"]


class _ConvNd(nn.Module):
    _nsp = 2
    _fn = None

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device, dtype=torch.float32, generator=None):
        super().__init__()
        if padding_mode != "zeros":
            raise NotImplementedError(
                f"padding_mode={padding_mode!r}: the reference pads with "
                f"zeros only")
        if weight_attr is not None or bias_attr not in (None, False):
            raise NotImplementedError("weight_attr and bias_attr other than "
                                      "bias_attr=False are not ported yet")
        nsp = self._nsp
        self._in_channels, self._out_channels = in_channels, out_channels
        self._kernel_size = ntuple(kernel_size, nsp)
        self._stride = ntuple(stride, nsp)
        self._padding = padding
        self._dilation = ntuple(dilation, nsp)
        self._groups = groups
        self._data_format = data_format
        fan_in = in_channels // groups * math.prod(self._kernel_size)
        self.weight = nn.Parameter(torch.empty(
            (out_channels, in_channels // groups) + self._kernel_size,
            device=device, dtype=dtype))
        I.KaimingUniform(fan_in=fan_in, negative_slope=math.sqrt(5.0),
                         nonlinearity="leaky_relu")(self.weight, generator)
        self.bias = None
        if bias_attr is not False:
            bound = 1.0 / math.sqrt(fan_in)
            self.bias = nn.Parameter(torch.empty(out_channels, device=device,
                                                 dtype=dtype))
            I.Uniform(-bound, bound)(self.bias, generator)

    def forward(self, x):
        return type(self)._fn(x, self.weight, self.bias, self._stride,
                              self._padding, self._dilation, self._groups,
                              self._data_format)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}, "
                f"padding={self._padding}, groups={self._groups}")


class Conv1D(_ConvNd):
    _nsp = 1
    _fn = staticmethod(F.conv1d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL", **kw):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, **kw)


class Conv2D(_ConvNd):
    _nsp = 2
    _fn = staticmethod(F.conv2d)


class Conv3D(_ConvNd):
    _nsp = 3
    _fn = staticmethod(F.conv3d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 **kw):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, **kw)
