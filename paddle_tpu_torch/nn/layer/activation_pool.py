"""Activation and pooling layers: port of ``paddle_tpu/nn/layer/
activation_pool.py`` (``ReLU``, ``ReLU6`` :48-49; the pools :102-175;
``MaxUnPool1D/2D/3D`` :177-219, whose ``forward`` takes the values and
the mask).
A pool layer keeps its arguments and calls its functional with them
(``ceil_mode``, ``exclusive``, ``divisor_override``, ``data_format``,
... by keyword)."""
from __future__ import annotations

from torch import nn

from .. import functional as F

__all__ = ["ReLU", "ReLU6", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "MaxPool1D", "MaxPool2D", "MaxPool3D", "AdaptiveAvgPool1D",
           "AdaptiveAvgPool2D", "AdaptiveAvgPool3D", "AdaptiveMaxPool1D",
           "AdaptiveMaxPool2D", "AdaptiveMaxPool3D", "MaxUnPool1D",
           "MaxUnPool2D", "MaxUnPool3D"]


class ReLU(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu(x)


class ReLU6(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu6(x)


class _PoolNd(nn.Module):
    _fn = None

    def __init__(self, kernel_size, stride=None, padding=0, **kwargs):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.kwargs = {k: v for k, v in kwargs.items() if k != "name"}

    def forward(self, x):
        return type(self)._fn(x, self.kernel_size, self.stride,
                              self.padding, **self.kwargs)

    def extra_repr(self):
        return (f"kernel_size={self.kernel_size}, stride={self.stride}, "
                f"padding={self.padding}")


class AvgPool1D(_PoolNd):
    _fn = staticmethod(F.avg_pool1d)


class AvgPool2D(_PoolNd):
    _fn = staticmethod(F.avg_pool2d)


class AvgPool3D(_PoolNd):
    _fn = staticmethod(F.avg_pool3d)


class MaxPool1D(_PoolNd):
    _fn = staticmethod(F.max_pool1d)


class MaxPool2D(_PoolNd):
    _fn = staticmethod(F.max_pool2d)


class MaxPool3D(_PoolNd):
    _fn = staticmethod(F.max_pool3d)


class _AdaptivePoolNd(nn.Module):
    """Its keyword arguments are accepted and not read, as in the
    reference (:160-167): the layers pool channels first."""
    _fn = None

    def __init__(self, output_size, **kwargs):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return type(self)._fn(x, self.output_size)

    def extra_repr(self):
        return f"output_size={self.output_size}"


class AdaptiveAvgPool1D(_AdaptivePoolNd):
    _fn = staticmethod(F.adaptive_avg_pool1d)


class AdaptiveAvgPool2D(_AdaptivePoolNd):
    _fn = staticmethod(F.adaptive_avg_pool2d)


class AdaptiveAvgPool3D(_AdaptivePoolNd):
    _fn = staticmethod(F.adaptive_avg_pool3d)


class AdaptiveMaxPool1D(_AdaptivePoolNd):
    _fn = staticmethod(F.adaptive_max_pool1d)


class AdaptiveMaxPool2D(_AdaptivePoolNd):
    _fn = staticmethod(F.adaptive_max_pool2d)


class AdaptiveMaxPool3D(_AdaptivePoolNd):
    _fn = staticmethod(F.adaptive_max_pool3d)


class _MaxUnPoolNd(nn.Module):
    _fn = None
    _data_format = "NCHW"

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format=None, output_size=None, name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.data_format = data_format or self._data_format
        self.output_size = output_size

    def forward(self, x, indices):
        return type(self)._fn(x, indices, self.kernel_size, self.stride,
                              self.padding, self.data_format,
                              self.output_size)

    def extra_repr(self):
        return (f"kernel_size={self.kernel_size}, stride={self.stride}, "
                f"padding={self.padding}")


class MaxUnPool1D(_MaxUnPoolNd):
    _fn = staticmethod(F.max_unpool1d)
    _data_format = "NCL"


class MaxUnPool2D(_MaxUnPoolNd):
    _fn = staticmethod(F.max_unpool2d)


class MaxUnPool3D(_MaxUnPoolNd):
    _fn = staticmethod(F.max_unpool3d)
    _data_format = "NCDHW"
