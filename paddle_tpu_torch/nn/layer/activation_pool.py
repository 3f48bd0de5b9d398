"""Activation and pooling layers: port of ``paddle_tpu/nn/layer/
activation_pool.py``: the activation layers of its ``_act_layer``
factory (:26-77, the reference's positional and keyword argument rules:
the i-th positional argument fills the i-th named one, keywords and
defaults the rest, ``name`` dropped), ``RReLU`` (:80, random in training
from the layer's ``generator``), ``PReLU`` (:89, its weight a parameter
filled with ``init``), ``Softmax2D`` (:193, the channel dim of NCHW); the
pools (:102-175) and ``MaxUnPool1D/2D/3D`` (:177-219, whose ``forward``
takes the values and the mask).
A pool layer keeps its arguments and calls its functional with them
(``ceil_mode``, ``exclusive``, ``divisor_override``, ``data_format``,
... by keyword)."""
from __future__ import annotations

import torch
from torch import nn

from ...core import resolve_device
from .. import functional as F
from .. import initializer as I

__all__ = [
    "ReLU", "ReLU6", "GELU", "Sigmoid", "Silu", "Swish", "Mish", "Hardswish",
    "Hardsigmoid", "Hardtanh", "LeakyReLU", "ELU", "SELU", "CELU", "PReLU",
    "RReLU", "Softplus", "Softshrink", "Hardshrink", "Softsign", "Tanhshrink",
    "LogSigmoid", "LogSoftmax", "Softmax", "Tanh", "GLU", "Maxout",
    "ThresholdedReLU", "Softmax2D",
    "AvgPool1D", "AvgPool2D", "AvgPool3D", "MaxPool1D", "MaxPool2D",
    "MaxPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
    "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
    "AdaptiveMaxPool3D", "MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D"]


def _act_layer(name, fn, *arg_names, **defaults):
    """A layer calling ``fn(x, **args)``: ``args`` from the positional
    arguments in the order of ``arg_names``, then the keywords, then
    ``defaults`` (the reference's factory; other keywords are dropped)."""
    class _Act(nn.Module):
        def __init__(self, *args, **kwargs):
            super().__init__()
            self._args = {}
            for i, an in enumerate(arg_names):
                if i < len(args):
                    self._args[an] = args[i]
                elif an in kwargs:
                    self._args[an] = kwargs[an]
                elif an in defaults:
                    self._args[an] = defaults[an]

        def forward(self, x):
            return fn(x, **self._args)

        def extra_repr(self):
            return ", ".join(f"{k}={v}" for k, v in self._args.items())

    _Act.__name__ = _Act.__qualname__ = name
    return _Act


ReLU = _act_layer("ReLU", F.relu)
ReLU6 = _act_layer("ReLU6", F.relu6)
GELU = _act_layer("GELU", F.gelu, "approximate", approximate=False)
Sigmoid = _act_layer("Sigmoid", F.sigmoid)
Silu = _act_layer("Silu", F.silu)
Swish = _act_layer("Swish", F.swish)
Mish = _act_layer("Mish", F.mish)
Hardswish = _act_layer("Hardswish", F.hardswish)
Hardsigmoid = _act_layer("Hardsigmoid", F.hardsigmoid)
Hardtanh = _act_layer("Hardtanh", F.hardtanh, "min", "max", min=-1.0,
                      max=1.0)
LeakyReLU = _act_layer("LeakyReLU", F.leaky_relu, "negative_slope",
                       negative_slope=0.01)
ELU = _act_layer("ELU", F.elu, "alpha", alpha=1.0)
SELU = _act_layer("SELU", F.selu)
CELU = _act_layer("CELU", F.celu, "alpha", alpha=1.0)
Softplus = _act_layer("Softplus", F.softplus, "beta", "threshold", beta=1.0,
                      threshold=20.0)
Softshrink = _act_layer("Softshrink", F.softshrink, "threshold",
                        threshold=0.5)
Hardshrink = _act_layer("Hardshrink", F.hardshrink, "threshold",
                        threshold=0.5)
Softsign = _act_layer("Softsign", F.softsign)
Tanhshrink = _act_layer("Tanhshrink", F.tanhshrink)
LogSigmoid = _act_layer("LogSigmoid", F.log_sigmoid)
LogSoftmax = _act_layer("LogSoftmax", F.log_softmax, "axis", axis=-1)
Softmax = _act_layer("Softmax", F.softmax, "axis", axis=-1)
Tanh = _act_layer("Tanh", F.tanh)
GLU = _act_layer("GLU", F.glu, "axis", axis=-1)
Maxout = _act_layer("Maxout", F.maxout, "groups", "axis", axis=1)
ThresholdedReLU = _act_layer("ThresholdedReLU", F.thresholded_relu,
                             "threshold", "value", threshold=1.0, value=0.0)


class RReLU(nn.Module):
    """`F.rrelu` with the layer's ``training`` flag; its random slopes
    come from ``generator`` (the global one when None)."""

    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None, *,
                 generator=None):
        super().__init__()
        self.lower, self.upper = lower, upper
        self.generator = generator

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, training=self.training,
                       generator=self.generator)


class PReLU(nn.Module):
    """`F.prelu` with a weight of ``num_parameters`` values filled with
    ``init``."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        if weight_attr is not None:
            raise NotImplementedError("PReLU: weight_attr is not ported yet")
        self._data_format = data_format
        self.weight = nn.Parameter(torch.empty(
            num_parameters, device=resolve_device(device), dtype=dtype))
        I.Constant(init)(self.weight)

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)


class Softmax2D(nn.Module):
    """Softmax over the channel dim of NCHW inputs (dim -3)."""

    def forward(self, x):
        return F.softmax(x, axis=-3)


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
