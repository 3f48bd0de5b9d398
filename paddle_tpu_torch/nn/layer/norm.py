"""Norm layers: port of ``paddle_tpu/nn/layer/norm.py:66-277``.

``weight`` starts at ones and ``bias`` at zeros (``weight_attr=False`` /
``bias_attr=False`` drop them; other attributes raise); the running
statistics are the buffers ``_mean`` (zeros) and ``_variance`` (ones),
under the reference's names, so its ``state_dict`` (``bn1._mean`` beside
``bn1.weight``) loads as it is.  The layers do not subclass ``torch.nn.BatchNorm2d``, whose
``num_batches_tracked`` buffer the reference does not have.

``GroupNorm``, ``InstanceNorm1D/2D/3D`` (weights at ones, biases at
zeros; no running statistics, as there), ``LocalResponseNorm`` and
``SpectralNorm``, whose power-iteration vectors ``weight_u`` ``[h]`` and
``weight_v`` ``[w]`` (N(0, 1) from the ``generator`` given) are
non-trainable buffers under the reference's names.  ``SyncBatchNorm``
waits for the distributed slice and raises.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ...core import resolve_device, to_torch_dtype
from .. import functional as F
from .. import initializer as I

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "GroupNorm", "InstanceNorm1D", "InstanceNorm2D",
           "InstanceNorm3D", "LocalResponseNorm", "SpectralNorm"]


class _BatchNormBase(nn.Module):
    _data_format = "NCHW"

    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format=None,
                 use_global_stats=None, name=None, *, device,
                 dtype=torch.float32):
        super().__init__()
        if weight_attr not in (None, False) or bias_attr not in (None, False):
            raise NotImplementedError("parameter attributes other than False "
                                      "are not ported yet")
        kw = dict(device=resolve_device(device), dtype=dtype)
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        if data_format is not None:
            self._data_format = "NCW" if data_format == "NCL" \
                else data_format
        self._use_global_stats = use_global_stats
        self.weight = None if weight_attr is False \
            else nn.Parameter(torch.ones(num_features, **kw))
        self.bias = None if bias_attr is False \
            else nn.Parameter(torch.zeros(num_features, **kw))
        self.register_buffer("_mean", torch.zeros(num_features, **kw))
        self.register_buffer("_variance", torch.ones(num_features, **kw))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return (f"{self._num_features}, momentum={self._momentum}, "
                f"epsilon={self._epsilon}")


class BatchNorm1D(_BatchNormBase):
    _data_format = "NCW"


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    _data_format = "NCDHW"


class BatchNorm(_BatchNormBase):
    """The older form: ``num_channels``, an ``act`` (``"relu"`` applied
    after the norm), ``param_attr`` and ``data_layout``."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-05,
                 param_attr=None, bias_attr=None, data_layout="NCHW", *,
                 device, dtype=torch.float32):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, device=device, dtype=dtype)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        return F.relu(out) if self._act == "relu" else out


def _no_sync():
    raise NotImplementedError("SyncBatchNorm is not ported yet: it comes "
                              "with the distributed slice")


class SyncBatchNorm(_BatchNormBase):
    def __init__(self, *args, **kwargs):
        _no_sync()

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        _no_sync()


def _affine_params(num, weight_attr, bias_attr, device, dtype):
    """``weight`` (ones) and ``bias`` (zeros), each None when its
    attribute is False."""
    if weight_attr not in (None, False) or bias_attr not in (None, False):
        raise NotImplementedError("parameter attributes other than False "
                                  "are not ported yet")
    kw = dict(device=resolve_device(device), dtype=dtype)
    return (None if weight_attr is False
            else nn.Parameter(torch.ones(num, **kw)),
            None if bias_attr is False
            else nn.Parameter(torch.zeros(num, **kw)))


class GroupNorm(nn.Module):
    def __init__(self, num_groups, num_channels, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device, dtype=torch.float32):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight, self.bias = _affine_params(
            num_channels, weight_attr, bias_attr, device, dtype)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)

    def extra_repr(self):
        return f"num_groups={self._num_groups}, epsilon={self._epsilon}"


class _InstanceNormBase(nn.Module):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device, dtype=torch.float32):
        super().__init__()
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight, self.bias = _affine_params(
            num_features, weight_attr, bias_attr, device, dtype)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               epsilon=self._epsilon,
                               data_format=self._data_format)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(nn.Module):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        return F.local_response_norm(x, *self.args)


class SpectralNorm(nn.Module):
    """``forward(weight)``: ``weight`` over its largest singular value."""

    def __init__(self, weight_shape, dim=0, power_iters=1, epsilon=1e-12,
                 dtype="float32", *, device, generator=None):
        super().__init__()
        self._dim = dim
        self._power_iters = power_iters
        self._epsilon = epsilon
        kw = dict(device=resolve_device(device), dtype=to_torch_dtype(dtype))
        h = weight_shape[dim]
        w = math.prod(weight_shape) // h
        self.register_buffer("weight_u", torch.empty(h, **kw))
        self.register_buffer("weight_v", torch.empty(w, **kw))
        I.Normal(0.0, 1.0)(self.weight_u, generator)
        I.Normal(0.0, 1.0)(self.weight_v, generator)

    def forward(self, weight):
        return F.spectral_norm(weight, self.weight_u, self.weight_v,
                               self._dim, self._power_iters, self._epsilon)
