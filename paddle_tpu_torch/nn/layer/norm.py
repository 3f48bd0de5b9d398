"""Batch norm layers: port of ``paddle_tpu/nn/layer/norm.py:66-133``.

``weight`` starts at ones and ``bias`` at zeros (``weight_attr=False`` /
``bias_attr=False`` drop them; other attributes raise); the running
statistics are the buffers ``_mean`` (zeros) and ``_variance`` (ones),
under the reference's names, so its ``state_dict`` (``bn1._mean`` beside
``bn1.weight``) loads as it is.  The layers do not subclass ``torch.nn.BatchNorm2d``, whose
``num_batches_tracked`` buffer the reference does not have.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import functional as F

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D"]


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
        kw = dict(device=device, dtype=dtype)
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
