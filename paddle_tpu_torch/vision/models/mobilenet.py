"""MobileNetV2.

Port of ``paddle_tpu/vision/models/mobilenet.py``: inverted residual
blocks (a 1 x 1 expansion, a depthwise 3 x 3 convolution with ``groups``
equal to its channels, a 1 x 1 projection; the residual where the stride
is 1 and the widths agree), batch norm and ``ReLU6`` throughout, and a
classifier behind dropout 0.2, its masks from the model's generator.
"""
from __future__ import annotations

import torch
from torch import nn

from ... import nn as pnn
from ...nn.layer.common import flatten
from ._common import layer_kwargs, name_parameters, no_pretrained

__all__ = ["MobileNetV2", "mobilenet_v2"]


def _make_divisible(v, divisor=8, min_value=None):
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvBNReLU(nn.Sequential):
    def __init__(self, in_c, out_c, kernel=3, stride=1, groups=1, *, kw):
        pad = (kernel - 1) // 2
        super().__init__(
            pnn.Conv2D(in_c, out_c, kernel, stride=stride, padding=pad,
                       groups=groups, bias_attr=False, **kw),
            pnn.BatchNorm2D(out_c, device=kw["device"], dtype=kw["dtype"]),
            pnn.ReLU6(),
        )


class InvertedResidual(nn.Module):
    def __init__(self, inp, oup, stride, expand_ratio, *, kw):
        super().__init__()
        self.stride = stride
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNReLU(inp, hidden, kernel=1, kw=kw))
        layers.extend([
            ConvBNReLU(hidden, hidden, stride=stride, groups=hidden, kw=kw),
            pnn.Conv2D(hidden, oup, 1, bias_attr=False, **kw),
            pnn.BatchNorm2D(oup, device=kw["device"], dtype=kw["dtype"]),
        ])
        self.conv = pnn.Sequential(*layers)

    def forward(self, x):
        if self.use_res:
            return x + self.conv(x)
        return self.conv(x)


class MobileNetV2(nn.Module):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=None, dtype=torch.float32, generator=None):
        super().__init__()
        kw = layer_kwargs(device, dtype, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [
            [1, 16, 1, 1], [6, 24, 2, 2], [6, 32, 3, 2], [6, 64, 4, 2],
            [6, 96, 3, 1], [6, 160, 3, 2], [6, 320, 1, 1],
        ]
        input_channel = _make_divisible(32 * scale)
        last_channel = _make_divisible(1280 * max(1.0, scale))
        features = [ConvBNReLU(3, input_channel, stride=2, kw=kw)]
        for t, c, n, s in cfg:
            out_c = _make_divisible(c * scale)
            for i in range(n):
                features.append(InvertedResidual(
                    input_channel, out_c, s if i == 0 else 1, t, kw=kw))
                input_channel = out_c
        features.append(ConvBNReLU(input_channel, last_channel, kernel=1,
                                   kw=kw))
        self.features = pnn.Sequential(*features)
        if with_pool:
            self.pool = pnn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = pnn.Sequential(
                pnn.Dropout(0.2, generator=kw["generator"]),
                pnn.Linear(last_channel, num_classes, **kw))
        name_parameters(self)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1, -1))
        return x


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV2(scale=scale, **kwargs)
