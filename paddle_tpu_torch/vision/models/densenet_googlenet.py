"""DenseNet and GoogLeNet.

Port of ``paddle_tpu/vision/models/densenet_googlenet.py:17-187``.
DenseNet-BC: each dense layer (batch norm, ReLU, a 1 x 1 bottleneck of
``bn_size * growth`` channels, batch norm, ReLU, a 3 x 3 convolution of
``growth``) concatenates its output to its input; transitions halve the
channels and the resolution.  GoogLeNet (Inception v1) returns ``(out,
aux1, aux2)``: the two auxiliary heads run only in training mode with
``num_classes > 0`` and are None otherwise (:170-184); its dropout rates
are the reference's fixed 0.7 (the heads) and 0.2, its pools pass
``ceil_mode=True``, which the reference ignores (they floor), and so does
the port.  Dropout masks come from the model's generator.  Every relu
is a ``ReLU`` layer (the reference's ``_DenseLayer`` calls ``F.relu``;
the layer holds no state), so forward hooks see each call.
"""
from __future__ import annotations

import torch
from torch import nn

from ... import nn as pnn
from ...nn import functional as F
from ...nn.layer.common import flatten
from ._common import layer_kwargs, name_parameters, no_pretrained

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201", "GoogLeNet", "googlenet"]

_DENSE_CFG = {
    121: (64, 32, (6, 12, 24, 16)),
    161: (96, 48, (6, 12, 36, 24)),
    169: (64, 32, (6, 12, 32, 32)),
    201: (64, 32, (6, 12, 48, 32)),
}


def _bn(c, kw):
    return pnn.BatchNorm2D(c, device=kw["device"], dtype=kw["dtype"])


class _DenseLayer(nn.Module):
    def __init__(self, inp, growth, bn_size=4, drop=0.0, *, kw):
        super().__init__()
        self.norm1 = _bn(inp, kw)
        self.conv1 = pnn.Conv2D(inp, bn_size * growth, 1, bias_attr=False,
                                **kw)
        self.norm2 = _bn(bn_size * growth, kw)
        self.conv2 = pnn.Conv2D(bn_size * growth, growth, 3, padding=1,
                                bias_attr=False, **kw)
        self.relu = pnn.ReLU()
        self.drop = drop
        self.generator = kw["generator"]

    def forward(self, x):
        out = self.conv1(self.relu(self.norm1(x)))
        out = self.conv2(self.relu(self.norm2(out)))
        if self.drop > 0 and self.training:
            out = F.dropout(out, self.drop, generator=self.generator)
        return torch.cat([x, out], 1)


class _Transition(nn.Sequential):
    def __init__(self, inp, oup, *, kw):
        super().__init__(_bn(inp, kw), pnn.ReLU(),
                         pnn.Conv2D(inp, oup, 1, bias_attr=False, **kw),
                         pnn.AvgPool2D(2, stride=2))


class DenseNet(nn.Module):
    def __init__(self, layers=121, bn_size=4, dropout=0.0, num_classes=1000,
                 with_pool=True, *, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        kw = layer_kwargs(device, dtype, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        init_f, growth, blocks = _DENSE_CFG[layers]
        feats = [pnn.Conv2D(3, init_f, 7, stride=2, padding=3,
                            bias_attr=False, **kw),
                 _bn(init_f, kw), pnn.ReLU(),
                 pnn.MaxPool2D(3, stride=2, padding=1)]
        ch = init_f
        for i, n in enumerate(blocks):
            for _ in range(n):
                feats.append(_DenseLayer(ch, growth, bn_size, dropout,
                                         kw=kw))
                ch += growth
            if i != len(blocks) - 1:
                feats.append(_Transition(ch, ch // 2, kw=kw))
                ch //= 2
        feats += [_bn(ch, kw), pnn.ReLU()]
        self.features = pnn.Sequential(*feats)
        if with_pool:
            self.pool = pnn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = pnn.Linear(ch, num_classes, **kw)
        name_parameters(self)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1))
        return x


def _densenet(layers, pretrained, kwargs):
    no_pretrained(pretrained)
    return DenseNet(layers, **kwargs)


def densenet121(pretrained=False, **kwargs):
    return _densenet(121, pretrained, kwargs)


def densenet161(pretrained=False, **kwargs):
    return _densenet(161, pretrained, kwargs)


def densenet169(pretrained=False, **kwargs):
    return _densenet(169, pretrained, kwargs)


def densenet201(pretrained=False, **kwargs):
    return _densenet(201, pretrained, kwargs)


class _BasicConv(nn.Sequential):
    def __init__(self, inp, oup, kernel, *, kw, **conv_kw):
        super().__init__(pnn.Conv2D(inp, oup, kernel, bias_attr=False,
                                    **conv_kw, **kw),
                         _bn(oup, kw), pnn.ReLU())


class _Inception(nn.Module):
    def __init__(self, inp, c1, c3r, c3, c5r, c5, pp, *, kw):
        super().__init__()
        self.b1 = _BasicConv(inp, c1, 1, kw=kw)
        self.b2 = pnn.Sequential(_BasicConv(inp, c3r, 1, kw=kw),
                                 _BasicConv(c3r, c3, 3, padding=1, kw=kw))
        self.b3 = pnn.Sequential(_BasicConv(inp, c5r, 1, kw=kw),
                                 _BasicConv(c5r, c5, 5, padding=2, kw=kw))
        self.b4 = pnn.Sequential(pnn.MaxPool2D(3, stride=1, padding=1),
                                 _BasicConv(inp, pp, 1, kw=kw))

    def forward(self, x):
        return torch.cat([self.b1(x), self.b2(x), self.b3(x), self.b4(x)],
                         1)


class GoogLeNet(nn.Module):
    def __init__(self, num_classes=1000, with_pool=True, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        kw = layer_kwargs(device, dtype, generator)
        gen = kw["generator"]
        self.num_classes = num_classes
        self.with_pool = with_pool

        def pool():
            return pnn.MaxPool2D(3, stride=2, ceil_mode=True)

        def inception(*widths):
            return _Inception(*widths, kw=kw)
        self.pre = pnn.Sequential(
            _BasicConv(3, 64, 7, stride=2, padding=3, kw=kw), pool(),
            _BasicConv(64, 64, 1, kw=kw),
            _BasicConv(64, 192, 3, padding=1, kw=kw), pool(),
        )
        self.i3a = inception(192, 64, 96, 128, 16, 32, 32)
        self.i3b = inception(256, 128, 128, 192, 32, 96, 64)
        self.pool3 = pool()
        self.i4a = inception(480, 192, 96, 208, 16, 48, 64)
        self.i4b = inception(512, 160, 112, 224, 24, 64, 64)
        self.i4c = inception(512, 128, 128, 256, 24, 64, 64)
        self.i4d = inception(512, 112, 144, 288, 32, 64, 64)
        self.i4e = inception(528, 256, 160, 320, 32, 128, 128)
        self.pool4 = pool()
        self.i5a = inception(832, 256, 160, 320, 32, 128, 128)
        self.i5b = inception(832, 384, 192, 384, 48, 128, 128)

        def aux(inp):
            return (pnn.Sequential(pnn.AdaptiveAvgPool2D(4),
                                   _BasicConv(inp, 128, 1, kw=kw)),
                    pnn.Sequential(pnn.Linear(128 * 16, 1024, **kw),
                                   pnn.ReLU(), pnn.Dropout(0.7, generator=gen),
                                   pnn.Linear(1024, num_classes, **kw)))

        if num_classes > 0:     # the aux heads never run without classes
            self.aux1_conv, self.aux1_fc = aux(512)
            self.aux2_conv, self.aux2_fc = aux(528)
        if with_pool:
            self.pool5 = pnn.AdaptiveAvgPool2D(1)
        self.dropout = pnn.Dropout(0.2, generator=gen)
        if num_classes > 0:
            self.fc = pnn.Linear(1024, num_classes, **kw)
        name_parameters(self)

    def forward(self, x):
        heads = self.training and self.num_classes > 0
        x = self.i3b(self.i3a(self.pre(x)))
        x = self.i4a(self.pool3(x))
        aux1 = self.aux1_fc(flatten(self.aux1_conv(x), 1)) if heads \
            else None
        x = self.i4d(self.i4c(self.i4b(x)))
        aux2 = self.aux2_fc(flatten(self.aux2_conv(x), 1)) if heads \
            else None
        x = self.i5b(self.i5a(self.pool4(self.i4e(x))))
        if self.with_pool:
            x = self.pool5(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(flatten(x, 1)))
        return x, aux1, aux2


def googlenet(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return GoogLeNet(**kwargs)
