"""AlexNet, SqueezeNet, MobileNetV1 and ShuffleNetV2.

Port of ``paddle_tpu/vision/models/small_nets.py:18-248``.  AlexNet's
dropout rate is its argument, SqueezeNet's classifier dropout 0.5, the
masks drawn from the model's generator.  SqueezeNet's pools pass
``ceil_mode=True``, which the reference ignores (its pools floor), and so
does the port: the feature maps have the reference's sizes.
ShuffleNetV2's stride-1 unit passes the first half of its channels
through and transforms the second (:189-193); every unit ends in the
channel shuffle, a reshape to ``[n, 2, c / 2, h, w]``, a transpose and a
reshape back (:155-159).  Every relu is a ``ReLU`` layer (the
reference's ``_Fire`` calls ``F.relu``; the layer holds no state), so
forward hooks see each call.
"""
from __future__ import annotations

import torch
from torch import nn

from ... import nn as pnn
from ...nn.layer.common import flatten
from ._common import layer_kwargs, name_parameters, no_pretrained

__all__ = ["AlexNet", "alexnet", "SqueezeNet", "squeezenet1_0",
           "squeezenet1_1", "MobileNetV1", "mobilenet_v1", "ShuffleNetV2",
           "shufflenet_v2_x1_0"]


def _bn(c, kw):
    return pnn.BatchNorm2D(c, device=kw["device"], dtype=kw["dtype"])


class AlexNet(nn.Module):
    def __init__(self, num_classes=1000, dropout=0.5, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        kw = layer_kwargs(device, dtype, generator)
        gen = kw["generator"]
        self.features = pnn.Sequential(
            pnn.Conv2D(3, 64, 11, stride=4, padding=2, **kw), pnn.ReLU(),
            pnn.MaxPool2D(3, stride=2),
            pnn.Conv2D(64, 192, 5, padding=2, **kw), pnn.ReLU(),
            pnn.MaxPool2D(3, stride=2),
            pnn.Conv2D(192, 384, 3, padding=1, **kw), pnn.ReLU(),
            pnn.Conv2D(384, 256, 3, padding=1, **kw), pnn.ReLU(),
            pnn.Conv2D(256, 256, 3, padding=1, **kw), pnn.ReLU(),
            pnn.MaxPool2D(3, stride=2),
        )
        self.avgpool = pnn.AdaptiveAvgPool2D((6, 6))
        self.classifier = pnn.Sequential(
            pnn.Dropout(dropout, generator=gen),
            pnn.Linear(256 * 6 * 6, 4096, **kw), pnn.ReLU(),
            pnn.Dropout(dropout, generator=gen),
            pnn.Linear(4096, 4096, **kw), pnn.ReLU(),
            pnn.Linear(4096, num_classes, **kw),
        )
        name_parameters(self)

    def forward(self, x):
        x = self.avgpool(self.features(x))
        return self.classifier(flatten(x, 1))


def alexnet(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return AlexNet(**kwargs)


class _Fire(nn.Module):
    def __init__(self, inp, squeeze, e1, e3, *, kw):
        super().__init__()
        self.squeeze = pnn.Conv2D(inp, squeeze, 1, **kw)
        self.expand1 = pnn.Conv2D(squeeze, e1, 1, **kw)
        self.expand3 = pnn.Conv2D(squeeze, e3, 3, padding=1, **kw)
        self.relu = pnn.ReLU()

    def forward(self, x):
        x = self.relu(self.squeeze(x))
        return torch.cat([self.relu(self.expand1(x)),
                          self.relu(self.expand3(x))], 1)


class SqueezeNet(nn.Module):
    def __init__(self, version="1.0", num_classes=1000, with_pool=True, *,
                 device=None, dtype=torch.float32, generator=None):
        super().__init__()
        kw = layer_kwargs(device, dtype, generator)
        self.num_classes = num_classes

        def fire(*widths):
            return _Fire(*widths, kw=kw)

        def pool():
            return pnn.MaxPool2D(3, stride=2, ceil_mode=True)
        if version == "1.0":
            self.features = pnn.Sequential(
                pnn.Conv2D(3, 96, 7, stride=2, **kw), pnn.ReLU(), pool(),
                fire(96, 16, 64, 64), fire(128, 16, 64, 64),
                fire(128, 32, 128, 128), pool(),
                fire(256, 32, 128, 128), fire(256, 48, 192, 192),
                fire(384, 48, 192, 192), fire(384, 64, 256, 256), pool(),
                fire(512, 64, 256, 256),
            )
        else:
            self.features = pnn.Sequential(
                pnn.Conv2D(3, 64, 3, stride=2, **kw), pnn.ReLU(), pool(),
                fire(64, 16, 64, 64), fire(128, 16, 64, 64), pool(),
                fire(128, 32, 128, 128), fire(256, 32, 128, 128), pool(),
                fire(256, 48, 192, 192), fire(384, 48, 192, 192),
                fire(384, 64, 256, 256), fire(512, 64, 256, 256),
            )
        self.classifier = pnn.Sequential(
            pnn.Dropout(0.5, generator=kw["generator"]),
            pnn.Conv2D(512, num_classes, 1, **kw), pnn.ReLU(),
            pnn.AdaptiveAvgPool2D(1),
        )
        name_parameters(self)

    def forward(self, x):
        return flatten(self.classifier(self.features(x)), 1)


def squeezenet1_0(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return SqueezeNet("1.1", **kwargs)


class _DWSep(nn.Sequential):
    """Depthwise-separable block: a depthwise 3 x 3 and a pointwise 1 x 1
    convolution, each followed by batch norm and ReLU."""

    def __init__(self, inp, oup, stride, *, kw):
        super().__init__(
            pnn.Conv2D(inp, inp, 3, stride=stride, padding=1, groups=inp,
                       bias_attr=False, **kw),
            _bn(inp, kw), pnn.ReLU(),
            pnn.Conv2D(inp, oup, 1, bias_attr=False, **kw),
            _bn(oup, kw), pnn.ReLU(),
        )


class MobileNetV1(nn.Module):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=None, dtype=torch.float32, generator=None):
        super().__init__()
        kw = layer_kwargs(device, dtype, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool

        def c(ch):
            return max(8, int(ch * scale))

        cfg = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1),
               (512, 2)] + [(512, 1)] * 5 + [(1024, 2), (1024, 1)]
        layers = [pnn.Conv2D(3, c(32), 3, stride=2, padding=1,
                             bias_attr=False, **kw),
                  _bn(c(32), kw), pnn.ReLU()]
        inp = c(32)
        for oup, stride in cfg:
            layers.append(_DWSep(inp, c(oup), stride, kw=kw))
            inp = c(oup)
        self.features = pnn.Sequential(*layers)
        if with_pool:
            self.pool = pnn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = pnn.Linear(c(1024), num_classes, **kw)
        name_parameters(self)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(flatten(x, 1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV1(scale=scale, **kwargs)


def _channel_shuffle(x, groups):
    n, c, h, w = x.shape
    x = x.reshape(n, groups, c // groups, h, w).transpose(1, 2)
    return x.reshape(n, c, h, w)


class _ShuffleUnit(nn.Module):
    def __init__(self, inp, oup, stride, *, kw):
        super().__init__()
        self.stride = stride
        branch = oup // 2
        if stride == 2:
            self.branch1 = pnn.Sequential(
                pnn.Conv2D(inp, inp, 3, stride=2, padding=1, groups=inp,
                           bias_attr=False, **kw),
                _bn(inp, kw),
                pnn.Conv2D(inp, branch, 1, bias_attr=False, **kw),
                _bn(branch, kw), pnn.ReLU(),
            )
            b2_in = inp
        else:
            self.branch1 = None
            b2_in = inp // 2
        self.branch2 = pnn.Sequential(
            pnn.Conv2D(b2_in, branch, 1, bias_attr=False, **kw),
            _bn(branch, kw), pnn.ReLU(),
            pnn.Conv2D(branch, branch, 3, stride=stride, padding=1,
                       groups=branch, bias_attr=False, **kw),
            _bn(branch, kw),
            pnn.Conv2D(branch, branch, 1, bias_attr=False, **kw),
            _bn(branch, kw), pnn.ReLU(),
        )

    def forward(self, x):
        if self.stride == 2:
            out = torch.cat([self.branch1(x), self.branch2(x)], 1)
        else:
            half = x.shape[1] // 2
            out = torch.cat([x[:, :half], self.branch2(x[:, half:])], 1)
        return _channel_shuffle(out, 2)


class ShuffleNetV2(nn.Module):
    """``act`` is accepted and not read, as in the reference: every
    activation is ReLU."""

    def __init__(self, scale=1.0, act="relu", num_classes=1000,
                 with_pool=True, *, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        kw = layer_kwargs(device, dtype, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        stage_out = {0.25: [24, 24, 48, 96, 512],
                     0.5: [24, 48, 96, 192, 1024],
                     1.0: [24, 116, 232, 464, 1024],
                     1.5: [24, 176, 352, 704, 1024],
                     2.0: [24, 244, 488, 976, 2048]}[scale]
        self.conv1 = pnn.Sequential(
            pnn.Conv2D(3, stage_out[0], 3, stride=2, padding=1,
                       bias_attr=False, **kw),
            _bn(stage_out[0], kw), pnn.ReLU(),
        )
        self.maxpool = pnn.MaxPool2D(3, stride=2, padding=1)
        stages = []
        inp = stage_out[0]
        for i, repeats in enumerate((4, 8, 4)):
            oup = stage_out[i + 1]
            units = [_ShuffleUnit(inp, oup, 2, kw=kw)]
            units += [_ShuffleUnit(oup, oup, 1, kw=kw)
                      for _ in range(repeats - 1)]
            stages.append(pnn.Sequential(*units))
            inp = oup
        self.stages = pnn.LayerList(stages)
        self.conv5 = pnn.Sequential(
            pnn.Conv2D(inp, stage_out[-1], 1, bias_attr=False, **kw),
            _bn(stage_out[-1], kw), pnn.ReLU(),
        )
        if with_pool:
            self.pool = pnn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = pnn.Linear(stage_out[-1], num_classes, **kw)
        name_parameters(self)

    def forward(self, x):
        x = self.maxpool(self.conv1(x))
        for stage in self.stages:
            x = stage(x)
        x = self.conv5(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(flatten(x, 1))
        return x


def shufflenet_v2_x1_0(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return ShuffleNetV2(scale=1.0, **kwargs)
