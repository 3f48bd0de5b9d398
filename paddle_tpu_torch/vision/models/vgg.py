"""The VGG family.

Port of ``paddle_tpu/vision/models/vgg.py``: ``vgg11``, ``vgg13``,
``vgg16`` and ``vgg19`` (configurations A, B, D and E), each with or
without a batch norm after every convolution, then a 7 x 7 adaptive
average pool and the classifier (two 4096-wide ``Linear``s with ReLU and
dropout 0.5, the masks from the model's generator).
"""
from __future__ import annotations

import torch
from torch import nn

from ... import nn as pnn
from ...nn.layer.common import flatten
from ._common import layer_kwargs, name_parameters, no_pretrained

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19"]

_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512,
          512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
          512, 512, "M", 512, 512, 512, 512, "M"],
}


def _make_features(cfg, batch_norm, kw):
    layers = []
    in_c = 3
    for v in cfg:
        if v == "M":
            layers.append(pnn.MaxPool2D(2, 2))
        else:
            layers.append(pnn.Conv2D(in_c, v, 3, padding=1, **kw))
            if batch_norm:
                layers.append(pnn.BatchNorm2D(v, device=kw["device"],
                                              dtype=kw["dtype"]))
            layers.append(pnn.ReLU())
            in_c = v
    return pnn.Sequential(*layers)


class VGG(nn.Module):
    """``features`` is a module, or (``cfg``, ``batch_norm``) from which
    the constructors build it on this model's device."""

    def __init__(self, features, num_classes=1000, with_pool=True, *,
                 device=None, dtype=torch.float32, generator=None):
        super().__init__()
        kw = layer_kwargs(device, dtype, generator)
        if isinstance(features, tuple):
            features = _make_features(*features, kw)
        self.features = features
        self.with_pool = with_pool
        self.num_classes = num_classes
        if with_pool:
            self.avgpool = pnn.AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            gen = kw["generator"]
            self.classifier = pnn.Sequential(
                pnn.Linear(512 * 7 * 7, 4096, **kw), pnn.ReLU(),
                pnn.Dropout(generator=gen),
                pnn.Linear(4096, 4096, **kw), pnn.ReLU(),
                pnn.Dropout(generator=gen),
                pnn.Linear(4096, num_classes, **kw),
            )
        name_parameters(self)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1, -1))
        return x


def _vgg(cfg, pretrained, batch_norm, kwargs):
    no_pretrained(pretrained)
    return VGG((_CFGS[cfg], batch_norm), **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("A", pretrained, batch_norm, kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("B", pretrained, batch_norm, kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("D", pretrained, batch_norm, kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("E", pretrained, batch_norm, kwargs)
