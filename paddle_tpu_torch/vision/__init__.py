"""paddle.vision: the ported models (``models``) and detection ops
(``ops``).

Port of ``paddle_tpu/vision``; ``transforms`` and ``datasets`` are not
ported yet (they build on ``io.Dataset``, which comes with the
``io/`` DataLoader).
"""
from . import models, ops
from .models import (LeNet, ResNet, resnet18, resnet34, resnet50, resnet101,
                     resnet152)

__all__ = ["models", "ops", "LeNet", "ResNet", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152"]
