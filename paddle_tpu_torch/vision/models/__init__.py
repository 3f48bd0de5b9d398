"""paddle.vision.models: LeNet, the ResNet family (ResNeXt and the wide
variants with it), VGG, MobileNetV1 and V2, AlexNet, SqueezeNet,
ShuffleNetV2, DenseNet and GoogLeNet.

Port of ``paddle_tpu/vision/models/``.  Parameter and buffer names and
shapes match the reference's ``state_dict`` (the batch norms' ``_mean``
and ``_variance`` included), so ``load_reference_state`` carries its
weights over unchanged.  Every model takes ``device`` (the CUDA device
unless ``device="cpu"``; no CUDA device raises), ``dtype`` and the
``torch.Generator`` its initial values and dropout masks are drawn from
(one seeded with 0 on the device when None), and names each parameter
(``layer1.0.conv1.weight``) in its ``.param_name`` for the optimizers.
``pretrained=True`` raises: nothing is downloaded.
"""
from .densenet_googlenet import (DenseNet, GoogLeNet, densenet121,
                                 densenet161, densenet169, densenet201,
                                 googlenet)
from .lenet import LeNet
from .mobilenet import MobileNetV2, mobilenet_v2
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34,
                     resnet50, resnet101, resnet152, resnext50_32x4d,
                     wide_resnet50_2, wide_resnet101_2)
from .small_nets import (AlexNet, MobileNetV1, ShuffleNetV2, SqueezeNet,
                         alexnet, mobilenet_v1, shufflenet_v2_x1_0,
                         squeezenet1_0, squeezenet1_1)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19

__all__ = ["LeNet", "ResNet", "resnet18", "resnet34", "resnet50",
           "resnet101", "resnet152", "BasicBlock", "BottleneckBlock",
           "wide_resnet50_2", "wide_resnet101_2", "resnext50_32x4d", "VGG",
           "vgg11", "vgg13", "vgg16", "vgg19", "MobileNetV2",
           "mobilenet_v2", "AlexNet", "alexnet", "SqueezeNet",
           "squeezenet1_0", "squeezenet1_1", "MobileNetV1", "mobilenet_v1",
           "ShuffleNetV2", "shufflenet_v2_x1_0", "DenseNet", "densenet121",
           "densenet161", "densenet169", "densenet201", "GoogLeNet",
           "googlenet"]
