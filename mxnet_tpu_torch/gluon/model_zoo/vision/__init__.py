"""Vision model zoo of the port (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/__init__.py``): ResNet v1/v2, AlexNet,
VGG, the MNIST MLP, DenseNet, MobileNet v1/v2, SqueezeNet, Inception v3
and SSD, and ``get_model`` over the reference's names
(``_register_models``). Each model keeps the reference's parameter names,
so a ``.params`` file of either package loads into the other."""
from __future__ import annotations

from ....base import MXNetError
from . import resnet as _resnet
from .alexnet import AlexNet, alexnet
from .densenet import (DenseNet, densenet121, densenet161, densenet169,
                       densenet201)
from .inception import Inception3, inception_v3
from .mlp import MLP, mlp
from .mobilenet import (MobileNet, MobileNetV2, mobilenet0_5, mobilenet0_25,
                        mobilenet0_75, mobilenet1_0, mobilenet_v2_0_5,
                        mobilenet_v2_1_0)
from .resnet import *  # noqa: F401,F403
from .resnet import __all__ as _resnet_all
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1
from .ssd import SSD, ssd_256_lite, ssd_300_mobilenet, ssd_detect, ssd_target
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19

__all__ = [*_resnet_all, "AlexNet", "alexnet", "VGG", "vgg11", "vgg13",
           "vgg16", "vgg19", "MLP", "mlp", "DenseNet", "densenet121",
           "densenet161", "densenet169", "densenet201", "MobileNet",
           "MobileNetV2", "mobilenet1_0", "mobilenet0_75", "mobilenet0_5",
           "mobilenet0_25", "mobilenet_v2_1_0", "mobilenet_v2_0_5",
           "SqueezeNet", "squeezenet1_0", "squeezenet1_1", "Inception3",
           "inception_v3", "SSD", "ssd_300_mobilenet", "ssd_256_lite",
           "ssd_target", "ssd_detect", "get_model"]

_models = {name: getattr(_resnet, name) for name in _resnet_all
           if name.startswith("resnet") and name[6].isdigit()}
_models.update({
    "alexnet": alexnet, "vgg11": vgg11, "vgg13": vgg13,
    "vgg16": vgg16, "vgg19": vgg19, "mlp": mlp,
    "densenet121": densenet121, "densenet161": densenet161,
    "densenet169": densenet169, "densenet201": densenet201,
    "mobilenet1.0": mobilenet1_0, "mobilenet0.75": mobilenet0_75,
    "mobilenet0.5": mobilenet0_5, "mobilenet0.25": mobilenet0_25,
    "mobilenetv2_1.0": mobilenet_v2_1_0,
    "mobilenetv2_0.5": mobilenet_v2_0_5,
    "squeezenet1.0": squeezenet1_0, "squeezenet1.1": squeezenet1_1,
    "inceptionv3": inception_v3,
    "ssd_300_mobilenet": ssd_300_mobilenet,
    "ssd_256_lite": ssd_256_lite,
})


def get_model(name, **kwargs):
    """The zoo model ``name`` (any case) built with ``kwargs``."""
    name = name.lower()
    if name not in _models:
        raise MXNetError(f"model {name!r} not in zoo; available: "
                         f"{sorted(_models)}")
    return _models[name](**kwargs)
