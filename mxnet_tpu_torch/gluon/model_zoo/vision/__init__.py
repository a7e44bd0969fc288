"""Vision model zoo of the port (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/__init__.py``): ResNet v1/v2 and
``get_model`` over them. The reference's other vision models are not
ported: ``get_model`` raises naming ROADMAP A9 for them."""
from __future__ import annotations

from ....base import MXNetError
from . import resnet as _resnet
from .resnet import *  # noqa: F401,F403
from .resnet import __all__ as _resnet_all

__all__ = [*_resnet_all, "get_model"]

_models = {name: getattr(_resnet, name) for name in _resnet_all
           if name.startswith("resnet") and name[6].isdigit()}

# the reference's other zoo names (vision/__init__.py:_register_models)
_NOT_PORTED = ("alexnet", "vgg11", "vgg13", "vgg16", "vgg19", "mlp",
               "densenet121", "densenet161", "densenet169", "densenet201",
               "mobilenet1.0", "mobilenet0.75", "mobilenet0.5",
               "mobilenet0.25", "mobilenetv2_1.0", "mobilenetv2_0.5",
               "squeezenet1.0", "squeezenet1.1", "inceptionv3",
               "ssd_300_mobilenet", "ssd_256_lite")


def get_model(name, **kwargs):
    """The zoo model ``name`` (any case) built with ``kwargs``."""
    name = name.lower()
    if name in _NOT_PORTED:
        raise MXNetError(f"model {name!r} is not ported (ROADMAP A9)")
    if name not in _models:
        raise MXNetError(f"model {name!r} not in zoo; available: "
                         f"{sorted(_models)}")
    return _models[name](**kwargs)
