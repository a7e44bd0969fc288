"""Optimizer package (reference: ``mxnet_tpu/optimizer/``)."""
from .optimizer import (NAG, SGD, SGLD, Adam, AdaBelief, AdaDelta, AdaGrad,
                        Adamax, AdamW, DCASGD, FTML, Ftrl, GroupAdaGrad, LAMB,
                        LANS, LARS, Nadam, Optimizer, RMSProp, Signum, create,
                        register)
from .updater import Updater, get_updater

__all__ = ["Optimizer", "SGD", "Adam", "AdamW", "NAG", "RMSProp", "AdaGrad",
           "AdaDelta", "Adamax", "Nadam", "Ftrl", "FTML", "Signum", "LAMB",
           "GroupAdaGrad", "LARS", "LANS", "AdaBelief", "SGLD", "DCASGD",
           "create", "register", "Updater", "get_updater"]
