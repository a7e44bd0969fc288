"""Automatic mixed precision: the loss scalers only.

Counterpart of ``mxnet_tpu/amp/loss_scaler.py`` and of
``attach_loss_scaler`` (``mxnet_tpu/amp/__init__.py:94``), which the
compiled train step consults. The rest of the reference's AMP (``init``,
the autocast scope, ``scale_loss``) is not ported yet.
"""
from .loss_scaler import DynamicLossScaler, LossScaler, StaticLossScaler

__all__ = ["LossScaler", "StaticLossScaler", "DynamicLossScaler",
           "attach_loss_scaler"]


def attach_loss_scaler(optimizer_or_trainer, scaler=None):
    """Attach (or create) the loss scaler ``Trainer.compile_step``
    consults; returns it. An explicit ``scaler`` replaces any attached
    one."""
    if scaler is None:
        scaler = getattr(optimizer_or_trainer, "_amp_loss_scaler", None)
        if scaler is None:
            scaler = DynamicLossScaler()
    optimizer_or_trainer._amp_loss_scaler = scaler
    return scaler
