"""Loss scalers for float16 training.

Counterpart of ``mxnet_tpu/amp/loss_scaler.py`` (whole): the scale the
loss is multiplied by before the backward, the overflow check on the scaled
gradients, and the dynamic rule that halves the scale on overflow and
doubles it after ``scale_window`` clean steps. bfloat16 needs no scaling.
"""
from __future__ import annotations

import torch

__all__ = ["LossScaler", "StaticLossScaler", "DynamicLossScaler"]


class LossScaler:
    def __init__(self, init_scale=2.0 ** 16):
        self.loss_scale = init_scale

    def has_overflow(self, params):
        """True when a gradient of ``params`` holds an inf or a NaN (reads
        each back: one host sync a parameter)."""
        for p in params:
            if getattr(p, "grad_req", "write") == "null" or p.grad is None:
                continue
            if not bool(torch.isfinite(p.grad).all()):
                return True
        return False

    def update_scale(self, overflow: bool):
        pass

    def replay(self, flags):
        """Apply the per-step overflow flags of one multi-step call in
        order; returns the number of clean steps."""
        clean = 0
        for f in flags:
            f = bool(f)
            self.update_scale(f)
            if not f:
                clean += 1
        return clean


class StaticLossScaler(LossScaler):
    pass


class DynamicLossScaler(LossScaler):
    def __init__(self, init_scale=2.0 ** 16, scale_factor=2.0,
                 scale_window=2000, tolerance=0.0):
        super().__init__(init_scale)
        self.scale_factor = scale_factor
        self.scale_window = scale_window
        self._unskipped = 0

    def update_scale(self, overflow: bool):
        if overflow:
            self.loss_scale = max(self.loss_scale / self.scale_factor, 1.0)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self.scale_window:
                self.loss_scale *= self.scale_factor
                self._unskipped = 0
