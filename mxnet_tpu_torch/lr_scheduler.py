"""Learning-rate schedules as pure functions of the update count.

Counterpart of ``mxnet_tpu/lr_scheduler.py``, carried over as it is: pure
Python, no tensors. Every schedule is a closed-form function of
``num_update`` — stateless and safe to evaluate at any step in any order —
with a ``base_lr`` attribute the optimizer may overwrite
(``set_learning_rate``), as in the reference.
"""
from __future__ import annotations

import math

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler"]


class LRScheduler:
    """Base: optional warmup ramp followed by the subclass decay curve.

    ``warmup_mode`` is ``'linear'`` (ramp from ``warmup_begin_lr`` to
    ``base_lr``) or ``'constant'`` (hold ``warmup_begin_lr``).
    """

    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0.0,
                 warmup_mode="linear"):
        if warmup_mode not in ("linear", "constant"):
            raise ValueError(f"unknown warmup_mode {warmup_mode!r}")
        self.base_lr, self.warmup_steps = base_lr, warmup_steps
        self.warmup_begin_lr, self.warmup_mode = warmup_begin_lr, warmup_mode

    @property
    def warmup_final_lr(self):
        return self.base_lr

    def get_warmup_lr(self, num_update):
        if self.warmup_mode == "constant":
            return self.warmup_begin_lr
        frac = num_update / max(self.warmup_steps, 1)
        return self.warmup_begin_lr + \
            (self.base_lr - self.warmup_begin_lr) * frac

    def _decay(self, num_update):
        """Post-warmup lr; ``num_update`` is the raw global update count."""
        raise NotImplementedError

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        return self._decay(num_update)


class FactorScheduler(LRScheduler):
    """lr = base_lr * factor^(number of completed ``step``-sized periods),
    floored at ``stop_factor_lr``. Closed form of the reference's stateful
    loop (decay fires when ``num_update`` first *exceeds* a period edge)."""

    def __init__(self, step, factor=1.0, stop_factor_lr=1e-8, base_lr=0.01,
                 **kw):
        super().__init__(base_lr, **kw)
        if step < 1:
            raise ValueError("step must be >= 1")
        self.step, self.factor = step, factor
        self.stop_factor_lr = stop_factor_lr

    def _decay(self, num_update):
        periods = max(0, (num_update - 1) // self.step)
        return max(self.stop_factor_lr, self.base_lr * self.factor**periods)


class MultiFactorScheduler(LRScheduler):
    """Multiply by ``factor`` each time ``num_update`` passes a milestone."""

    def __init__(self, step, factor=1.0, base_lr=0.01, **kw):
        super().__init__(base_lr, **kw)
        self.step = sorted(step)
        self.factor = factor

    def _decay(self, num_update):
        passed = sum(1 for edge in self.step if num_update > edge)
        return self.base_lr * self.factor**passed


class PolyScheduler(LRScheduler):
    """Polynomial decay from base_lr to final_lr over ``max_update``."""

    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0, **kw):
        super().__init__(base_lr, **kw)
        self.power, self.max_update, self.final_lr = pwr, max_update, final_lr

    def _decay(self, num_update):
        if num_update > self.max_update:
            return self.final_lr
        span = max(self.max_update - self.warmup_steps, 1)
        left = 1 - (num_update - self.warmup_steps) / span
        return self.final_lr + (self.base_lr - self.final_lr) * \
            left**self.power


class CosineScheduler(LRScheduler):
    """Half-cosine decay from base_lr to final_lr over ``max_update``."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0, **kw):
        super().__init__(base_lr, **kw)
        self.max_update, self.final_lr = max_update, final_lr

    def _decay(self, num_update):
        if num_update > self.max_update:
            return self.final_lr
        span = max(self.max_update - self.warmup_steps, 1)
        t = (num_update - self.warmup_steps) / span
        cos_out = 0.5 * (1 + math.cos(math.pi * t))
        return self.final_lr + (self.base_lr - self.final_lr) * cos_out
