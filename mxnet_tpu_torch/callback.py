"""Training progress callbacks (``mx.callback``).

Counterpart of ``mxnet_tpu/callback.py`` (reference: python/mxnet/
callback.py: Speedometer, do_checkpoint, log_train_metric, ProgressBar).
Reports go to the ``mxnet_tpu_torch`` logger. A batch callback fires when
the step has been queued on the card, not when it has finished, so
Speedometer's numbers are queueing throughput unless ``sync=True``, which
waits for the card before each clock read.

The reference's report line carries the window's step accounting (its
``_telemetry_text``, from the ``telemetry.STEPS`` rows) when its telemetry
is on. The port has no step rows yet (ROADMAP A7), so the line is the one
the reference prints with telemetry off.
"""
from __future__ import annotations

import logging
import sys
import time

__all__ = ["Speedometer", "do_checkpoint", "log_train_metric",
           "ProgressBar"]

_LOG = logging.getLogger("mxnet_tpu_torch")


def _metric_text(metric):
    return "".join(f"\t{name}={val:.6f}"
                   for name, val in metric.get_name_value())


class Speedometer:
    """Log throughput every ``frequent`` batches.

    ``auto_reset`` clears the attached eval metric after each report so the
    printed value covers only the last window, not the whole epoch.
    ``sync=True`` blocks on all pending device work before each clock read,
    turning the numbers from queueing throughput into completion
    throughput.
    """

    def __init__(self, batch_size, frequent=50, auto_reset=True, sync=False):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self.sync = sync
        self._window_start = None
        self._last_batch = -1

    def __call__(self, param):
        if self.sync:
            from . import engine

            engine.wait_all()
        nbatch = param.nbatch
        if nbatch < self._last_batch or self._window_start is None:
            # new epoch (batch counter rewound): restart the clock
            self._window_start = time.time()
            self._last_batch = nbatch
            return
        self._last_batch = nbatch
        if nbatch == 0 or nbatch % self.frequent:
            return
        now = time.time()
        rate = self.frequent * self.batch_size / \
            max(now - self._window_start, 1e-9)
        self._window_start = now
        line = (f"Epoch[{param.epoch}] Batch [{nbatch}]\t"
                f"Speed: {rate:.2f} samples/sec")
        if param.eval_metric is not None:
            line += _metric_text(param.eval_metric)
            if self.auto_reset:
                param.eval_metric.reset()
        _LOG.info(line)


def do_checkpoint(prefix, period=1):
    """Epoch-end callback: save a checkpoint every ``period`` epochs."""
    from . import model

    def save(epoch, sym, net_or_params, trainer=None):
        if (epoch + 1) % period == 0:
            model.save_checkpoint(prefix, epoch + 1, sym, net_or_params)

    return save


def log_train_metric(period, auto_reset=False):
    """Batch-end callback: log the running train metric every ``period``."""

    def report(param):
        if param.eval_metric is None or param.nbatch % period:
            return
        for name, val in param.eval_metric.get_name_value():
            _LOG.info("Iter[%d] Batch[%d] Train-%s=%f",
                      param.epoch, param.nbatch, name, val)
        if auto_reset:
            param.eval_metric.reset()

    return report


class ProgressBar:
    """Draw an in-place text progress bar over ``total`` batches."""

    def __init__(self, total, length=40):
        self.total = max(total, 1)
        self.length = length

    def __call__(self, param):
        frac = min(param.nbatch / self.total, 1.0)
        n_full = int(round(frac * self.length))
        bar = "#" * n_full + "-" * (self.length - n_full)
        sys.stdout.write(f"\r[{bar}] {100.0 * frac:.1f}%")
        sys.stdout.flush()
