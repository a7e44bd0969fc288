"""Int8 quantization after training: ops, calibration and ``quantize_net``.

Counterpart of ``mxnet_tpu/contrib/quantization.py``:

- the ops ``contrib_quantize`` (per tensor, or per slice of a channel axis),
  ``contrib_dequantize`` and ``quantized_fully_connected`` (a float input
  quantized with a calibrated ``act_scale``, an int8 x int8 -> int32
  product, a float output; :29-55, :283-301) and their wrappers
  ``quantize``, ``dequantize`` and ``calib_minmax`` (:58-86);
- calibration (:138-240): ``calibrate_net`` runs batches through a net and
  gathers each ``Dense``'s and ``_Conv``'s input statistics with forward
  pre-hooks, on the input's device: the largest magnitude and a
  2048-bin histogram of |x| (``_LayerStats``; binned by ``bincount`` with
  numpy's float32 formula, rebinned in float64 when the largest magnitude
  grows), reduced to a scale by absmax (``'naive'``) or by the KL-optimal
  threshold (``'entropy'``, the one ``_kl_threshold`` of
  :mod:`mxnet_tpu_torch.ops.npi_manip`). A hybridized block runs eagerly
  while it calibrates, as in the reference;
- ``quantize_net`` (:342-389) swaps each ``Dense`` and each NCHW 2-D
  ``_Conv`` that is not transposed for a ``_QuantizedDenseBlock`` in place.
  With calibrated scales a ``Dense`` runs ``quantized_fully_connected``
  (on the card cuBLASLt's int8 GEMM) and a convolution the reference's
  route: the codes carried in float32 through the float convolution
  (``_QuantizedConvCore``), so at ResNet's widths its sums are not exact
  (above 2^24), on either device. Without calibration the weights are
  dequantized on use.

The quantized blocks are port ``Block``s (``torch.nn.Module``s, so a
parent takes them as children): their int8 weights, scales and biases are
buffers, not parameters, so ``collect_params()`` and ``save_parameters``
leave them out as the reference's ``collect_params`` returning ``{}`` does,
and ``.to(device)`` moves them; ``hybridize``, ``cast`` and ``apply`` do
nothing, as in the reference. They take and return what the layer they
replace took and returned.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..ndarray.ndarray import unwrap
from ..ops import nn as F
from ..ops.nn import _Door
from ..ops.npi_manip import _kl_threshold
from ..ops.quantized_ops import (_I8MAX, _codes, _const, _recip, _sat,
                                 int8_matmul)
from ..ops.registry import apply_op, register
from ..gluon.block import Block

__all__ = ["quantize", "dequantize", "calib_minmax", "calibrate_net",
           "quantize_net", "QuantizedDense"]


@register("contrib_quantize")
def _quantize(scale=None, channel_axis=None):
    def f(x):
        if scale is not None:
            # XLA folds the division by the constant into its reciprocal
            return _codes(x * _recip(scale)), _const(scale, x)
        if channel_axis is not None:
            axes = tuple(a for a in range(x.dim()) if a != channel_axis)
            smax = x.abs().amax(dim=axes, keepdim=True) if axes else x.abs()
        else:
            smax = x.abs().max()
        s_ = smax.clamp_min(1e-12) * _recip(_I8MAX)
        return _codes(x / s_), s_.to(torch.float32)

    return f


@register("contrib_dequantize")
def _dequantize():
    return lambda q, scale: q.to(torch.float32) * scale


@register("quantized_fully_connected")
def _quantized_fc(act_scale=1.0, no_bias=False, flatten=True):
    """int8 activation x int8 weight -> int32 -> float32 rescale."""
    def f(x, qw, wscale, *bias):
        if flatten and x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        qx = _codes(x * _recip(act_scale))
        qw = _sat(qw, torch.int32) if qw.is_floating_point() else qw
        k = x.shape[-1]
        if qw.dtype == torch.int8:
            acc = int8_matmul(qx.reshape(-1, k), qw)
        else:       # codes outside int8: exact in float64, int32 wrapping
            acc = torch.matmul(qx.reshape(-1, k).to(torch.float64),
                               qw.to(torch.float64).t()).to(
                torch.int64).to(torch.int32)
        acc = acc.reshape(*qx.shape[:-1], qw.shape[0])
        out = acc.to(torch.float32) * (float(act_scale) *
                                       wscale.reshape(1, -1))
        return out + bias[0] if bias else out

    return f


def quantize(data, scale=None, channel_axis=None):
    """Symmetric int8 quantization; returns ``(q_int8, scale)``.
    ``channel_axis`` keeps a scale per slice of that axis (per output
    channel for a weight)."""
    return apply_op("contrib_quantize", data, scale=scale,
                    channel_axis=channel_axis)


def dequantize(qdata, scale):
    return apply_op("contrib_dequantize", qdata, scale)


def _is_data_batch(batch):
    """A ``DataBatch`` (its data in ``.data``); a tensor's ``.data`` is
    torch's own."""
    return hasattr(batch, "data") and not isinstance(batch, torch.Tensor)


def calib_minmax(net, data_iter, num_batches=10):
    """The largest |output| over ``num_batches`` batches (reference:
    calibrate with ``calib_mode='naive'``)."""
    ranges = []
    for i, batch in enumerate(data_iter):
        if i >= num_batches:
            break
        data = batch.data[0] if _is_data_batch(batch) else batch[0]
        ranges.append(float(unwrap(net(data)).abs().max().item()))
    return max(ranges) if ranges else 1.0


# ---------------------------------------------------------------------------
# calibration (reference :89-240)
# ---------------------------------------------------------------------------
_NUM_BINS = 2048
_NUM_QUANT = 128  # int8 positive levels


class _LayerStats:
    """One layer's input statistics, on the device of its inputs: the
    largest |x| seen and the histogram of |x| over [0, largest] in
    ``_NUM_BINS`` bins (int64)."""

    __slots__ = ("absmax", "hist", "samples", "_binned")

    def __init__(self):
        self.absmax = 0.0
        self.hist = None
        self.samples = 0
        self._binned = False     # the reference's ``hist.sum() != 0``

    def update(self, arr):
        self.samples += 1
        a = unwrap(arr).detach().to(torch.float32).abs().reshape(-1)
        dev = a.device
        if self.hist is None:
            self.hist = torch.zeros(_NUM_BINS, dtype=torch.int64, device=dev)
        m = float(a.max()) if a.numel() else 0.0
        if m > self.absmax:
            # rescale the histogram onto the new range: bin i moves to
            # int(i * old / new), in float64 as numpy's int64 * float
            if self._binned and self.absmax > 0:
                idx = (torch.arange(_NUM_BINS, dtype=torch.float64,
                                    device=dev) * (self.absmax / m)).to(
                    torch.int64).clamp(0, _NUM_BINS - 1)
                self.hist = torch.zeros_like(self.hist).index_add_(
                    0, idx, self.hist)
            self.absmax = m
        if self.absmax > 0:
            # numpy's a / absmax * 2047 in float32 (a weak Python float);
            # divided by a tensor, never by a Python number on the card
            b = a / torch.full((), self.absmax, dtype=torch.float32,
                               device=dev) * float(_NUM_BINS - 1)
            self.hist += torch.bincount(
                b.to(torch.int64).clamp(0, _NUM_BINS - 1),
                minlength=_NUM_BINS)
            self._binned = self._binned or a.numel() > 0

    def scale(self, mode):
        if mode == "entropy":
            t = _kl_threshold(self.hist, torch.tensor(
                self.absmax, dtype=torch.float64, device=self.hist.device),
                _NUM_QUANT)
            return float(t) / 127.0
        return (self.absmax or 1.0) / 127.0


def _layer_classes():
    from ..gluon.nn.basic_layers import Dense
    from ..gluon.nn.conv_layers import _Conv

    return Dense, _Conv


def _children(block):
    return [(n, c) for n, c in block._modules.items() if c is not None]


def calibrate_net(net, data_iter, num_batches=10, calib_mode="naive"):
    """Run up to ``num_batches`` batches through ``net`` and gather the
    INPUT statistics of every ``Dense`` and ``_Conv`` layer; returns
    ``{layer path: act_scale}``: absmax / 127 (``'naive'``, ``'minmax'``) or
    the KL-optimal threshold / 127 (``'entropy'``). A batch is its
    ``.data[0]``, its first entry, or itself."""
    Dense, _Conv = _layer_classes()
    if calib_mode not in ("naive", "minmax", "entropy"):
        raise MXNetError(f"unknown calib_mode {calib_mode!r}")
    targets = {}

    def _find(block, prefix=""):
        for name, child in _children(block):
            path = prefix + name
            if isinstance(child, (Dense, _Conv)):
                targets[path] = child
            else:
                _find(child, path + ".")

    _find(net)
    stats = {p: _LayerStats() for p in targets}
    # hybridized blocks replay their captured programs and never reach a
    # child's forward: calibration runs them eagerly, then restores them
    hybrid_state = []

    def _deactivate(block):
        if getattr(block, "_active", False):
            hybrid_state.append((block, dict(block._cached)))
            block._active = False
            block._cached = {}
        for _, child in _children(block):
            _deactivate(child)

    _deactivate(net)
    handles = []
    try:
        for path, layer in targets.items():
            handles.append(torch.nn.Module.register_forward_pre_hook(
                layer, lambda mod, args, _st=stats[path]:
                _st.update(args[0])))
        n = 0
        for batch in data_iter:
            if n >= num_batches:
                break
            data = batch.data[0] if _is_data_batch(batch) else (
                batch[0] if isinstance(batch, (tuple, list)) else batch)
            with torch.no_grad():
                net(data)
            n += 1
    finally:
        for h in handles:
            h.remove()
        for block, cached in hybrid_state:
            block._active = True
            block._cached = cached
    dead = [p for p, s in stats.items() if s.samples == 0]
    if dead:
        raise MXNetError(
            f"calibration saw no data for layers {dead} — the calibration "
            "batches never exercised them; widen the calibration set or "
            "exclude those layers")
    mode = "entropy" if calib_mode == "entropy" else "naive"
    return {p: s.scale(mode) for p, s in stats.items()}


# ---------------------------------------------------------------------------
# the quantized layers (reference :243-421)
# ---------------------------------------------------------------------------
_QFC = _Door("quantized_fully_connected")
_DEQ = _Door("contrib_dequantize")


class QuantizedDense(Block):
    """``Dense`` with int8 weights, one scale per output unit; with a
    calibrated activation scale its forward is a true int8 x int8 -> int32
    product."""

    _tensor_body = True

    def __init__(self, dense, act_scale=None):
        Dense, _ = _layer_classes()
        if not isinstance(dense, Dense):
            raise MXNetError("QuantizedDense wraps a Dense layer")
        super().__init__()
        self._units = dense._units
        self._flatten = dense._flatten
        self._activation = dense._activation
        q, s = quantize(dense.weight.data(), channel_axis=0)
        self.register_buffer("qweight", q._data.detach())
        self.register_buffer("wscale", s._data.detach())
        self.register_buffer("bias", None if dense.bias is None else
                             dense.bias.detach().clone())
        self.act_scale = act_scale

    def forward(self, x):
        if self.act_scale is not None:
            args = (x, self.qweight, self.wscale) + (
                () if self.bias is None else (self.bias,))
            out = _QFC.fn(act_scale=float(self.act_scale),
                          no_bias=self.bias is None,
                          flatten=self._flatten)(*args)
        else:
            out = F.fully_connected(x, _DEQ.fn()(self.qweight, self.wscale),
                                    self.bias, flatten=self._flatten)
        if self._activation:
            out = F.activation(out, act_type=self._activation)
        return out


class _QuantizedConvCore(Block):
    """A 2-D convolution with int8 weights (one scale per filter) and a
    calibrated activation scale: the codes carried in float32 through the
    float convolution, as the reference's."""

    _tensor_body = True

    def __init__(self, conv, act_scale=None):
        super().__init__()
        self._conv_attrs = dict(kernel=conv._kernel, stride=conv._stride,
                                dilate=conv._dilate, pad=conv._pad,
                                num_filter=conv._channels,
                                num_group=conv._groups, layout=conv._layout)
        self._activation = conv._activation
        q, s = quantize(conv.weight.data(), channel_axis=0)
        self.register_buffer("qweight", q._data.detach())
        self.register_buffer("wscale", s._data.detach())
        self.register_buffer("bias", None if conv.bias is None else
                             conv.bias.detach().clone())
        self.act_scale = act_scale

    def forward(self, x):
        if self.act_scale is not None:
            s = float(self.act_scale)
            # x / s in float32: a division by a tensor (on the card a
            # Python divisor would become a reciprocal's product)
            qx = torch.clamp(torch.round(x / torch.full(
                (), s, dtype=torch.float32, device=x.device)), -127, 127)
            out = F.convolution(qx, self.qweight.to(torch.float32), None,
                                **self._conv_attrs)
            out = out * (s * self.wscale.reshape(1, -1, 1, 1))
            if self.bias is not None:
                out = out + self.bias.reshape(1, -1, 1, 1)
        else:
            out = F.convolution(x, _DEQ.fn()(self.qweight, self.wscale),
                                self.bias, **self._conv_attrs)
        if self._activation is not None:
            out = F.activation(out, act_type=self._activation)
        return out


def quantize_net(net, quantized_dtype="int8", exclude_layers=None,
                 calib_data=None, calib_mode="naive", num_calib_batches=10):
    """Replace ``net``'s ``Dense`` and NCHW 2-D ``_Conv`` children (not
    transposed, initialized) with int8 versions, in place; returns ``net``.
    With ``calib_data`` the activation scales are calibrated first
    (``calib_mode``: ``'naive'`` absmax or ``'entropy'`` KL) and the layers
    run the static int8 path; without it the weights are quantized only and
    dequantized on use. ``exclude_layers``: paths left as they are."""
    if quantized_dtype != "int8":
        raise MXNetError("only int8 weight quantization is supported")
    Dense, _Conv = _layer_classes()
    exclude = set(exclude_layers or [])
    scales = {}
    if calib_data is not None:
        scales = calibrate_net(net, calib_data, num_calib_batches,
                               calib_mode)

    def _ready(layer):
        return layer.weight._ready() and not layer.weight.is_deferred

    def _convert(block, prefix=""):
        # a rewired block's captured programs are stale: the next call
        # captures through the quantized layers
        if hasattr(block, "_cached"):
            block._cached = {}
        for name, child in _children(block):
            path = prefix + name
            if path in exclude:
                continue
            if isinstance(child, Dense) and _ready(child) or \
                    isinstance(child, _Conv) and not child._transpose and \
                    child._layout == "NCHW" and len(child._kernel) == 2 and \
                    _ready(child):
                # other ranks and layouts stay fp32 rather than mis-scale
                setattr(block, name, _QuantizedDenseBlock(child,
                                                          scales.get(path)))
            else:
                _convert(child, path + ".")

    _convert(net)
    return net


class _QuantizedDenseBlock(Block):
    """The block that takes a quantized layer's place among its parent's
    children."""

    _tensor_body = True

    def __init__(self, layer, act_scale=None):
        Dense, _ = _layer_classes()
        super().__init__()
        if isinstance(layer, Dense):
            self._q = QuantizedDense(layer, act_scale)
        else:
            self._q = _QuantizedConvCore(layer, act_scale)

    def forward(self, x):
        return self._q(x)

    def hybridize(self, active=True, **kwargs):
        pass

    def cast(self, dtype):
        pass

    def apply(self, fn):
        return self
