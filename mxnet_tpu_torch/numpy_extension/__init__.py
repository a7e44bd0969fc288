"""mx.npx of the port — numpy_extension: NN operators and framework
controls on NDArrays.

Counterpart of ``mxnet_tpu/numpy_extension/__init__.py:1-405``, with the
reference's signatures: the framework controls (``set_np``, ``use_np``,
``waitall``, ``cpu``/``gpu``/``num_gpus``) and the NN ops of
:mod:`mxnet_tpu_torch.ops.nn` and :mod:`.ops._core`, each through
``ops.registry.invoke``. ``flash_attention``, ``multihead_attention`` and
``layer_norm`` reach the hand-written CUDA kernels for arrays on the card;
``convolution``, ``pooling``, ``adaptive_avg_pool2d`` and ``batch_norm``
run torch's convolution and pooling (cuDNN on the card) and the
reference's BatchNorm formula.

``group_norm``, ``instance_norm``, ``rms_norm``, ``smooth_l1`` and
``ctc_loss`` are the reference's formulas in plain torch (CTC as optax's
recursion); so are ``deconvolution`` (torch's transposed convolution),
``batch_dot``, the sequence ops, the vision and detection ops of
:mod:`mxnet_tpu_torch.ops.vision`, and ``foreach`` / ``while_loop`` /
``cond`` (:mod:`.control_flow`). ``custom`` is not ported (it raises
:class:`MXNetError` naming ROADMAP A10). Any other registered op is
reachable by name through :func:`__getattr__`.
"""
from __future__ import annotations

import torch

from .. import autograd as _ag
from .. import engine as _engine
from ..base import MXNetError
from ..context import cpu, current_context, gpu, num_gpus  # noqa: F401
from ..ndarray.ndarray import NDArray, array
from ..ops.registry import _OPS, apply_op as _op


def set_np(shape=True, array=True, dtype=False):
    """Reference parity: numpy semantics are always on."""
    return True


def reset_np():
    return True


def is_np_array():
    return True


def is_np_shape():
    return True


def use_np(func):
    return func


use_np_array = use_np


def waitall():
    _engine.wait_all()


def _nd(x):
    """``x`` as an NDArray: a tensor wrapped as it is, without a copy, so
    autograd sees the op; other data copied in by :func:`array`."""
    if isinstance(x, NDArray):
        return x
    if isinstance(x, torch.Tensor):
        return NDArray(x)
    return array(x)


def _not_ported(name, item):
    def f(*args, **kwargs):
        raise MXNetError(f"npx.{name} is not ported (ROADMAP {item})")

    f.__name__ = name
    return f


# -- NN ops ------------------------------------------------------------------
def fully_connected(data, weight, bias=None, num_hidden=0, no_bias=False,
                    flatten=True):
    args = [_nd(data), _nd(weight)]
    no_bias_eff = bias is None or no_bias
    if not no_bias_eff:
        args.append(_nd(bias))
    return _op("fully_connected", *args, no_bias=no_bias_eff, flatten=flatten,
               num_hidden=num_hidden)


def convolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                pad=(), num_filter=0, num_group=1, no_bias=False, layout=None,
                **kw):
    args = [_nd(data), _nd(weight)]
    no_bias_eff = bias is None or no_bias
    if not no_bias_eff:
        args.append(_nd(bias))
    return _op("convolution", *args, kernel=tuple(kernel),
               stride=tuple(stride), dilate=tuple(dilate), pad=tuple(pad),
               num_filter=num_filter, num_group=num_group,
               no_bias=no_bias_eff, layout=layout)


def deconvolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                  pad=(), adj=(), num_filter=0, num_group=1, no_bias=False,
                  layout=None, **kw):
    """Transposed convolution, weight (in, out / groups, *k); torch's
    (cuDNN on the card)."""
    args = [_nd(data), _nd(weight)]
    no_bias_eff = bias is None or no_bias
    if not no_bias_eff:
        args.append(_nd(bias))
    return _op("deconvolution", *args, kernel=tuple(kernel),
               stride=tuple(stride), dilate=tuple(dilate), pad=tuple(pad),
               adj=tuple(adj), num_filter=num_filter, num_group=num_group,
               no_bias=no_bias_eff, layout=layout)


def pooling(data, kernel=(), pool_type="max", stride=(), pad=(),
            global_pool=False, count_include_pad=True, layout=None,
            ceil_mode=False, **kw):
    return _op("pooling", _nd(data), kernel=tuple(kernel),
               pool_type=pool_type, stride=tuple(stride), pad=tuple(pad),
               global_pool=global_pool, count_include_pad=count_include_pad,
               layout=layout, ceil_mode=ceil_mode)


def adaptive_avg_pool2d(data, output_size=1):
    return _op("adaptive_avg_pool2d", _nd(data), output_size=output_size)


def batch_norm(x, gamma, beta, running_mean, running_var, eps=1e-5,
               momentum=0.9, fix_gamma=False, use_global_stats=False,
               output_mean_var=False, axis=1):
    """``(out, new_mean, new_var)``: batch stats only while training
    (``autograd.is_training()``) and not ``use_global_stats``."""
    use_batch = _ag.is_training() and not use_global_stats
    return _op("batch_norm", _nd(x), _nd(gamma), _nd(beta),
               _nd(running_mean), _nd(running_var), eps=eps,
               momentum=momentum, fix_gamma=fix_gamma,
               use_batch_stats=use_batch, axis=axis)


def layer_norm(data, gamma, beta, axis=-1, eps=1e-5):
    return _op("layer_norm", _nd(data), _nd(gamma), _nd(beta), axis=axis,
               eps=eps)


def group_norm(data, gamma, beta, num_groups=1, eps=1e-5):
    return _op("group_norm", _nd(data), _nd(gamma), _nd(beta),
               num_groups=num_groups, eps=eps)


def instance_norm(data, gamma, beta, eps=1e-5):
    return _op("instance_norm", _nd(data), _nd(gamma), _nd(beta), eps=eps)


def rms_norm(data, gamma, axis=-1, eps=1e-6):
    return _op("rms_norm", _nd(data), _nd(gamma), axis=axis, eps=eps)


def activation(data, act_type="relu"):
    return _op("activation", _nd(data), act_type=act_type)


def leaky_relu(data, gamma=None, act_type="leaky", slope=0.25, **kw):
    if act_type == "prelu":
        return _op("leaky_relu", _nd(data), _nd(gamma), act_type=act_type)
    return _op("leaky_relu", _nd(data), act_type=act_type, slope=slope)


def relu(data):
    return _op("relu", _nd(data))


def sigmoid(data):
    return _op("sigmoid", _nd(data))


def softmax(data, axis=-1, length=None, temperature=None, use_length=False):
    if length is not None:
        return _op("softmax", _nd(data), _nd(length), axis=axis,
                   temperature=temperature, use_length=True)
    return _op("softmax", _nd(data), axis=axis, temperature=temperature)


def log_softmax(data, axis=-1, temperature=None):
    return _op("log_softmax", _nd(data), axis=axis, temperature=temperature)


def masked_softmax(data, mask, axis=-1, temperature=1.0):
    return _op("masked_softmax", _nd(data), _nd(mask), axis=axis,
               temperature=temperature)


def dropout(data, p=0.5, mode="training", **kw):
    return _op("dropout", _nd(data), p=p, mode=mode,
               training=_ag.is_training() or mode == "always")


def embedding(data, weight, input_dim=0, output_dim=0, dtype="float32",
              sparse_grad=False):
    return _op("embedding", _nd(data), _nd(weight), input_dim=input_dim,
               output_dim=output_dim, sparse_grad=sparse_grad)


def one_hot(data, depth, on_value=1.0, off_value=0.0, dtype="float32"):
    return _op("one_hot", _nd(data), depth=depth, on_value=on_value,
               off_value=off_value, dtype=dtype)


def pick(data, index, axis=-1, mode="clip", keepdims=False):
    return _op("pick", _nd(data), _nd(index), axis=axis, mode=mode,
               keepdims=keepdims)


def topk(data, k=1, axis=-1, ret_typ="indices", is_ascend=False):
    return _op("topk", _nd(data), k=k, axis=axis, ret_typ=ret_typ,
               is_ascend=is_ascend)


def flash_attention(query, key, value, causal=False, scale=None):
    """Fused online-softmax attention over (B, H, T, D) operands: the
    hand-written flash kernels for arrays on the card."""
    return _op("flash_attention", _nd(query), _nd(key), _nd(value),
               causal=causal, scale=scale)


def multihead_attention(query, key, value, mask=None, num_heads=1,
                        dropout=0.0, causal=False, scale=None,
                        num_kv_heads=None):
    """Attention over (B, T, heads * D) projections; ``num_kv_heads``
    enables grouped-query / multi-query attention. A (B, 1, 1, Tk)
    key-padding mask rides the flash kernels through segment ids (a fully
    masked query row gives zeros there); any other mask takes the dense
    path (a ~uniform softmax for such a row)."""
    args = [_nd(query), _nd(key), _nd(value)]
    if mask is not None:
        args.append(_nd(mask))
    return _op("multihead_attention", *args, num_heads=num_heads,
               dropout=dropout, causal=causal, scale=scale,
               num_kv_heads=num_kv_heads)


def arange_like(data, start=0.0, step=1.0, axis=None):
    d = _nd(data)
    n = d.size if axis is None else d.shape[axis]
    return NDArray(torch.arange(n, device=d._data.device,
                                dtype=torch.float32) * step + start)


def gamma(data):
    return _op("gamma", _nd(data))


def gammaln(data):
    return _op("gammaln", _nd(data))


def erf(data):
    return _op("erf", _nd(data))


def erfinv(data):
    return _op("erfinv", _nd(data))


def stop_gradient(data):
    return _op("stop_gradient", _nd(data))


def smooth_l1(data, scalar=1.0):
    return _op("smooth_l1", _nd(data), scalar=scalar)


def ctc_loss(data, label, data_lengths=None, label_lengths=None,
             blank_label="first"):
    """CTC loss of (T, B, V) logits (reference :186); one value a row."""
    args = [_nd(data), _nd(label)]
    if data_lengths is not None:
        args.append(_nd(data_lengths))
    if label_lengths is not None:
        args.append(_nd(label_lengths))
    return _op("ctc_loss", *args, use_data_lengths=data_lengths is not None,
               use_label_lengths=label_lengths is not None,
               blank_label=blank_label)


def cast(data, dtype):
    return _nd(data).astype(dtype)


def reshape_like(lhs, rhs):
    return _nd(lhs).reshape(_nd(rhs).shape)


def broadcast_like(lhs, rhs):
    return _nd(lhs).broadcast_to(_nd(rhs).shape)


def slice_axis(data, axis=0, begin=0, end=None):
    key = [slice(None)] * _nd(data).ndim
    key[axis] = slice(begin, end)
    return _nd(data)[tuple(key)]


def slice_like(data, shape_like, axes=None):
    d, s = _nd(data), _nd(shape_like)
    key = []
    for i in range(d.ndim):
        if axes is None or i in axes:
            key.append(slice(0, s.shape[i]))
        else:
            key.append(slice(None))
    return d[tuple(key)]


def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    return _op("batch_dot", _nd(lhs), _nd(rhs), transpose_a=transpose_a,
               transpose_b=transpose_b)


def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    if sequence_length is not None:
        return _op("sequence_mask", _nd(data), _nd(sequence_length),
                   use_sequence_length=True, value=value, axis=axis)
    return _op("sequence_mask", _nd(data), use_sequence_length=False,
               value=value, axis=axis)


def sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                     axis=0):
    if sequence_length is not None:
        return _op("sequence_reverse", _nd(data), _nd(sequence_length),
                   use_sequence_length=True, axis=axis)
    return _op("sequence_reverse", _nd(data), use_sequence_length=False,
               axis=axis)


def sequence_last(data, sequence_length=None, use_sequence_length=False,
                  axis=0):
    if sequence_length is not None:
        return _op("sequence_last", _nd(data), _nd(sequence_length),
                   use_sequence_length=True, axis=axis)
    return _op("sequence_last", _nd(data), use_sequence_length=False,
               axis=axis)


# -- detection / vision ops (ops/vision.py) ---------------------------------
def box_iou(lhs, rhs, format="corner"):  # noqa: A002
    return _op("box_iou", _nd(lhs), _nd(rhs), format=format)


def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, background_id=-1,
            force_suppress=False, in_format="corner", out_format="corner"):
    return _op("box_nms", _nd(data), overlap_thresh=overlap_thresh,
               valid_thresh=valid_thresh, topk=topk, coord_start=coord_start,
               score_index=score_index, id_index=id_index,
               background_id=background_id, force_suppress=force_suppress,
               in_format=in_format, out_format=out_format)


def box_encode(samples, matches, anchors, refs,
               means=(0.0, 0.0, 0.0, 0.0), stds=(0.1, 0.1, 0.2, 0.2)):
    return _op("box_encode", _nd(samples), _nd(matches), _nd(anchors),
               _nd(refs), means=tuple(means), stds=tuple(stds))


def box_decode(data, anchors, std0=0.1, std1=0.1, std2=0.2, std3=0.2,
               clip=-1.0, format="center"):  # noqa: A002
    return _op("box_decode", _nd(data), _nd(anchors), std0=std0, std1=std1,
               std2=std2, std3=std3, clip=clip, format=format)


def roi_pooling(data, rois, pooled_size=(7, 7), spatial_scale=1.0):
    return _op("roi_pooling", _nd(data), _nd(rois),
               pooled_size=tuple(pooled_size), spatial_scale=spatial_scale)


def roi_align(data, rois, pooled_size=(7, 7), spatial_scale=1.0,
              sample_ratio=2, aligned=False):
    return _op("roi_align", _nd(data), _nd(rois),
               pooled_size=tuple(pooled_size), spatial_scale=spatial_scale,
               sample_ratio=sample_ratio, aligned=aligned)


def upsampling(data, scale=2, sample_type="nearest"):
    return _op("upsampling", _nd(data), scale=scale, sample_type=sample_type)


def bilinear_resize_2d(data, height=0, width=0, scale_height=None,
                       scale_width=None, align_corners=True):
    return _op("bilinear_resize_2d", _nd(data), height=height, width=width,
               scale_height=scale_height, scale_width=scale_width,
               align_corners=align_corners)


def moments(data, axes=None, keepdims=False):
    return _op("moments", _nd(data),
               axes=tuple(axes) if axes is not None else None,
               keepdims=keepdims)


# control flow (numpy_extension/control_flow.py)
from .control_flow import cond, foreach, while_loop  # noqa: E402,F401

# custom ops are ROADMAP A10
custom = _not_ported("custom", "A10")


def __getattr__(name):
    """Any other registered op by name (reference :390)."""
    if name not in _OPS:
        raise AttributeError(f"module 'mxnet_tpu_torch.numpy_extension' "
                             f"has no attribute {name!r}")

    def wrapper(*inputs, **attrs):
        out = attrs.pop("out", None)
        arrs = [_nd(x) if hasattr(x, "shape") or isinstance(x, (list, tuple))
                else x for x in inputs]
        return _op(name, *arrs, out=out, **attrs)

    wrapper.__name__ = name
    globals()[name] = wrapper
    return wrapper
