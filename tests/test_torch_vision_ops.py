"""PyTorch/CUDA port: the sequence, detection, ROI and resize ops of
``npx``, ``deconvolution`` and the transposed convolution layers, against
the JAX package on the CPU.

Each case feeds the same seeded numpy inputs through ``mxnet_tpu.npx`` and
``mxnet_tpu_torch.npx`` and holds every output within ``RTOL`` (1e-5) of
its largest entry; where the op is differentiable, the gradients of
``sum(out * c)`` (``c`` seeded) into its float inputs too (``GRAD_RTOL``,
1e-5). ``box_nms`` is held exactly: its output is a selection of input
rows and -1. The ``cuda`` tests hold the card to the CPU at the same
tolerances.

The JAX package is imported inside the tests that use it, so
``pytest --noconftest tests/test_torch_vision_ops.py -m cuda`` collects this
file on a machine without JAX.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import np as tnp
from mxnet_tpu_torch import npx as tnpx
from mxnet_tpu_torch.gluon import nn as tnn

RTOL = 1e-5
GRAD_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _rel(got, want):
    got = onp.asarray(got, dtype="float64")
    want = onp.asarray(want, dtype="float64")
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(abs(got - want).max(initial=0.0) /
                 max(abs(want).max(initial=0.0), 1e-30))


def _corner_boxes(rng, shape):
    a = rng.uniform(0, 1, shape + (2,))
    wh = rng.uniform(0.05, 0.5, shape + (2,))
    return onp.concatenate([a, a + wh], -1).astype("float32")


def _nms_rows(rng, b, n):
    """(b, n, 6) rows ``[cls, score, x1, y1, x2, y2]`` with clustered boxes,
    so that suppression chains occur."""
    centers = rng.uniform(0.2, 0.8, (b, 4, 2))
    pick = rng.randint(0, 4, (b, n))
    xy = onp.take_along_axis(centers, pick[..., None], 1) + \
        rng.normal(0, 0.03, (b, n, 2))
    wh = rng.uniform(0.15, 0.25, (b, n, 2))
    cls = rng.randint(0, 3, (b, n, 1)).astype("float64")
    score = rng.uniform(0, 1, (b, n, 1))
    return onp.concatenate([cls, score, xy - wh / 2, xy + wh / 2],
                           -1).astype("float32")


def _rois(rng, r, batch, size):
    x1 = rng.uniform(0, size * 0.6, (r, 2))
    x2 = x1 + rng.uniform(1, size * 0.4, (r, 2))
    b = rng.randint(0, batch, (r, 1)).astype("float64")
    return onp.concatenate([b, x1, x2], 1).astype("float32")


def _rand(rng, *shape):
    return rng.randn(*shape).astype("float32")


# (case id, op name, inputs from a RandomState, attributes, inputs that
# take gradients)
CASES = [
    ("iou_corner", "box_iou",
     lambda r: [_corner_boxes(r, (5,)), _corner_boxes(r, (7,))], {}, (0, 1)),
    ("iou_center_batched", "box_iou",
     lambda r: [_corner_boxes(r, (2, 4)), _corner_boxes(r, (2, 3))],
     {"format": "center"}, (0, 1)),
    ("nms_classes", "box_nms", lambda r: [_nms_rows(r, 1, 24)[0]],
     {"overlap_thresh": 0.3, "id_index": 0, "score_index": 1,
      "coord_start": 2}, ()),
    ("nms_batch_topk", "box_nms", lambda r: [_nms_rows(r, 3, 30)],
     {"overlap_thresh": 0.3, "topk": 8, "valid_thresh": 0.2, "id_index": 0,
      "score_index": 1, "coord_start": 2}, ()),
    ("nms_force_background", "box_nms", lambda r: [_nms_rows(r, 2, 20)],
     {"overlap_thresh": 0.4, "id_index": 0, "background_id": 0,
      "force_suppress": True}, ()),
    ("nms_to_center", "box_nms", lambda r: [_nms_rows(r, 2, 16)],
     {"overlap_thresh": 0.4, "out_format": "center"}, ()),
    ("nms_no_id", "box_nms", lambda r: [_nms_rows(r, 2, 16)],
     {"overlap_thresh": 0.4, "topk": 40}, ()),
    ("encode", "box_encode",
     lambda r: [r.choice([-1.0, 0.0, 1.0], (2, 6)).astype("float32"),
                r.randint(0, 3, (2, 6)).astype("float32"),
                _corner_boxes(r, (2, 6)), _corner_boxes(r, (2, 3))],
     {}, (2, 3)),
    ("decode_center_clip", "box_decode",
     lambda r: [0.5 * _rand(r, 2, 6, 4),
                onp.abs(_rand(r, 2, 6, 4)) + 0.1], {"clip": 0.3}, (0, 1)),
    ("decode_corner", "box_decode",
     lambda r: [0.5 * _rand(r, 2, 6, 4), _corner_boxes(r, (2, 6))],
     {"format": "corner"}, (0, 1)),
    ("roi_pooling", "roi_pooling",
     lambda r: [_rand(r, 2, 3, 12, 12), _rois(r, 5, 2, 24)],
     {"pooled_size": (3, 2), "spatial_scale": 0.5}, (0,)),
    ("roi_align", "roi_align",
     lambda r: [_rand(r, 2, 3, 12, 12), _rois(r, 5, 2, 24)],
     {"pooled_size": (3, 2), "spatial_scale": 0.5, "sample_ratio": 2},
     (0,)),
    ("roi_align_aligned", "roi_align",
     lambda r: [_rand(r, 2, 3, 12, 12), _rois(r, 4, 2, 12)],
     {"pooled_size": (2, 2), "sample_ratio": 3, "aligned": True}, (0,)),
    ("upsampling_nearest", "upsampling", lambda r: [_rand(r, 2, 3, 4, 5)],
     {"scale": 2}, (0,)),
    ("upsampling_bilinear", "upsampling", lambda r: [_rand(r, 2, 3, 4, 5)],
     {"scale": 3, "sample_type": "bilinear"}, (0,)),
    ("resize_align", "bilinear_resize_2d", lambda r: [_rand(r, 2, 3, 5, 7)],
     {"height": 9, "width": 4}, (0,)),
    ("resize_half_pixel", "bilinear_resize_2d",
     lambda r: [_rand(r, 2, 3, 5, 7)],
     {"scale_height": 1.6, "scale_width": 0.5, "align_corners": False}, (0,)),
    ("moments_axes", "moments", lambda r: [_rand(r, 3, 4, 5)],
     {"axes": (0, 2), "keepdims": True}, (0,)),
    ("moments_all", "moments", lambda r: [_rand(r, 3, 4)], {}, (0,)),
    ("seq_mask", "sequence_mask",
     lambda r: [_rand(r, 6, 3, 4), onp.array([2, 6, 0], "float32")],
     {"value": -1.0}, (0,)),
    ("seq_mask_axis1", "sequence_mask",
     lambda r: [_rand(r, 3, 6, 4), onp.array([1, 4, 6], "float32")],
     {"axis": 1}, (0,)),
    ("seq_reverse", "sequence_reverse",
     lambda r: [_rand(r, 6, 3, 4), onp.array([2, 6, 5], "float32")], {},
     (0,)),
    ("seq_reverse_all", "sequence_reverse", lambda r: [_rand(r, 6, 3)], {},
     (0,)),
    ("seq_last", "sequence_last",
     lambda r: [_rand(r, 6, 3, 4), onp.array([2, 6, 1], "float32")], {},
     (0,)),
    ("seq_last_all", "sequence_last", lambda r: [_rand(r, 3, 6, 4)],
     {"axis": 1}, (0,)),
    ("batch_dot_t", "batch_dot",
     lambda r: [_rand(r, 2, 4, 3), _rand(r, 2, 5, 4)],
     {"transpose_a": True, "transpose_b": True}, (0, 1)),
    ("deconv2d", "deconvolution",
     lambda r: [_rand(r, 2, 4, 5, 6), _rand(r, 4, 3, 3, 3), _rand(r, 3)],
     {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "adj": (1, 0),
      "num_filter": 3}, (0, 1, 2)),
    ("deconv2d_groups_dilate", "deconvolution",
     lambda r: [_rand(r, 2, 4, 5, 5), _rand(r, 4, 3, 2, 3)],
     {"kernel": (2, 3), "stride": (1, 2), "dilate": (2, 1), "num_filter": 6,
      "num_group": 2, "no_bias": True}, (0, 1)),
    ("deconv2d_nhwc", "deconvolution",
     lambda r: [_rand(r, 2, 5, 6, 4), _rand(r, 4, 3, 3, 3), _rand(r, 3)],
     {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "num_filter": 3,
      "layout": "NHWC"}, (0, 1, 2)),
    ("deconv2d_adj_past_stride", "deconvolution",
     lambda r: [_rand(r, 1, 2, 4, 4), _rand(r, 2, 3, 3, 3), _rand(r, 3)],
     {"kernel": (3, 3), "stride": (1, 1), "pad": (2, 0), "adj": (1, 2),
      "num_filter": 3}, (0, 1, 2)),
    ("deconv1d", "deconvolution",
     lambda r: [_rand(r, 2, 3, 7), _rand(r, 3, 2, 4), _rand(r, 2)],
     {"kernel": (4,), "stride": (3,), "pad": (1,), "adj": (2,),
      "num_filter": 2}, (0, 1, 2)),
    ("deconv3d", "deconvolution",
     lambda r: [_rand(r, 1, 2, 3, 4, 3), _rand(r, 2, 2, 2, 3, 2)],
     {"kernel": (2, 3, 2), "stride": (2, 1, 2), "num_filter": 2,
      "no_bias": True}, (0, 1)),
]


def _outs(res):
    return list(res) if isinstance(res, (list, tuple)) else [res]


def _run(pkg, name, inputs, attrs, grads, seed):
    """Outputs and the gradients of sum(out * c) into ``grads``, as numpy,
    through ``pkg`` (the JAX package or the port)."""
    mod_np, mod_npx, ag = pkg
    arrs = [mod_np.array(a) for a in inputs]
    for i in grads:
        arrs[i].attach_grad()
    with ag.record():
        outs = _outs(getattr(mod_npx, name)(*arrs, **attrs))
        if grads:
            rng = onp.random.RandomState(seed)
            loss = None
            for o in outs:
                c = mod_np.array(onp.asarray(rng.randn(*o.shape),
                                             dtype="float32"))
                t = (o * c).sum()
                loss = t if loss is None else loss + t
    if grads:
        loss.backward()
    return ([o.asnumpy() for o in outs],
            [arrs[i].grad.asnumpy() for i in grads])


def _jax_pkg():
    from mxnet_tpu import autograd, np, npx

    return np, npx, autograd


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_matches_reference(case):
    cid, name, make, attrs, grads = case
    inputs = make(onp.random.RandomState(sum(map(ord, cid))))
    want, want_g = _run(_jax_pkg(), name, inputs, attrs, grads, 5)
    got, got_g = _run((tnp, tnpx, tag), name, inputs, attrs, grads, 5)
    for g, w in zip(got, want):
        if name == "box_nms":
            onp.testing.assert_array_equal(g, w)
        else:
            assert _rel(g, w) <= RTOL, cid
    for g, w in zip(got_g, want_g):
        assert _rel(g, w) <= GRAD_RTOL, cid


def test_box_nms_suppression_chain():
    """A chain a > b > c where b suppresses c only if b is kept: c survives
    once a has removed b (the sweep's order matters)."""
    rows = onp.array([[0, 0.9, 0.0, 0.0, 1.0, 1.0],
                      [0, 0.8, 0.3, 0.0, 1.3, 1.0],
                      [0, 0.7, 0.6, 0.0, 1.6, 1.0],
                      [0, 0.6, 0.9, 0.0, 1.9, 1.0]], "float32")
    got = tnpx.box_nms(tnp.array(rows), overlap_thresh=0.4, id_index=0)
    kept = got.asnumpy()[:, 1]
    onp.testing.assert_array_equal(
        kept, onp.array([0.9, 0.7, -1, -1], "float32"))


LAYERS = [
    ("Conv1DTranspose", dict(channels=3, kernel_size=3, strides=2,
                             padding=1, output_padding=1, in_channels=2),
     (2, 2, 5)),
    ("Conv2DTranspose", dict(channels=4, kernel_size=(3, 2), strides=(2, 1),
                             padding=(1, 0), groups=2, in_channels=2),
     (2, 2, 4, 5)),
    ("Conv3DTranspose", dict(channels=2, kernel_size=2, strides=2,
                             in_channels=3, use_bias=False),
     (1, 3, 2, 3, 2)),
]


@pytest.mark.parametrize("layer", LAYERS, ids=[c[0] for c in LAYERS])
def test_transposed_conv_layers(layer):
    """The layers (reference conv_layers.py:117-143) with one set of
    weights: output and the input's and every weight's gradient."""
    import mxnet_tpu as mx
    from mxnet_tpu import autograd as jag
    from mxnet_tpu import np as jnp_
    from mxnet_tpu.gluon import nn as jnn

    name, kw, shape = layer
    rng = onp.random.RandomState(3)
    jl, tl = getattr(jnn, name)(**kw), getattr(tnn, name)(**kw)
    jl.initialize()
    tl.initialize()
    jparams, tparams = jl.collect_params(), tl.collect_params()
    assert sorted(jparams) == sorted(tparams)
    for k in jparams:
        assert tuple(jparams[k].shape) == tuple(tparams[k].shape), k
        w = _rand(rng, *jparams[k].shape)
        jparams[k].set_data(jnp_.array(w))
        tparams[k].set_data(tnp.array(w))
    x = _rand(rng, *shape)
    jx, tx = jnp_.array(x), tnp.array(x)
    jx.attach_grad()
    tx.attach_grad()
    with jag.record():
        jy = jl(jx)
        (jy * jy).sum().backward()
    with tag.record():
        ty = tl(tx)
        (ty * ty).sum().backward()
    assert _rel(ty.asnumpy(), jy.asnumpy()) <= RTOL
    assert _rel(tx.grad.asnumpy(), jx.grad.asnumpy()) <= GRAD_RTOL
    for k in jparams:
        assert _rel(tparams[k].grad.detach().numpy(),
                    jparams[k].grad().asnumpy()) <= GRAD_RTOL, k
    del mx


# -- on the card -----------------------------------------------------------------
@pytest.fixture
def cuda():
    """The card, with TF32 off for the test (cuDNN's is on by default), so
    fp32 convolutions sum in fp32 as the CPU does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = old


CARD_CASES = [c for c in CASES if c[0] in (
    "nms_batch_topk", "nms_classes", "encode", "decode_center_clip",
    "roi_pooling", "roi_align", "upsampling_bilinear", "resize_align",
    "moments_axes", "seq_mask", "seq_reverse", "seq_last", "deconv2d",
    "deconv2d_adj_past_stride")]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=[c[0] for c in CARD_CASES])
def test_op_on_card(cuda, case):
    """Each op on the card against the CPU on the same inputs."""
    cid, name, make, attrs, grads = case
    inputs = make(onp.random.RandomState(sum(map(ord, cid))))
    want, want_g = _run((tnp, tnpx, tag), name, inputs, attrs, grads, 5)
    with tmx.gpu():
        got, got_g = _run((tnp, tnpx, tag), name, inputs, attrs, grads, 5)
    for g, w in zip(got + got_g, want + want_g):
        if name == "box_nms":
            onp.testing.assert_array_equal(g, w)
        else:
            assert _rel(g, w) <= RTOL, cid
