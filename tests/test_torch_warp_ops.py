"""PyTorch/CUDA port: the warping and deformable op tier, the layout ops,
bipartite matching, the MultiBox trio and the deformable and pixel-shuffle
layers, against the JAX package on the CPU.

Each case feeds the same seeded numpy inputs through ``mxnet_tpu.npx`` and
``mxnet_tpu_torch.npx``. Tolerances, each with its reason:

- outputs: within ``RTOL`` (1e-5) of the tensor's largest entry (the same
  formulas in fp32; sums over other orders: the psroi bins are two
  contractions here, one masked sum there);
- gradients of ``sum(out * c)`` (``c`` seeded) into the float inputs,
  the sampling coordinates included: ``GRAD_RTOL`` (1e-5) of each largest
  entry;
- integer outputs (matches, class targets, masks) and the layout ops are
  held exactly;
- the anchors of ``multibox_prior`` within ``ANCHOR_ATOL`` (2^-22): the
  reference's XLA program contracts some of its multiply-adds into fused
  ones (one rounding), as its code generator chooses lane by lane, and the
  port rounds the product and the sum, as written; the two differ by the
  product's rounding (products below 2: at most 2^-23) and the sum's.

The gradients are also checked against central differences in float64
(``torch.autograd.gradcheck``) with the sampling coordinates kept away
from the integer lattice, where bilinear interpolation has kinks (the JAX
package's own finite-difference checks, tests/test_warp_ops.py:351-408).
The legacy names (``BilinearSampler``, ``_contrib_PSROIPooling``, ...) run
through ``mx.nd`` and through a Symbol JSON written by the JAX package.
``tests/torch_script_stn.py`` (the JAX package's STN example, imports
changed) reaches the JAX test's margin over the fixed warp.
The ``cuda`` tests hold the card to the CPU: outputs at ``RTOL``,
gradients within ``CARD_GRAD_RTOL`` (1e-4: the gathers' backward adds
with atomics there, in another order).

The JAX package is imported inside the tests that use it, so
``pytest --noconftest tests/test_torch_warp_ops.py -m cuda`` collects this
file on a machine without JAX.
"""
import json

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import np as tnp
from mxnet_tpu_torch import npx as tnpx
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.ops import get_op

RTOL = 1e-5
GRAD_RTOL = 1e-5
CARD_GRAD_RTOL = 1e-4
ANCHOR_ATOL = 2.0 ** -22


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


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.randn(*shape)).astype("float32")


def _rois(rng, r, batch, size):
    x1 = rng.uniform(0, size * 0.6, (r, 2))
    x2 = x1 + rng.uniform(1, size * 0.4, (r, 2))
    b = rng.randint(0, batch, (r, 1)).astype("float64")
    return onp.concatenate([b, x1, x2], 1).astype("float32")


def _boxes(rng, shape):
    a = rng.uniform(0, 0.8, shape + (2,))
    wh = rng.uniform(0.1, 0.4, shape + (2,))
    return onp.concatenate([a, a + wh], -1).astype("float32")


def _labels(rng, b, m, classes, n_valid):
    lab = -onp.ones((b, m, 5), "float32")
    for i, n in enumerate(n_valid):
        lab[i, :n, 0] = rng.randint(0, classes, n)
        lab[i, :n, 1:] = _boxes(rng, (n,))
    return lab


def _deform_inputs(rng, c, f, h, w, stride, dilate, pad, ng, dg, bias,
                   modulated=False):
    ho = (h + 2 * pad[0] - dilate[0] * 2 - 1) // stride[0] + 1
    wo = (w + 2 * pad[1] - dilate[1] * 2 - 1) // stride[1] + 1
    ins = [_rand(rng, 2, c, h, w), _rand(rng, 2, 2 * dg * 9, ho, wo,
                                          scale=0.6)]
    if modulated:
        ins.append(rng.uniform(0, 1, (2, dg * 9, ho, wo)).astype("float32"))
    ins.append(_rand(rng, f, c // ng, 3, 3, scale=0.3))
    if bias:
        ins.append(_rand(rng, f))
    attrs = {"kernel": (3, 3), "stride": stride, "dilate": dilate,
             "pad": pad, "num_filter": f, "num_group": ng,
             "num_deformable_group": dg, "no_bias": not bias}
    return ins, attrs


def _deform_case(cid, stride, dilate, pad, ng, dg, bias, modulated=False):
    name = "modulated_deformable_convolution" if modulated else \
        "deformable_convolution"
    ins = _deform_inputs(onp.random.RandomState(sum(map(ord, cid))), 4, 4, 9,
                         10, stride, dilate, pad, ng, dg, bias, modulated)
    return (cid, name, lambda r: ins[0], ins[1],
            tuple(range(len(ins[0]))), ())


# (case id, op name, inputs from a RandomState, attributes, inputs that
# take gradients, outputs held exactly; "anchors": within ANCHOR_ATOL)
CASES = [
    ("sampler", "bilinear_sampler",
     lambda r: [_rand(r, 2, 3, 6, 7),
                r.uniform(-1.15, 1.15, (2, 2, 5, 4)).astype("float32")],
     {}, (0, 1), ()),
    ("grid_affine", "grid_generator", lambda r: [_rand(r, 2, 6)],
     {"transform_type": "affine", "target_shape": (5, 4)}, (0,), ()),
    ("grid_warp", "grid_generator", lambda r: [_rand(r, 2, 2, 5, 6)],
     {"transform_type": "warp"}, (0,), ()),
    ("stn", "spatial_transformer",
     lambda r: [_rand(r, 2, 3, 8, 8),
                (onp.array([1, 0, 0, 0, 1, 0]) +
                 0.3 * r.randn(2, 6)).astype("float32")],
     {"target_shape": (5, 6)}, (0, 1), ()),
    # tests/test_warp_ops.py:215's grid
    ("corr_k1", "correlation",
     lambda r: [_rand(r, 2, 3, 8, 9), _rand(r, 2, 3, 8, 9)],
     {"kernel_size": 1, "max_displacement": 2, "stride1": 1, "stride2": 1,
      "pad_size": 2}, (0, 1), ()),
    ("corr_k3_strided", "correlation",
     lambda r: [_rand(r, 2, 3, 8, 9), _rand(r, 2, 3, 8, 9)],
     {"kernel_size": 3, "max_displacement": 2, "stride1": 2, "stride2": 2,
      "pad_size": 3}, (0, 1), ()),
    ("corr_abs", "correlation",
     lambda r: [_rand(r, 2, 3, 8, 9), _rand(r, 2, 3, 8, 9)],
     {"kernel_size": 1, "max_displacement": 1, "pad_size": 1,
      "is_multiply": False}, (0, 1), ()),
    # tests/test_warp_ops.py:456's attribute matrix, and :484
    _deform_case("dcn_s2_bias", (2, 2), (1, 1), (1, 1), 1, 1, True),
    _deform_case("dcn_s12_d21", (1, 2), (2, 1), (2, 0), 1, 1, False),
    _deform_case("dcn_groups_dg2", (1, 1), (2, 2), (2, 2), 2, 2, True),
    _deform_case("mdcn_groups_dg2", (1, 1), (1, 1), (0, 0), 2, 2, True,
                 modulated=True),
    _deform_case("mdcn_s2", (2, 2), (1, 1), (1, 1), 1, 1, False,
                 modulated=True),
    ("psroi", "psroi_pooling",
     lambda r: [_rand(r, 2, 2 * 9, 12, 12), _rois(r, 5, 2, 24)],
     {"spatial_scale": 0.5, "output_dim": 2, "pooled_size": 3,
      "group_size": 3}, (0,), ()),
    ("psroi_p4_g2", "psroi_pooling",
     lambda r: [_rand(r, 1, 3 * 4, 10, 11), _rois(r, 4, 1, 11)],
     {"output_dim": 3, "pooled_size": 4, "group_size": 2}, (0,), ()),
    # the reference unrolls P^2 spp^2 taps: small grids keep its compile
    # short
    ("dpsroi_trans", "deformable_psroi_pooling",
     lambda r: [_rand(r, 2, 4 * 9, 12, 12), _rois(r, 5, 2, 24),
                _rand(r, 5, 4, 3, 3)],
     {"spatial_scale": 0.5, "output_dim": 4, "group_size": 3,
      "pooled_size": 3, "trans_std": 0.1}, (0, 2), ()),
    ("dpsroi_no_trans", "deformable_psroi_pooling",
     lambda r: [_rand(r, 1, 2 * 4, 9, 9), _rois(r, 3, 1, 9)],
     {"output_dim": 2, "group_size": 2, "pooled_size": 2,
      "sample_per_part": 2, "no_trans": True}, (0,), ()),
    ("depth_to_space", "depth_to_space", lambda r: [_rand(r, 2, 12, 3, 4)],
     {"block_size": 2}, (0,), (0,)),
    ("space_to_depth", "space_to_depth", lambda r: [_rand(r, 2, 3, 6, 9)],
     {"block_size": 3}, (0,), (0,)),
    ("bipartite", "bipartite_matching",
     lambda r: [r.uniform(0, 1, (6, 4)).astype("float32")],
     {"threshold": 0.3}, (), (0, 1)),
    ("bipartite_batch_ascend_topk", "bipartite_matching",
     lambda r: [r.uniform(0, 1, (3, 7, 5)).astype("float32")],
     {"threshold": 0.6, "is_ascend": True, "topk": 4}, (), (0, 1)),
    ("prior", "multibox_prior", lambda r: [_rand(r, 2, 3, 5, 7)],
     {"sizes": (0.2, 0.35, 0.5), "ratios": (1.0, 2.0, 0.5)}, (), "anchors"),
    ("prior_steps_clip", "multibox_prior", lambda r: [_rand(r, 1, 2, 4, 3)],
     {"sizes": (0.6,), "ratios": (1.0, 3.0), "clip": True,
      "steps": (0.3, 0.25), "offsets": (0.4, 0.6)}, (), "anchors"),
    ("target", "multibox_target",
     lambda r: [_boxes(r, (1, 40)), _rand(r, 3, 4, 40),
                _labels(r, 3, 5, 3, (2, 5, 0))],
     {"overlap_threshold": 0.3}, (), (1, 2)),
    ("target_mining", "multibox_target",
     lambda r: [_boxes(r, (1, 60)), _rand(r, 2, 3, 60),
                _labels(r, 2, 4, 2, (3, 1))],
     {"overlap_threshold": 0.4, "negative_mining_ratio": 3.0}, (), (1, 2)),
    ("detection", "multibox_detection",
     lambda r: [onp.asarray(torch.softmax(torch.tensor(_rand(
         r, 2, 4, 30, scale=2.0)), 1)), _rand(r, 2, 120, scale=0.5),
         _boxes(r, (1, 30))],
     {"nms_threshold": 0.4, "threshold": 0.05, "nms_topk": 20}, (), ()),
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


def _check(cid, got, want, got_g, want_g, exact, grad_rtol):
    for i, (g, w) in enumerate(zip(got, want)):
        if exact == "anchors":
            assert abs(g - w).max() <= ANCHOR_ATOL, cid
        elif i in exact:
            onp.testing.assert_array_equal(g, w, err_msg=cid)
        else:
            assert _rel(g, w) <= RTOL, (cid, i, _rel(g, w))
    for g, w in zip(got_g, want_g):
        assert _rel(g, w) <= grad_rtol, (cid, _rel(g, w))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_matches_reference(case):
    cid, name, make, attrs, grads, exact = case
    inputs = make(onp.random.RandomState(sum(map(ord, cid))))
    want, want_g = _run(_jax_pkg(), name, inputs, attrs, grads, 5)
    got, got_g = _run((tnp, tnpx, tag), name, inputs, attrs, grads, 5)
    _check(cid, got, want, got_g, want_g, exact, GRAD_RTOL)


# -- gradients against central differences ------------------------------------
def _off_lattice(rng, shape, lo=0.15, hi=0.35):
    """Offsets whose fractional parts stay in (lo, hi), away from the
    bilinear kinks."""
    return torch.tensor(rng.randint(-1, 2, shape) + rng.uniform(lo, hi,
                                                                shape))


GRADCHECKS = [
    ("sampler", "bilinear_sampler", {},
     lambda r: [torch.tensor(r.randn(1, 2, 4, 4)),
                # grid points whose pixel coordinates (g + 1) 3 / 2 have
                # fractional parts in (0.15, 0.35)
                torch.tensor((r.randint(0, 3, (1, 2, 3, 3)) +
                              r.uniform(0.15, 0.35, (1, 2, 3, 3))) * 2 / 3
                             - 1)]),
    ("stn", "spatial_transformer", {"target_shape": (3, 3)},
     lambda r: [torch.tensor(r.randn(1, 2, 5, 5)),
                torch.tensor([[0.61, 0.02, 0.07, -0.03, 0.57, 0.11]],
                             dtype=torch.float64)]),
    ("dcn", "deformable_convolution",
     {"kernel": (3, 3), "num_filter": 2, "no_bias": True},
     lambda r: [torch.tensor(0.5 * r.randn(1, 2, 5, 5)),
                _off_lattice(r, (1, 18, 3, 3)),
                torch.tensor(0.3 * r.randn(2, 2, 3, 3))]),
    ("mdcn_bias", "modulated_deformable_convolution",
     {"kernel": (3, 3), "num_filter": 2, "pad": (1, 1),
      "num_deformable_group": 2},
     lambda r: [torch.tensor(0.5 * r.randn(1, 2, 4, 4)),
                _off_lattice(r, (1, 36, 4, 4)),
                torch.tensor(r.uniform(0.2, 0.9, (1, 18, 4, 4))),
                torch.tensor(0.3 * r.randn(2, 2, 3, 3)),
                torch.tensor(r.randn(2))]),
    ("corr", "correlation",
     {"kernel_size": 3, "max_displacement": 1, "pad_size": 2},
     lambda r: [torch.tensor(r.randn(1, 2, 4, 5)),
                torch.tensor(r.randn(1, 2, 4, 5))]),
]


@pytest.mark.parametrize("case", GRADCHECKS, ids=[c[0] for c in GRADCHECKS])
def test_gradients_against_central_differences(case):
    """float64 autograd against central differences of the op itself."""
    cid, name, attrs, make = case
    fn = get_op(name).fn(**attrs)
    args = [a.double().requires_grad_(True)
            for a in make(onp.random.RandomState(sum(map(ord, cid))))]
    assert torch.autograd.gradcheck(fn, args, eps=1e-6, atol=1e-6,
                                    rtol=1e-4)


# -- MultiBox: the shared best anchor and mining's budget ---------------------
def _target_both(anchors, cls_preds, labels, **attrs):
    import mxnet_tpu as mx

    ins = (anchors, cls_preds, labels)
    want = [o.asnumpy() for o in mx.npx.multibox_target(
        *(mx.np.array(a) for a in ins), **attrs)]
    got = [o.asnumpy() for o in tnpx.multibox_target(
        *(tnp.array(a) for a in ins), **attrs)]
    return got, want


def _same_targets(got, want):
    """Masks and class targets exactly, the float loc targets at RTOL."""
    assert _rel(got[0], want[0]) <= RTOL
    onp.testing.assert_array_equal(got[1], want[1])
    onp.testing.assert_array_equal(got[2], want[2])


def test_shared_best_anchor_keeps_the_last_claim():
    """Two ground truths whose best anchor is the same anchor (1): the JAX
    package's scatter keeps the later one in label order, and so does the
    port; swapped, the other one."""
    anchors = onp.array([[[0.5, 0.5, 1.0, 1.0], [0.0, 0.0, 0.5, 0.5],
                          [0.0, 0.5, 0.5, 1.0]]], "float32")
    labels = onp.array([[[0, 0.05, 0.05, 0.45, 0.45],
                         [1, 0.0, 0.0, 0.4, 0.4],
                         [-1, -1, -1, -1, -1]]], "float32")
    cls_preds = onp.zeros((1, 3, 3), "float32")
    got, want = _target_both(anchors, cls_preds, labels,
                             overlap_threshold=0.95)
    _same_targets(got, want)
    onp.testing.assert_array_equal(got[2][0], [0.0, 2.0, 0.0])
    got, want = _target_both(anchors, cls_preds, labels[:, [1, 0, 2]],
                             overlap_threshold=0.95)
    _same_targets(got, want)
    onp.testing.assert_array_equal(got[2][0], [0.0, 1.0, 0.0])


def test_padding_row_writes_back_anchor_zero():
    """A padded row (IoU -1 everywhere) names anchor 0 and writes back
    the value it read: after a ground truth that claimed anchor 0 it
    undoes that claim, in the JAX package and in the port (kept as the
    reference has it)."""
    anchors = onp.array([[[0.0, 0.0, 0.5, 0.5], [0.5, 0.5, 1.0, 1.0]]],
                        "float32")
    labels = onp.array([[[1, 0.05, 0.05, 0.45, 0.45],
                         [-1, -1, -1, -1, -1]]], "float32")
    got, want = _target_both(anchors, onp.zeros((1, 3, 2), "float32"),
                             labels, overlap_threshold=0.95)
    _same_targets(got, want)
    onp.testing.assert_array_equal(got[2][0], [0.0, 0.0])
    got, want = _target_both(anchors, onp.zeros((1, 3, 2), "float32"),
                             labels[:, :1], overlap_threshold=0.95)
    _same_targets(got, want)
    onp.testing.assert_array_equal(got[2][0], [2.0, 0.0])


def test_mining_budget_and_stable_ranks():
    """Ties in the negatives' scores rank by position (a stable sort):
    with every score equal, the first ``ratio * num_pos`` negatives are
    kept."""
    rng = onp.random.RandomState(3)
    anchors = _boxes(rng, (1, 50))
    labels = _labels(rng, 2, 3, 2, (2, 3))
    cls_preds = onp.zeros((2, 3, 50), "float32")
    got, want = _target_both(anchors, cls_preds, labels,
                             overlap_threshold=0.5,
                             negative_mining_ratio=2.0)
    _same_targets(got, want)
    ct = got[2]
    for i in range(2):
        pos = ct[i] > 0
        neg = onp.flatnonzero(ct[i] == 0)
        assert len(neg) == min(2 * pos.sum(), (~pos).sum())
        onp.testing.assert_array_equal(neg, onp.flatnonzero(~pos)[:len(neg)])


# -- legacy names ----------------------------------------------------------------
LEGACY = [
    ("BilinearSampler", "sampler"), ("GridGenerator", "grid_affine"),
    ("SpatialTransformer", "stn"), ("Correlation", "corr_k3_strided"),
    ("_contrib_DeformableConvolution", "dcn_s2_bias"),
    ("_contrib_ModulatedDeformableConvolution", "mdcn_groups_dg2"),
    ("_contrib_PSROIPooling", "psroi"),
    ("_contrib_DeformablePSROIPooling", "dpsroi_trans"),
]
_BY_ID = {c[0]: c for c in CASES}


@pytest.mark.parametrize("legacy,cid", LEGACY, ids=[c[0] for c in LEGACY])
def test_legacy_names(legacy, cid):
    """``mx.nd.<legacy>`` in both packages, and a Symbol JSON of the JAX
    package's with its node named by the legacy name, loaded and run by
    the port."""
    import mxnet_tpu as mx

    _, name, make, attrs, _, _ = _BY_ID[cid]
    inputs = make(onp.random.RandomState(sum(map(ord, cid))))
    want = getattr(mx.nd, legacy)(*(mx.nd.array(a) for a in inputs),
                                  **attrs).asnumpy()
    got = getattr(tmx.nd, legacy)(*(tmx.nd.array(a) for a in inputs),
                                  **attrs).asnumpy()
    assert _rel(got, want) <= RTOL
    names = [f"x{i}" for i in range(len(inputs))]
    sym = getattr(mx.sym, legacy)(*(mx.sym.var(n) for n in names), **attrs)
    graph = json.loads(sym.tojson())
    for node in graph["nodes"]:
        if node["op"] == name:
            node["op"] = legacy
    loaded = tmx.sym.fromjson(json.dumps(graph))
    ex = loaded.bind(args={n: tnp.array(a) for n, a in zip(names, inputs)})
    assert _rel(ex.forward()[0].asnumpy(), want) <= RTOL


# -- the layers ------------------------------------------------------------------
LAYERS = [
    ("DeformableConvolution", dict(channels=4, kernel_size=3, padding=1,
                                   num_deformable_group=2,
                                   offset_weight_initializer="normal"),
     (2, 4, 7, 8)),
    ("ModulatedDeformableConvolution",
     dict(channels=6, kernel_size=(3, 3), strides=2, padding=1, groups=2,
          offset_weight_initializer="normal", activation="relu"),
     (2, 4, 9, 7)),
]


@pytest.mark.parametrize("layer", LAYERS, ids=[c[0] for c in LAYERS])
def test_deformable_layers(layer, tmp_path):
    """The layers (reference conv_layers.py:249-310) with one set of
    weights (the port's, saved and loaded by the JAX layer): names, output,
    and the input's and every weight's gradient."""
    from mxnet_tpu import autograd as jag
    from mxnet_tpu import np as jnp_
    from mxnet_tpu.gluon import nn as jnn

    name, kw, shape = layer
    rng = onp.random.RandomState(3)
    tl = getattr(tnn, name)(**kw)
    tl.initialize()
    x = _rand(rng, *shape)
    tl(tnp.array(x))
    tparams = tl.collect_params()
    for k, p in tparams.items():
        p.set_data(tnp.array(_rand(rng, *p.shape, scale=0.3)))
    path = str(tmp_path / "layer.params")
    tl.save_parameters(path)
    jl = getattr(jnn, name)(**kw)
    assert sorted(jl.collect_params()) == sorted(tparams)
    jl.load_parameters(path)        # no JAX initializer compiles
    jparams = jl.collect_params()
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


@pytest.mark.parametrize("ndim,factor,shape", [
    (1, 3, (2, 6, 5)), (2, (2, 3), (2, 12, 3, 4)), (3, 2, (1, 16, 2, 3, 2))],
    ids=["1d", "2d", "3d"])
def test_pixel_shuffle(ndim, factor, shape):
    """PixelShuffle1D/2D/3D (reference conv_layers.py:313-357): a
    permutation, held exactly, and its gradient."""
    from mxnet_tpu import autograd as jag
    from mxnet_tpu import np as jnp_
    from mxnet_tpu.gluon import nn as jnn

    cls = f"PixelShuffle{ndim}D"
    x = _rand(onp.random.RandomState(ndim), *shape)
    c = _rand(onp.random.RandomState(9), 1)
    jx, tx = jnp_.array(x), tnp.array(x)
    jx.attach_grad()
    tx.attach_grad()
    with jag.record():
        jy = getattr(jnn, cls)(factor)(jx)
        (jy * jy * float(c[0])).sum().backward()
    with tag.record():
        ty = getattr(tnn, cls)(factor)(tx)
        (ty * ty * float(c[0])).sum().backward()
    onp.testing.assert_array_equal(ty.asnumpy(), jy.asnumpy())
    onp.testing.assert_array_equal(tx.grad.asnumpy(), jx.grad.asnumpy())


# -- the STN example ---------------------------------------------------------------
def _stn_accuracies(epochs):
    """tests/torch_script_stn.py (``examples/stn_mnist.py``, imports
    changed) at tests/test_warp_ops.py:500's short setting: 256 digits,
    seed 7; the STN's train accuracy and the fixed warp's."""
    import torch_script_stn as script

    tmx.random.seed(7)
    onp.random.seed(7)
    xs, ys = script.make_translated_digits(256)
    return (script.train(True, xs, ys, epochs=epochs),
            script.train(False, xs, ys, epochs=epochs))


def test_stn_example_learns_localization():
    """The learned warp beats the fixed one by the JAX test's margin (0.1;
    the port measured 0.80 against 0.52 here), hybridized as the example
    runs it (on the CPU the body runs eagerly)."""
    acc_stn, acc_fixed = _stn_accuracies(30)
    assert acc_stn > acc_fixed + 0.1, (acc_stn, acc_fixed)


# -- on the card -----------------------------------------------------------------
@pytest.fixture
def cuda():
    """The card, with TF32 off for the test (cuDNN's and the matmuls'),
    so fp32 products sum in fp32 as the CPU does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = old


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_on_card(cuda, case):
    """Each op on the card against the CPU on the same inputs."""
    cid, name, make, attrs, grads, exact = case
    inputs = make(onp.random.RandomState(sum(map(ord, cid))))
    want, want_g = _run((tnp, tnpx, tag), name, inputs, attrs, grads, 5)
    with tmx.gpu():
        got, got_g = _run((tnp, tnpx, tag), name, inputs, attrs, grads, 5)
    _check(cid, got, want, got_g, want_g, exact, CARD_GRAD_RTOL)


@pytest.mark.cuda
def test_stn_example_on_card(cuda):
    """The STN example's short setting on the card, hybridized: its body
    builds ``mx.np.array([1, 0, 0, 0, 1, 0])`` from host data inside the
    captured program (kept on the card from the warm call)."""
    with tmx.gpu():
        acc_stn, acc_fixed = _stn_accuracies(30)
    assert acc_stn > acc_fixed + 0.1, (acc_stn, acc_fixed)


@pytest.mark.cuda
def test_shared_best_anchor_on_card(cuda):
    """The shared best anchor resolves on the card as on the CPU, and the
    same every time (a scatter-max of positions, not ``index_put_``'s
    arbitrary pick): many ground truths claiming the same few anchors.
    Masks and classes equal the CPU's exactly; the loc targets (a log and
    quotients) within RTOL; card runs bitwise equal to each other."""
    rng = onp.random.RandomState(4)
    anchors = _boxes(rng, (1, 8))
    labels = _labels(rng, 4, 64, 5, (64, 40, 17, 3))
    cls_preds = _rand(rng, 4, 6, 8)
    ins = (anchors, cls_preds, labels)
    want = [o.asnumpy() for o in tnpx.multibox_target(
        *(tnp.array(a) for a in ins), negative_mining_ratio=3.0)]
    with tmx.gpu():
        runs = [[o.asnumpy() for o in tnpx.multibox_target(
            *(tnp.array(a) for a in ins), negative_mining_ratio=3.0)]
            for _ in range(5)]
    _same_targets(runs[0], want)
    for got in runs[1:]:
        for g, w in zip(got, runs[0]):
            onp.testing.assert_array_equal(g, w)
