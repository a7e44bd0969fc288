"""Inputs and attributes for every name of the port's
``ops/quantized_ops.py`` and of ``contrib/quantization.py``'s ops (the
reference's 43 names, aliases included), and the runners over them.

Not a test module: ``tests/test_torch_quantized_ops.py`` holds each name
against the JAX package on these inputs, its ``cuda`` test holds the card
against the CPU, and ``chip_smoke.py`` phase 19 does the same on the H100.
It imports numpy and the runners of ``tests/torch_legacy_cases.py`` only,
so it runs where JAX is absent.

A case is ``torch_legacy_cases``' ``(build, attrs, grad, kind)``; the first
cases of a name follow ``tests/test_quantized_ops.py``'s shapes, the
others add attributes, devices' corners and the casts. A quantized tensor is
its int8 codes and its 0-d float32 ranges. Every output is compared by its
dtype: integer outputs (codes, accumulators, pooled codes, embeddings)
bitwise, float outputs (ranges, rescaled products) within ``FLOAT_RTOL`` of
the largest entry, dtypes equal. ``CAST`` cases feed out-of-range floats
(beyond int8 and int32, infinities, NaN) to every float -> integer cast the
reference makes; XLA saturates them (NaN to 0). An alias maps to its
target's name.
"""
import numpy as onp

import torch_legacy_cases as lc

FLOAT_RTOL = 1e-6     # float outputs, of the largest entry
_f = lc._f


def _i8(rng, *shape):
    return rng.randint(-127, 128, size=shape).astype("int8")


def _r(v):
    return onp.array(v, "float32")


def _q(rng, *shape, lo=-1.3, hi=2.1):
    """Codes and their range (min, max)."""
    return [_i8(rng, *shape), _r(lo), _r(hi)]


_WILD = onp.array([200.0, -300.0, 3e9, -3e9, onp.nan, onp.inf, -onp.inf,
                   127.5, -128.7, 3.7, -3.7, 0.5], "float32")


def _wild(rng, *shape):
    """Floats in int8's range with ``_WILD``'s casts' corners spread in."""
    x = rng.uniform(-120, 120, size=shape).astype("float32")
    flat = x.reshape(-1)
    flat[rng.choice(flat.size, len(_WILD), replace=False)] = _WILD
    return x


def _c(build, attrs=None, grad=False):
    return lc._c(build, attrs, grad, "q")


def _concat(*shapes):
    def build(rng):
        qs = [_i8(rng, *s) for s in shapes]
        mns = [_r(-rng.uniform(0.1, 3)) for _ in shapes]
        mxs = [_r(rng.uniform(0.1, 3)) for _ in shapes]
        return qs + mns + mxs
    return build


def _pair(lo_a, hi_a, lo_b, hi_b, shape=(3, 5), big=False):
    def build(rng):
        qa = rng.randint(-2 * 10 ** 6, 2 * 10 ** 6, size=shape).astype(
            "int32") if big else _i8(rng, *shape)
        return [qa, _i8(rng, *shape), _r(lo_a), _r(hi_a), _r(lo_b),
                _r(hi_b)]
    return build


def _fc(x_shape, n, bias=False, wild=False):
    def build(rng):
        k = int(onp.prod(x_shape[1:]))
        qx = _wild(rng, *x_shape) if wild else _i8(rng, *x_shape)
        qw = _wild(rng, n, k) if wild else _i8(rng, n, k)
        out = [qx, qw]
        if bias:
            qb = _i8(rng, n).astype("float32") * (1e30 if wild else 1)
            out.append(qb)
        out += [_r(-1.1), _r(0.9), _r(-0.4), _r(0.35)]
        if bias:
            out += [_r(-0.2), _r(0.25)]
        return out
    return build


def _fc_noflat(rng):
    return [_i8(rng, 2, 3, 8), _i8(rng, 5, 8), _r(-1.1), _r(0.9), _r(-0.4),
            _r(0.35)]


def _conv(x_shape, w_shape, bias=False, wild=False):
    def build(rng):
        out = [_wild(rng, *x_shape) if wild else _i8(rng, *x_shape),
               _i8(rng, *w_shape)]
        if bias:
            out.append(_i8(rng, w_shape[0]))
        out += [_r(-2.0), _r(1.5), _r(-0.3), _r(0.31)]
        if bias:
            out += [_r(-0.5), _r(0.4)]
        return out
    return build


def _bn(rng, shape=(2, 3, 4, 4)):
    c = shape[1]
    return [_i8(rng, *shape), rng.uniform(0.5, 2, c).astype("float32"),
            rng.uniform(-1, 1, c).astype("float32"),
            rng.uniform(-0.3, 0.3, c).astype("float32"),
            rng.uniform(0.5, 2, c).astype("float32"), _r(-1.9), _r(2.3)]


def _maxabs(rng, *shape, shrink=1.0):
    x = _f(rng, *shape) * 3
    return [x, _r(onp.abs(x).max() * shrink)]


QUANT = {
    "quantize_v2": [
        _c(lambda r: [r.randn(5, 7).astype("float32")]),
        _c(lambda r: [r.randn(64).astype("float32")],
           {"min_calib_range": -2.0, "max_calib_range": 2.0}),
        _c(lambda r: [_wild(r, 6, 8) / 60],
           {"min_calib_range": -1.5, "max_calib_range": 1.0}),
        _c(lambda r: [r.randn(256, 256).astype("float32") * 3],
           {"min_calib_range": -2.3, "max_calib_range": 2.9})],
    "requantize": [
        _c(lambda r: [r.randint(-2 ** 30, 2 ** 30, size=(4, 6)).astype(
            "int32"), _r(-7.5), _r(6.0)]),
        _c(lambda r: [r.randint(-2 ** 30, 2 ** 30, size=(4, 6)).astype(
            "int32"), _r(-7.5), _r(6.0)],
           {"min_calib_range": -1.0, "max_calib_range": 2.5})],
    "quantized_act": [_c(lambda r: _q(r, 2, 4, 6, 6), {"act_type": "relu"})],
    "quantized_flatten": [_c(lambda r: _q(r, 2, 4, 6, 6))],
    "quantized_concat": [
        _c(_concat((2, 4, 6, 6), (2, 3, 6, 6)), {"dim": 1, "num_args": 2}),
        _c(_concat((2, 5), (3, 5), (1, 5)), {"dim": 0, "num_args": 3})],
    "quantized_elemwise_add": [
        _c(_pair(-1.3, 2.7, -0.31, 0.17)),
        _c(_pair(-1e-5, 2e-5, -3e-5, 1e-5)),
        _c(_pair(-1.3, 2.7, -0.31, 0.17, big=True)),
        _c(_pair(-0.7, 0.9, -3.1, 1.7, shape=(64, 64)))],
    "quantized_elemwise_mul": [_c(_pair(-1.3, 2.7, -0.31, 0.17))],
    "quantized_embedding": [
        _c(lambda r: [onp.array([1, 3, -2, 12, -11], "int32"),
                      *_q(r, 10, 4)], {"input_dim": 10, "output_dim": 4}),
        _c(lambda r: [onp.array([1.7, -1.2, 3e9, -3e9, onp.nan, 12.0],
                                "float32"), *_q(r, 10, 4)],
           {"input_dim": 10, "output_dim": 4})],
    "quantized_fully_connected_v2": [
        _c(_fc((4, 8), 16), {"no_bias": True, "num_hidden": 16}),
        _c(_fc((4, 8), 16, bias=True), {"num_hidden": 16}),
        _c(_fc((4, 2, 3, 4), 5, bias=True), {"num_hidden": 5}),
        _c(_fc_noflat, {"no_bias": True, "num_hidden": 5, "flatten": False}),
        _c(_fc((6, 10), 7, bias=True, wild=True), {"num_hidden": 7})],
    "quantized_conv": [
        _c(_conv((1, 3, 8, 8), (4, 3, 3, 3)),
           {"kernel": (3, 3), "num_filter": 4}),
        _c(_conv((2, 3, 9, 8), (5, 3, 3, 2), bias=True),
           {"kernel": (3, 2), "stride": (2, 1), "pad": (1, 2),
            "dilate": (2, 1), "num_filter": 5, "no_bias": False}),
        _c(_conv((2, 3, 10), (4, 3, 3)),
           {"kernel": (3,), "pad": (1,), "num_filter": 4}),
        _c(_conv((1, 2, 4, 5, 5), (3, 2, 2, 3, 3)),
           {"kernel": (2, 3, 3), "stride": (1, 2, 1), "num_filter": 3}),
        _c(_conv((2, 3, 7, 7), (4, 3, 3, 3), wild=True),
           {"kernel": (3, 3), "pad": (1, 1), "num_filter": 4})],
    "quantized_pooling": [
        _c(lambda r: _q(r, 2, 4, 6, 6),
           {"kernel": (2, 2), "stride": (2, 2), "pool_type": "max"}),
        _c(lambda r: _q(r, 2, 4, 6, 6),
           {"kernel": (2, 2), "stride": (2, 2), "pool_type": "avg"}),
        _c(lambda r: [-onp.abs(_i8(r, 2, 3, 7, 7)), _r(-1.0), _r(1.0)],
           {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
            "pool_type": "max"}),
        _c(lambda r: _q(r, 2, 3, 7, 7),
           {"kernel": (3, 3), "stride": (1, 1), "pad": (1, 1),
            "pool_type": "avg"}),
        _c(lambda r: _q(r, 2, 4, 5, 6),
           {"global_pool": True, "pool_type": "avg"}),
        _c(lambda r: _q(r, 2, 3, 10),
           {"kernel": (3,), "stride": (2,), "pool_type": "max"}),
        _c(lambda r: _q(r, 1, 2, 4, 6, 6),
           {"kernel": (2, 3, 3), "stride": (2, 3, 3), "pool_type": "avg"})],
    "quantized_batch_norm": [
        _c(_bn),
        _c(_bn, {"min_calib_range": -3.0, "max_calib_range": 3.0}),
        _c(lambda r: _bn(r, (3, 8, 5)), {"eps": 1e-5})],
    "round_ste": [_c(lambda r: [onp.concatenate([
        _f(r, 7) * 4, onp.array([0.5, 1.5, 2.5, -0.5, -2.5], "float32")])],
        grad=True)],
    "sign_ste": [_c(lambda r: [onp.concatenate([
        _f(r, 7), onp.array([0.0, -0.0], "float32")])], grad=True)],
    "intgemm_maxabsolute": [_c(lambda r: [_f(r, 4, 8) * 3], grad=True)],
    "intgemm_prepare_data": [
        _c(lambda r: _maxabs(r, 4, 8)),
        _c(lambda r: _maxabs(r, 4, 8, shrink=0.3)),
        _c(lambda r: [_f(r, 3, 8) * 1e-13, _r(0.0)])],
    "intgemm_prepare_weight": [
        _c(lambda r: _maxabs(r, 16, 8)),
        _c(lambda r: [_wild(r, 16, 8)], {"already_quantized": True}),
        _c(lambda r: [r.randint(-300, 300, size=(6, 8)).astype("int32")],
           {"already_quantized": True})],
    "intgemm_take_weight": [
        _c(lambda r: [_i8(r, 16, 8), onp.array([0, 2, 15, -1], "int32")]),
        _c(lambda r: [_i8(r, 16, 8), onp.array(
            [1.5, -1.5, 1e10, onp.nan, 20.0], "float32")])],
    "intgemm_fully_connected": [
        _c(lambda r: [_i8(r, 4, 8), _i8(r, 16, 8), _r(3e-4)],
           {"no_bias": True}),
        _c(lambda r: [_i8(r, 4, 8), _i8(r, 16, 8), _r(3e-4),
                      _f(r, 16)], {"no_bias": False, "num_hidden": 16}),
        _c(lambda r: [_i8(r, 2, 3, 4), _i8(r, 5, 12), _r(3e-4)],
           {"no_bias": True, "out_type": "int32"}),
        _c(lambda r: [_wild(r, 4, 12), _wild(r, 6, 12), _r(3e-4)],
           {"no_bias": True})],
    "contrib_quantize": [
        _c(lambda r: [r.uniform(-3, 3, (8, 8)).astype("float32")]),
        _c(lambda r: [_f(r, 4, 6) * onp.arange(1, 5, dtype="float32")[:, None]],
           {"channel_axis": 0}),
        _c(lambda r: [_f(r, 5, 6)], {"scale": 0.0237}),
        _c(lambda r: [onp.zeros((4, 4), "float32")]),
        _c(lambda r: [_f(r, 4, 3, 3, 3)], {"channel_axis": 0}),
        _c(lambda r: [_wild(r, 4, 8) / 40], {"scale": 0.0237}),
        _c(lambda r: [r.randn(256, 256).astype("float32")],
           {"scale": 0.0237})],
    "contrib_dequantize": [
        _c(lambda r: [_i8(r, 4, 6), onp.abs(_f(r, 4, 1)) / 127]),
        _c(lambda r: [_i8(r, 3, 3), _r(0.02)])],
    "quantized_fully_connected": [
        _c(lambda r: [_f(r, 8, 16), _i8(r, 32, 16),
                      onp.abs(_f(r, 32, 1)) / 127, _f(r, 32)],
           {"act_scale": 0.0079}),
        _c(lambda r: [_f(r, 2, 3, 4), _i8(r, 5, 12),
                      onp.abs(_f(r, 5, 1)) / 127],
           {"act_scale": 0.0079, "no_bias": True}),
        _c(lambda r: [_f(r, 2, 3, 16), _i8(r, 8, 16),
                      onp.abs(_f(r, 8, 1)) / 127, _f(r, 8)],
           {"act_scale": 0.0079, "flatten": False}),
        _c(lambda r: [_wild(r, 4, 8) / 100, _wild(r, 6, 8),
                      onp.abs(_f(r, 6, 1)) / 127],
           {"act_scale": 0.0079, "no_bias": True})],
}

ALIASES = {
    "_contrib_quantize_v2": "quantize_v2",
    "_contrib_requantize": "requantize",
    "_contrib_quantized_act": "quantized_act",
    "_contrib_quantized_flatten": "quantized_flatten",
    "_contrib_quantized_concat": "quantized_concat",
    "_contrib_quantized_elemwise_add": "quantized_elemwise_add",
    "_contrib_quantized_elemwise_mul": "quantized_elemwise_mul",
    "_contrib_quantized_embedding": "quantized_embedding",
    "_contrib_quantized_fully_connected": "quantized_fully_connected_v2",
    "_contrib_quantized_conv": "quantized_conv",
    "_contrib_quantized_pooling": "quantized_pooling",
    "_contrib_quantized_batch_norm": "quantized_batch_norm",
    "_contrib_round_ste": "round_ste",
    "_contrib_sign_ste": "sign_ste",
    "_contrib_intgemm_maxabsolute": "intgemm_maxabsolute",
    "_contrib_intgemm_prepare_data": "intgemm_prepare_data",
    "_contrib_intgemm_prepare_weight": "intgemm_prepare_weight",
    "_contrib_intgemm_take_weight": "intgemm_take_weight",
    "_contrib_intgemm_fully_connected": "intgemm_fully_connected",
    "_contrib_quantize": "contrib_quantize",
    "_contrib_dequantize": "contrib_dequantize",
}

ALL = {**QUANT, **ALIASES}
# the reference's contrib/quantization.py names, the rest are
# ops/quantized_ops.py's
CONTRIB = ["contrib_quantize", "contrib_dequantize",
           "quantized_fully_connected", "_contrib_quantize",
           "_contrib_dequantize"]


def cases(name):
    return lc.cases(name, ALL)


def target(name):
    return lc.target(name, ALL)


def inputs(name, i, seed=0):
    return lc.inputs(name, i, seed, ALL)


def run_port(name, i, device="cpu", seed=0, grad=None):
    return lc.run_port(name, i, device, seed=seed, table=ALL, grad=grad)


def run_reference(name, i, seed=0, grad=None):
    return lc.run_reference(name, i, seed=seed, table=ALL, grad=grad)


def compare(got, want):
    """Each output by its dtype: integers bitwise, floats within
    ``FLOAT_RTOL`` of the largest entry (NaN where ``want`` has it)."""
    got, want = lc._np(got), lc._np(want)
    assert len(got) == len(want), (len(got), len(want))
    for g, w in zip(got, want):
        assert g.shape == w.shape, (g.shape, w.shape)
        if onp.issubdtype(w.dtype, onp.integer):
            onp.testing.assert_array_equal(g, w)
        else:
            lc._close(g, w, FLOAT_RTOL)


def check_against_reference(name, first=False):
    """Every case of ``name`` on the port (CPU) against the JAX package:
    the outputs as :func:`compare` says, their dtypes, and the floating
    inputs' gradients where the case asks for them. With ``first`` (an
    alias, whose ``Op`` is its target's): the first case's outputs and
    dtypes only."""
    from mxnet_tpu_torch.base import dtype_name

    for i, (_, _, grad, _) in enumerate(cases(name)[:1] if first else
                                        cases(name)):
        no = False if first else None
        want, want_g, want_dt = run_reference(name, i, grad=no)
        got, got_g = run_port(name, i, grad=no)
        assert [dtype_name(g.dtype) for g in got] == want_dt, \
            (name, i, [g.dtype for g in got], want_dt)
        compare(got, want)
        if grad and not first:
            assert len(got_g) == len(want_g), name
            for g, w in zip(got_g, want_g):
                lc._close(lc._np([g])[0], w, FLOAT_RTOL)


def check_card(name):
    """Every case of ``name`` on the card against the port on the CPU, as
    :func:`compare` says, gradients included."""
    for i, (_, _, grad, _) in enumerate(cases(name)):
        want, want_g = run_port(name, i, "cpu")
        got, got_g = run_port(name, i, "cuda")
        assert [g.dtype for g in got] == [w.dtype for w in want], name
        compare(got, want)
        if grad:
            for g, w in zip(got_g, want_g):
                lc._close(lc._np([g])[0], lc._np([w])[0], FLOAT_RTOL)
