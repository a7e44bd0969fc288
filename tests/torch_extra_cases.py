"""Inputs and attributes for every name of the port's ``ops/extra.py`` and
``ops/optimizer_ops.py`` that the reference's ``extra.py`` and
``optimizer_ops.py`` register (the interleaved attention products,
``im2col``/``col2im``, the tensor and AMP helpers, and the dense, mixed
precision and multi-tensor updates), and the runners over them.

Not a test module: ``tests/test_torch_extra_ops.py`` and
``test_torch_optimizer_ops.py`` hold each name against the JAX package on
these inputs, their ``cuda`` tests hold the card against the CPU, and
``chip_smoke.py`` phase 18 does the same on the H100. It imports numpy and
the runners of ``tests/torch_legacy_cases.py`` only, so it runs where JAX is
absent.

A case is ``torch_legacy_cases``' ``(build, attrs, grad, kind)``. Where the
reference's sweep (``tests/test_op_sweep.py`` ``SPECS``) has a case, the
first case here has its attributes and its inputs' shapes, dtypes and value
ranges (the CPU tests check that against the sweep); the others are added
here. ``CASTS`` casts some inputs of a case to another dtype (bf16 weights
and gradients beside fp32 states, float16 operands): such a case's outputs
take JAX's promotion of its operands, which the tests hold. An alias maps
to its target's name.
"""
import numpy as onp

import torch_legacy_cases as lc

_c, _f, _int = lc._c, lc._f, lc._int


def _pos(rng, *shape):
    return onp.abs(_f(rng, *shape))


def _near(rng):
    x = _f(rng, 3, 4)
    return [x, x * onp.float32(1 + 1e-6)]


def _masked(rng):
    mask = rng.rand(4, 6) > 0.3
    mask[1] = False                     # a fully masked row
    mask[2, 0] = True
    return [_f(rng, 4, 6), mask]


def _inf(rng):
    x = _f(rng, 3, 4)
    x[1, 1] = onp.inf
    return x


def _multicast(*dts):
    return lambda r: [_f(r, 3, 4).astype(d) for d in dts]


# ---------------------------------------------------------------------------
# extra.py
# ---------------------------------------------------------------------------
EXTRA = {
    "khatri_rao": [_c(lambda r: [_f(r, 2, 4), _f(r, 3, 4)], {}, True),
                   _c(lambda r: [_f(r, 2, 3), _f(r, 4, 3), _f(r, 2, 3)], {},
                      True)],
    "interleaved_matmul_selfatt_qk": [
        _c(lambda r: [_f(r, 6, 2, 3 * 2 * 4)], {"heads": 2}, True),
        _c(lambda r: [_f(r, 9, 3, 3 * 4 * 8)], {"heads": 4}, True)],
    "interleaved_matmul_selfatt_valatt": [
        _c(lambda r: [_f(r, 6, 2, 3 * 2 * 4), _f(r, 4, 6, 6)], {"heads": 2},
           True),
        _c(lambda r: [_f(r, 9, 3, 3 * 4 * 8), _f(r, 12, 9, 9)],
           {"heads": 4}, True)],
    "interleaved_matmul_encdec_qk": [
        _c(lambda r: [_f(r, 5, 2, 2 * 4), _f(r, 7, 2, 2 * 2 * 4)],
           {"heads": 2}, True)],
    "interleaved_matmul_encdec_valatt": [
        _c(lambda r: [_f(r, 7, 2, 2 * 2 * 4), _f(r, 4, 5, 7)], {"heads": 2},
           True)],
    "im2col": [
        _c(lambda r: [_f(r, 1, 2, 5, 5)], {"kernel": (3, 3)}, True),
        _c(lambda r: [_f(r, 2, 3, 9, 8)], {"kernel": (3, 2), "stride": (2, 1),
                                           "dilate": (2, 1), "pad": (1, 2)})],
    "col2im": [
        _c(lambda r: [_f(r, 1, 2 * 9, 9)], {"output_size": (5, 5),
                                            "kernel": (3, 3)}, True),
        _c(lambda r: [_f(r, 2, 3 * 6, 4 * 11)],
           {"output_size": (9, 8), "kernel": (3, 2), "stride": (2, 1),
            "dilate": (2, 1), "pad": (1, 2)})],
    "reverse": [_c(lambda r: [_f(r, 3, 4)], {"axis": 1}, True),
                _c(lambda r: [_f(r, 2, 3, 4)], {"axis": 0}, True)],
    "batch_take": [_c(lambda r: [_f(r, 3, 5), onp.array([0, 2, 4])], {},
                      True),
                   _c(lambda r: [_f(r, 4, 6), onp.array([5, -1, 0, 3])], {},
                      True)],
    "argmax_channel": [_c(lambda r: [_f(r, 3, 4)], {}, kind="exact"),
                       _c(lambda r: [_f(r, 2, 5, 3)], {}, kind="exact")],
    "shape_array": [_c(lambda r: [_f(r, 3, 4)], {}, kind="exact")],
    "size_array": [_c(lambda r: [_f(r, 3, 4)], {}, kind="exact")],
    "arange_like": [
        _c(lambda r: [_f(r, 3, 4)], {}, kind="exact"),
        # past 2^8 / 2^11: where the float32 multiply-add's rounding shows
        _c(lambda r: [_f(r, 3, 700)], {"start": 0.3, "step": 0.1},
           kind="exact"),
        _c(lambda r: [_int(r, 3, 700)], {"start": 0.3, "step": 0.7},
           kind="exact"),
        _c(lambda r: [_f(r, 5, 3)], {"start": 2.0, "step": -0.5, "axis": 0},
           kind="exact")],
    "allclose": [_c(lambda r: [_f(r, 3, 4)] * 1 + [_f(r, 3, 4)], {},
                    kind="exact"),
                 _c(_near, {}, kind="exact"),
                 _c(_near, {"rtol": 1e-8, "atol": 0.0}, kind="exact")],
    "index_copy": [
        _c(lambda r: [_f(r, 4, 3), onp.array([1, 3]), _f(r, 2, 3)], {},
           True),
        # repeated indices: the last of each index's rows wins
        _c(lambda r: [_f(r, 5, 3), onp.array([1, 3, 1, 4, 3, 1]),
                      _f(r, 6, 3)], {}, True)],
    "quadratic": [_c(lambda r: [_f(r, 3, 4)], {"a": 1.0, "b": 2.0, "c": 3.0},
                     True),
                  _c(lambda r: [_f(r, 3, 4)], {"a": -0.3, "b": 0.7}, True)],
    "softmin": [_c(lambda r: [_f(r, 3, 4)], {}, True),
                _c(lambda r: [_f(r, 3, 4, 5)], {"axis": 1}, True)],
    "masked_log_softmax": [
        _c(lambda r: [_f(r, 3, 5), r.rand(3, 5) > 0.3], {}, True),
        _c(_masked, {}, True)],
    "softmax_cross_entropy": [
        _c(lambda r: [_f(r, 4, 5), onp.array([0., 1., 2., 3.])], {}, True),
        _c(lambda r: [_f(r, 6, 9) * 4, onp.array([8., 0., 3., 3., 5., 1.])],
           {}, True)],
    "amp_cast": [_c(lambda r: [_f(r, 3, 4)], {"dtype": "bfloat16"}, True,
                    "exact"),
                 _c(lambda r: [_f(r, 3, 4)], {"dtype": "float16"},
                    kind="exact"),
                 _c(_multicast("float16"), {"dtype": "float32"},
                    kind="exact")],
    "amp_multicast": [
        _c(lambda r: [_f(r, 3, 4), _f(r, 3, 4)], {"num_outputs": 2},
           kind="exact"),
        _c(_multicast("float16", "float32", "float16"), {"num_outputs": 3},
           kind="exact"),
        _c(_multicast("float16", "float32", "float16"),
           {"num_outputs": 3, "cast_narrow": True}, kind="exact"),
        # a tie of item sizes: the first operand's dtype
        _c(lambda r: [_int(r, 3, 4), _f(r, 3, 4)], {"num_outputs": 2},
           kind="exact")],
    "_contrib_allclose": "allclose",
    "_contrib_arange_like": "arange_like",
    "_contrib_index_copy": "index_copy",
    "_contrib_interleaved_matmul_selfatt_qk": "interleaved_matmul_selfatt_qk",
    "_contrib_interleaved_matmul_selfatt_valatt":
        "interleaved_matmul_selfatt_valatt",
    "_contrib_interleaved_matmul_encdec_qk": "interleaved_matmul_encdec_qk",
    "_contrib_interleaved_matmul_encdec_valatt":
        "interleaved_matmul_encdec_valatt",
    "_contrib_quadratic": "quadratic",
}

# ---------------------------------------------------------------------------
# optimizer_ops.py
# ---------------------------------------------------------------------------
_CLIP = {"wd": 0.01, "rescale_grad": 0.5, "clip_gradient": 0.3}


def _opt(n_s, shape=(3, 5), pos=()):
    """(weight, grad, n_s states) of ``shape``; the states at positions in
    ``pos`` (2 = the first state) non-negative."""
    def build(r):
        out = [_f(r, *shape) * 2, _f(r, *shape) * 2]
        for j in range(n_s):
            out.append(_pos(r, *shape) if 2 + j in pos else _f(r, *shape))
        return out
    return build


def _mp(n_s, shape=(3, 5), pos=(), rescale=None):
    """(weight, grad, n_s states, weight32[, rescale])."""
    def build(r):
        w32 = _f(r, *shape) * 2
        out = [w32.copy(), _f(r, *shape) * 2]
        for j in range(n_s):
            out.append(_pos(r, *shape) if 2 + j in pos else _f(r, *shape))
        out.append(w32)
        if rescale is not None:
            out.append(onp.array(rescale, "float32"))
        return out
    return build


def _multi(n_w, per, pos=(), tail=(), shapes=((3, 5), (7,))):
    """``n_w`` weights' interleaved operands, ``per`` a weight (w, g,
    states); the positions ``pos`` within a weight's operands non-negative;
    ``tail`` appended (tensors of the hypers)."""
    def build(r):
        out = []
        for i in range(n_w):
            shape = shapes[i % len(shapes)]
            out.append(_f(r, *shape) * 2)
            for j in range(1, per):
                out.append(_pos(r, *shape) if j in pos else _f(r, *shape) * 2)
        return out + [onp.asarray(t, "float32") for t in tail]
    return build


def _multi_mp(n_w, per, pos=(), tail=(), shapes=((3, 5), (7,))):
    """:func:`_multi` with the last operand of each weight its fp32 master
    (a copy of the weight)."""
    def build(r):
        out = []
        for i in range(n_w):
            shape = shapes[i % len(shapes)]
            w = _f(r, *shape) * 2
            out.append(w)
            for j in range(1, per - 1):
                out.append(_pos(r, *shape) if j in pos else _f(r, *shape) * 2)
            out.append(w.copy())
        return out + [onp.asarray(t, "float32") for t in tail]
    return build


_SGD2 = {"lrs": (0.1, 0.05), "wds": (0.0, 0.01), "num_weights": 2}
_ADAMW2 = {"lrs": (0.01, 0.02), "wds": (0.01, 0.0), "etas": (1.0, 0.5),
           "num_weights": 2}
_LAMB2 = {"learning_rates": (0.01, 0.02), "wds": (0.01, 0.0),
          "step_count": (1, 3), "num_tensors": 2}
_PRE = (onp.array([0.1, 0.05], "float32"), onp.array([0.0, 0.01], "float32"))

OPTIM = {
    "sgd_update": [
        _c(lambda r: [_f(r, 4), _f(r, 4)], {"lr": 0.1, "wd": 0.01}),
        _c(_opt(0), {"lr": 0.1, **_CLIP}),
        _c(_opt(0), {"lr": 0.1, **_CLIP})],          # bf16 w, g / w
    "sgd_mom_update": [
        _c(lambda r: [_f(r, 4), _f(r, 4), _f(r, 4)],
           {"lr": 0.1, "momentum": 0.9}, True),
        _c(_opt(1), {"lr": 0.1, "momentum": 0.8, **_CLIP})],
    "nag_mom_update": [
        _c(lambda r: [_f(r, 4), _f(r, 4), _f(r, 4)],
           {"lr": 0.1, "momentum": 0.9}, True),
        _c(_opt(1), {"lr": 0.1, "momentum": 0.8, **_CLIP})],
    "signsgd_update": [_c(lambda r: [_f(r, 4), _f(r, 4)], {"lr": 0.1}),
                       _c(_opt(0), {"lr": 0.1, **_CLIP})],
    "signum_update": [
        _c(lambda r: [_f(r, 4), _f(r, 4), _f(r, 4)],
           {"lr": 0.1, "momentum": 0.9}, True),
        _c(_opt(1), {"lr": 0.1, "momentum": 0.8, "wd_lh": 0.01,
                        **_CLIP})],
    "adam_update": [
        _c(lambda r: [_f(r, 4), _f(r, 4), _f(r, 4), _pos(r, 4)],
           {"lr": 0.01}, True),
        _c(_opt(2, pos=(3,)), {"lr": 0.01, **_CLIP})],
    "adamw_update": [
        _c(lambda r: [_f(r, 4), _f(r, 4), _f(r, 4), _pos(r, 4)],
           {"lr": 0.01, "wd": 0.01}, True),
        _c(_opt(2, pos=(3,)), {"lr": 0.01, "eta": 0.5, **_CLIP})],
    "adabelief_update": [
        _c(lambda r: [_f(r, 4), _f(r, 4), _f(r, 4), _pos(r, 4)],
           {"lr": 0.01}, True),
        _c(_opt(2, pos=(3,)), {"lr": 0.01, **_CLIP})],
    "ftml_update": [
        _c(lambda r: [_f(r, 4), _f(r, 4), _pos(r, 4), _pos(r, 4), _f(r, 4)],
           {"lr": 0.01, "t": 2}, True),
        _c(_opt(3, pos=(2, 3)), {"lr": 0.01, "t": 5, "wd": 0.01,
                                    "rescale_grad": 0.5, "clip_grad": 0.3})],
    "ftrl_update": [
        _c(lambda r: [_f(r, 4), _f(r, 4), _f(r, 4), _pos(r, 4)],
           {"lr": 0.1}, True),
        _c(_opt(2, pos=(3,)), {"lr": 0.1, "lamda1": 0.5, **_CLIP})],
    "rmsprop_update": [
        _c(lambda r: [_f(r, 4), _f(r, 4), _pos(r, 4)], {"lr": 0.01}, True),
        _c(_opt(1, pos=(2,)), {"lr": 0.5, "clip_weights": 0.8, **_CLIP})],
    "rmspropalex_update": [
        _c(lambda r: [_f(r, 4), _f(r, 4), _pos(r, 4), _f(r, 4), _f(r, 4)],
           {"lr": 0.01}, True),
        _c(_opt(3, pos=(2,)), {"lr": 0.01, **_CLIP})],
    "lamb_update_phase1": [
        _c(lambda r: [_f(r, 4), _f(r, 4), _f(r, 4), _pos(r, 4)], {"t": 1},
           True),
        _c(_opt(2, pos=(3,)), {"t": 3, "bias_correction": False,
                                  **_CLIP})],
    "lamb_update_phase2": [
        _c(lambda r: [_f(r, 4), _f(r, 4), onp.array([1.0]),
                      onp.array([1.0])], {"lr": 0.01}, True),
        _c(lambda r: [_f(r, 3, 5), _f(r, 3, 5), onp.array([2.0]),
                      onp.array([0.5])],
           {"lr": 0.01, "lower_bound": 2.5, "upper_bound": 4.0}, True),
        _c(lambda r: [_f(r, 3, 5), _f(r, 3, 5), onp.array([2.0]),
                      onp.array([0.0])], {"lr": 0.01}),
        _c(lambda r: [_f(r, 3, 5), _f(r, 3, 5), onp.array([2.0]),
                      onp.array([0.5])], {"lr": 0.01})],   # bf16 w
    "multi_sgd_update": [
        _c(lambda r: [_f(r, 3), _f(r, 3), _f(r, 4), _f(r, 4)],
           {"lrs": (0.1, 0.1), "wds": (0.0, 0.0), "num_weights": 2}, True),
        _c(_multi(2, 2), {**_SGD2, "rescale_grad": 0.5})],
    "all_finite": [_c(lambda r: [_f(r, 3, 4)], {}, kind="exact"),
                   _c(lambda r: lc._nan_row(r), {}, kind="exact"),
                   _c(lambda r: [_inf(r)], {}, kind="exact")],
    "multi_all_finite": [
        _c(lambda r: [_f(r, 3), _f(r, 4)], {"num_arrays": 2}, kind="exact"),
        _c(lambda r: [_f(r, 3), onp.array([1.0, -onp.inf], "float32"),
                      _f(r, 2)], {"num_arrays": 3}, kind="exact")],
    "mp_sgd_update": [
        _c(lambda r: [_f(r, 4), _f(r, 4), _f(r, 4)], {"lr": 0.1}, True),
        _c(_mp(0), {"lr": 0.1, **_CLIP})],                  # bf16 w, g
    "mp_sgd_mom_update": [
        _c(lambda r: [_f(r, 4), _f(r, 4), _f(r, 4), _f(r, 4)], {"lr": 0.1},
           True),
        _c(_mp(1), {"lr": 0.1, "momentum": 0.8, **_CLIP})],
    "mp_nag_mom_update": [
        _c(lambda r: [_f(r, 4), _f(r, 4), _f(r, 4), _f(r, 4)], {"lr": 0.1},
           True),
        _c(_mp(1), {"lr": 0.1, "momentum": 0.8, **_CLIP})],
    "mp_lamb_update_phase1": [
        _c(lambda r: [_f(r, 4), _f(r, 4), _f(r, 4), _pos(r, 4), _f(r, 4)],
           {"t": 1}, True),
        _c(_mp(2, pos=(3,)), {"t": 4, **_CLIP})],
    "mp_lamb_update_phase2": [
        _c(lambda r: [_f(r, 4), _f(r, 4), onp.array([1.0]),
                      onp.array([1.0]), _f(r, 4)], {"lr": 0.01}, True),
        _c(lambda r: [_f(r, 3, 5), _f(r, 3, 5), onp.array([2.0]),
                      onp.array([0.5]), _f(r, 3, 5)],
           {"lr": 0.01, "lower_bound": 0.5, "upper_bound": 1.5})],
    "mp_adamw_update": [
        _c(lambda r: [_f(r, 4), _f(r, 4), _f(r, 4), _pos(r, 4), _f(r, 4),
                      onp.array(1.0, "float32")], {"lr": 0.01}, True),
        _c(_mp(2, pos=(3,), rescale=0.5),
           {"lr": 0.01, "wd": 0.01, "eta": 0.5, "clip_gradient": 0.3})],
    "mp_adabelief_update": [
        _c(lambda r: [_f(r, 4), _f(r, 4), _f(r, 4), _pos(r, 4), _f(r, 4),
                      onp.array(1.0, "float32")], {"lr": 0.01}, True),
        _c(_mp(2, pos=(3,), rescale=0.5),
           {"lr": 0.01, "wd": 0.01, "clip_gradient": 0.3})],
    "multi_sgd_mom_update": [
        _c(lambda r: [_f(r, 3), _f(r, 3), _f(r, 3), _f(r, 4), _f(r, 4),
                      _f(r, 4)],
           {"lrs": (0.1, 0.1), "wds": (0.0, 0.0), "num_weights": 2}, True),
        _c(_multi(2, 3), {**_SGD2, "momentum": 0.8, **{
            k: v for k, v in _CLIP.items() if k != "wd"}})],
    "multi_mp_sgd_update": [
        _c(lambda r: [_f(r, 3), _f(r, 3), _f(r, 3)],
           {"lrs": (0.1,), "wds": (0.0,), "num_weights": 1}, True),
        _c(_multi_mp(2, 3), {**_SGD2, "rescale_grad": 0.5,
                             "clip_gradient": 0.3})],
    "multi_mp_sgd_mom_update": [
        _c(lambda r: [_f(r, 3), _f(r, 3), _f(r, 3), _f(r, 3)],
           {"lrs": (0.1,), "wds": (0.0,), "num_weights": 1}, True),
        _c(_multi_mp(2, 4), {**_SGD2, "momentum": 0.8,
                             "clip_gradient": 0.3})],
    # the preloaded forms' first cases hold no gradient: a one-element
    # learning rate's gradient is a cancelling sum of three products (its
    # rounding 2e-5 of itself); the weights' gradients are those of the
    # tuple-hyper forms, held above and below
    "preloaded_multi_sgd_update": [
        _c(lambda r: [_f(r, 3), _f(r, 3), onp.array([0.1], "float32"),
                      onp.array([0.0], "float32")], {"num_weights": 1}),
        _c(_multi(2, 2, tail=_PRE), {"num_weights": 2, "rescale_grad": 0.5,
                                     "clip_gradient": 0.3})],
    "preloaded_multi_sgd_mom_update": [
        _c(lambda r: [_f(r, 3), _f(r, 3), _f(r, 3),
                      onp.array([0.1], "float32"),
                      onp.array([0.0], "float32")], {"num_weights": 1}),
        _c(_multi(2, 3, tail=_PRE), {"num_weights": 2, "momentum": 0.8})],
    "preloaded_multi_mp_sgd_update": [
        _c(lambda r: [_f(r, 3), _f(r, 3), _f(r, 3),
                      onp.array([0.1], "float32"),
                      onp.array([0.0], "float32")], {"num_weights": 1}),
        _c(_multi_mp(2, 3, tail=_PRE), {"num_weights": 2})],
    "preloaded_multi_mp_sgd_mom_update": [
        _c(lambda r: [_f(r, 3), _f(r, 3), _f(r, 3), _f(r, 3),
                      onp.array([0.1], "float32"),
                      onp.array([0.0], "float32")], {"num_weights": 1}),
        _c(_multi_mp(2, 4, tail=_PRE), {"num_weights": 2, "momentum": 0.8})],
    "multi_adamw_update": [
        _c(lambda r: [_f(r, 4), _f(r, 4), _f(r, 4), _pos(r, 4),
                      onp.array(1.0, "float32")],
           {"lrs": (0.01,), "wds": (0.01,), "etas": (1.0,),
            "num_weights": 1}, True),
        _c(_multi(2, 4, pos=(3,), tail=(0.5,)),
           {**_ADAMW2, "clip_gradient": 0.3})],
    "multi_mp_adamw_update": [
        _c(lambda r: [_f(r, 4), _f(r, 4), _f(r, 4), _pos(r, 4), _f(r, 4),
                      onp.array(1.0, "float32")],
           {"lrs": (0.01,), "wds": (0.01,), "etas": (1.0,),
            "num_weights": 1}, True),
        _c(_multi_mp(2, 5, pos=(3,), tail=(0.5,)),
           {**_ADAMW2, "clip_gradient": 0.3})],
    "multi_lamb_update": [
        _c(lambda r: [_f(r, 4), _f(r, 4), _f(r, 4), _pos(r, 4)],
           {"learning_rates": (0.01,), "wds": (0.0,), "step_count": (1,),
            "num_tensors": 1}, True),
        _c(_multi(2, 4, pos=(3,)), {**_LAMB2, "rescale_grad": 0.5,
                                    "clip_gradient": 0.3}),
        _c(_multi(2, 4, pos=(3,)), {**_LAMB2, "bias_correction": False})],
    "multi_mp_lamb_update": [
        _c(lambda r: [_f(r, 4), _f(r, 4), _f(r, 4), _pos(r, 4), _f(r, 4)],
           {"learning_rates": (0.01,), "wds": (0.0,), "step_count": (1,),
            "num_tensors": 1}, True),
        _c(_multi_mp(2, 5, pos=(3,)), {**_LAMB2, "rescale_grad": 0.5,
                                       "clip_gradient": 0.3})],
    "multi_lans_update": [
        _c(lambda r: [_f(r, 4), _f(r, 4), _f(r, 4), _pos(r, 4)],
           {"learning_rates": (0.01,), "wds": (0.0,), "step_count": (1,),
            "num_tensors": 1}, True),
        _c(_multi(2, 4, pos=(3,)), {**_LAMB2, "rescale_grad": 0.5,
                                    "clip_gradient": 0.3})],
    "multi_mp_lans_update": [
        _c(lambda r: [_f(r, 4), _f(r, 4), _f(r, 4), _pos(r, 4), _f(r, 4)],
           {"learning_rates": (0.01,), "wds": (0.0,), "step_count": (1,),
            "num_tensors": 1}, True),
        _c(_multi_mp(2, 5, pos=(3,)), {**_LAMB2, "rescale_grad": 0.5})],
    "multi_adabelief_update": [
        _c(lambda r: [_f(r, 4), _f(r, 4), _f(r, 4), _pos(r, 4),
                      onp.array(1.0, "float32")],
           {"lrs": (0.01,), "wds": (0.0,), "etas": (1.0,),
            "num_weights": 1}, True),
        _c(_multi(2, 4, pos=(3,), tail=(0.5,)),
           {**_ADAMW2, "clip_gradient": 0.3})],
    "multi_mp_adabelief_update": [
        _c(lambda r: [_f(r, 4), _f(r, 4), _f(r, 4), _pos(r, 4), _f(r, 4),
                      onp.array(1.0, "float32")],
           {"lrs": (0.01,), "wds": (0.0,), "etas": (1.0,),
            "num_weights": 1}, True),
        _c(_multi_mp(2, 5, pos=(3,), tail=(0.5,)), _ADAMW2)],
    "_adamw_update": "adamw_update",
    "_adabelief_update": "adabelief_update",
    "_multi_adamw_update": "multi_adamw_update",
    "_multi_mp_adamw_update": "multi_mp_adamw_update",
    "_multi_lamb_update": "multi_lamb_update",
    "_multi_mp_lamb_update": "multi_mp_lamb_update",
    "_multi_lans_update": "multi_lans_update",
    "_multi_mp_lans_update": "multi_mp_lans_update",
    "_multi_adabelief_update": "multi_adabelief_update",
    "_multi_mp_adabelief_update": "multi_mp_adabelief_update",
    "_mp_adamw_update": "mp_adamw_update",
    "_mp_adabelief_update": "mp_adabelief_update",
}

MODULES = {"extra": EXTRA, "optimizer_ops": OPTIM}
ALL = {**EXTRA, **OPTIM}

_BF = "bfloat16"
# (target, case): {input position: dtype} — bf16 weights and gradients
# beside fp32 states and masters (the mp_* and multi_mp_* forms' use),
# float16 operands of the casts
CASTS = {
    ("sgd_update", 1): {0: _BF, 1: _BF},
    ("sgd_update", 2): {0: _BF},
    ("sgd_mom_update", 1): {0: _BF, 1: _BF},
    ("adamw_update", 1): {0: _BF, 1: _BF},
    ("lamb_update_phase1", 1): {0: _BF, 1: _BF},
    ("lamb_update_phase2", 3): {0: _BF},
    ("multi_sgd_update", 1): {0: _BF, 1: _BF},
    ("mp_sgd_update", 1): {0: _BF, 1: _BF},
    ("mp_sgd_mom_update", 1): {0: _BF, 1: _BF},
    ("mp_nag_mom_update", 1): {0: _BF, 1: _BF},
    ("mp_lamb_update_phase1", 1): {0: _BF, 1: _BF},
    ("mp_lamb_update_phase2", 1): {0: _BF},
    ("mp_adamw_update", 1): {0: _BF, 1: _BF},
    ("mp_adabelief_update", 1): {0: _BF, 1: _BF},
    ("multi_mp_sgd_update", 1): {0: _BF, 1: _BF, 3: _BF, 4: _BF},
    ("multi_mp_sgd_mom_update", 1): {0: _BF, 1: _BF, 4: _BF, 5: _BF},
    ("preloaded_multi_sgd_update", 1): {0: _BF, 1: _BF},
    ("preloaded_multi_mp_sgd_update", 1): {0: _BF, 1: _BF},
    ("multi_adamw_update", 1): {0: _BF, 1: _BF},
    ("multi_mp_adamw_update", 1): {0: _BF, 1: _BF, 5: _BF, 6: _BF},
    ("multi_mp_lamb_update", 1): {0: _BF, 1: _BF, 5: _BF, 6: _BF},
    ("multi_mp_lans_update", 1): {0: _BF, 1: _BF},
    ("multi_mp_adabelief_update", 1): {0: _BF, 1: _BF},
    ("interleaved_matmul_selfatt_qk", 1): {0: _BF},
    ("interleaved_matmul_selfatt_valatt", 1): {0: _BF},
    ("softmax_cross_entropy", 1): {0: _BF},
}

# a case with bf16 operands (``CASTS``), every output of it, fp32 ones too,
# against the reference's: within 2^-6 of the largest entry (four bf16 steps
# at the top binade). The reference's XLA program types a Python constant
# beside a bf16 operand as bf16 (a clip bound of 0.3 is 0.30078125 there)
# and keeps a fused expression's intermediates in fp32 (excess precision),
# where torch takes the constant in fp32 and rounds each operation's bf16
# result: the two agree to bf16's precision, not to fp32's
BF16_RTOL = 2.0 ** -6


def cases(name):
    return lc.cases(name, ALL)


def target(name):
    return lc.target(name, ALL)


def inputs(name, i, seed=0):
    return lc.inputs(name, i, seed, ALL)


def casts(name, i):
    return CASTS.get((target(name), i))


def run_port(name, i, device="cpu", seed=0, grad=None):
    return lc.run_port(name, i, device, dtype=casts(name, i), seed=seed,
                       table=ALL, grad=grad)


def run_reference(name, i, seed=0, grad=None):
    return lc.run_reference(name, i, dtype=casts(name, i), seed=seed,
                            table=ALL, grad=grad)


def _rtols(got, name, i):
    """Each output's tolerance: ``BF16_RTOL`` for a bf16 output and for
    every output of a case with bf16 operands, else 1e-5."""
    low = any(d == _BF for d in (casts(name, i) or {}).values())
    return [BF16_RTOL if low or str(g.dtype) == "torch.bfloat16" else 1e-5
            for g in got]


def check_against_reference(name, first=False):
    """Every case of ``name`` on the port (CPU) against the JAX package:
    the outputs as the case's kind says (``BF16_RTOL`` where :func:`_rtols`
    says), their dtypes, and the floating inputs' gradients where the case
    asks for them. With ``first`` (an alias, whose ``Op`` is its target's):
    the first case's outputs and dtypes only."""
    from mxnet_tpu_torch.base import dtype_name

    for i, (_, _, grad, kind) in enumerate(cases(name)[:1] if first else
                                           cases(name)):
        no = False if first else None
        want, want_g, want_dt = run_reference(name, i, grad=no)
        got, got_g = run_port(name, i, grad=no)
        assert [dtype_name(g.dtype) for g in got] == want_dt, \
            (name, i, [g.dtype for g in got], want_dt)
        for g, w, rtol in zip(got, want, _rtols(got, name, i)):
            lc.compare(kind, [g], [w], inputs(name, i), rtol=rtol)
        if grad and not first:
            assert len(got_g) == len(want_g), name
            for g, w, rtol in zip(got_g, want_g, _rtols(got_g, name, i)):
                lc._close(lc._np([g])[0], w, rtol)


def check_card(name):
    """Every case of ``name`` on the card against the port on the CPU:
    1e-5 of the largest entry (bf16 outputs ``BF16_RTOL``), kinds as on
    the CPU."""
    for i, (_, _, grad, kind) in enumerate(cases(name)):
        want, want_g = run_port(name, i, "cpu")
        got, got_g = run_port(name, i, "cuda")
        for g, w, rtol in zip(got, want, _rtols(got, name, i)):
            lc.compare(kind, [g], [w], inputs(name, i), rtol=rtol)
        if grad:
            for g, w, rtol in zip(got_g, want_g, _rtols(got_g, name, i)):
                lc._close(lc._np([g])[0], lc._np([w])[0], rtol)
