"""Inputs and attributes for every name of the port's legacy tensor tier
(``mxnet_tpu_torch/ops/legacy_elemwise.py``, ``linalg_legacy.py``,
``npi_manip.py``), and the port-side runner.

Not a test module: ``tests/test_torch_legacy_elemwise.py``,
``test_torch_linalg_legacy.py`` and ``test_torch_npi_manip.py`` hold each
name against the JAX package on these inputs, their ``cuda`` tests hold the
card against the CPU, and ``chip_smoke.py`` phase 17 does the same on the
H100. It imports numpy and the port only, so it runs where JAX is absent.

Where the reference's own sweep (``tests/test_op_sweep.py`` ``SPECS``, its
scalar tables, ``tests/test_npi_manip_ops.py``) has a case, the case here has
its attributes and its input shapes, dtypes and value ranges (the CPU tests
check that against the sweep); the other cases are added here.

A case is ``(build, attrs, grad, kind)``: ``build(rng)`` makes the numpy
inputs, ``grad`` says whether the inputs' gradients are compared, and
``kind`` how the outputs are: ``"close"`` (1e-5 of the largest entry),
``"exact"`` (bitwise: integer, index and creation outputs), ``"ulp"``
(2^-21 of the largest entry: ``linspace``/``logspace``, where XLA's CPU
code contracts ``start * (1 - s) + stop * s`` into fused multiply-adds
that torch does not), ``"eigh"``,
``"lq"`` and ``"eig"`` (factors fixed up to sign or phase, compared by
reconstruction). An alias maps to its target's name and is run under its
own name on its target's cases.

The runners take the table of cases they read (``table``, ``ALL`` by
default), so ``tests/torch_extra_cases.py`` runs its own tables through
them; ``dtype`` may name a dtype for each input by position.
"""
import numpy as onp

S = 1.7                      # the scalar of the reference's scalar tables

# names whose output shape follows their operands' values (registered
# ``eager_only``; the reference's jit refuses them in a hybridized block)
DATA_DEPENDENT = [
    "unique", "nonzero", "boolean_mask", "_npi_boolean_mask_assign_tensor",
    "delete", "_npi_insert_scalar", "_npi_insert_slice",
    "_npi_insert_tensor", "advanced_indexing", "advanced_indexing_multiple",
    "calibrate_entropy", "_contrib_dynamic_reshape"]


def _f(rng, *shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, size=shape).astype("float32")


def _pos(rng, *shape):
    """The scalar tables' domain."""
    return _f(rng, *shape, lo=0.3, hi=2.5)


def _spd(rng, n, batch=()):
    a = rng.randn(*batch, n, n).astype("float32")
    return (a @ onp.swapaxes(a, -1, -2) +
            n * onp.eye(n, dtype="float32")).astype("float32")


def _bool(rng, *shape):
    return rng.rand(*shape) > 0.5


def _int(rng, *shape, lo=1, hi=6):
    return rng.randint(lo, hi, size=shape).astype("int32")


def _c(build, attrs=None, grad=False, kind="close"):
    return (build, attrs or {}, grad, kind)


# ---------------------------------------------------------------------------
# legacy_elemwise
# ---------------------------------------------------------------------------
SCALAR_OPS = [
    "_plus_scalar", "_minus_scalar", "_rminus_scalar", "_mul_scalar",
    "_div_scalar", "_rdiv_scalar", "_mod_scalar", "_rmod_scalar",
    "_power_scalar", "_rpower_scalar", "_maximum_scalar", "_minimum_scalar",
    "_hypot_scalar", "_npi_copysign_scalar", "_npi_rcopysign_scalar",
    "_npi_arctan2_scalar", "_npi_rarctan2_scalar", "_npi_fmax_scalar",
    "_npi_fmin_scalar", "_npi_fmod_scalar", "_npi_rfmod_scalar",
    "_npi_ldexp_scalar", "_npi_rldexp_scalar"]
SCALAR_INT_OPS = ["_npi_gcd_scalar", "_npi_lcm_scalar",
                  "_npi_bitwise_and_scalar", "_npi_bitwise_or_scalar",
                  "_npi_bitwise_xor_scalar"]
SCALAR_CMP = ["_equal_scalar", "_not_equal_scalar", "_greater_scalar",
              "_greater_equal_scalar", "_lesser_scalar",
              "_lesser_equal_scalar", "_logical_and_scalar",
              "_logical_or_scalar", "_logical_xor_scalar"]


def _scalar_input(rng, dtype, ties=False):
    """(3, 4) of ``dtype`` in the scalar tables' domain (integers 1..5);
    with ``ties``, two entries equal to the scalar (where the comparisons
    turn; the gradients of max, min, fmax and fmin at a tie are each
    library's convention, so their cases have none)."""
    if dtype == "int32":
        return _int(rng, 3, 4)
    x = _pos(rng, 3, 4)
    if ties:
        x[0, 0] = x[2, 3] = S
    return x


def _scalar_case(name, dtype="float32"):
    if name in SCALAR_INT_OPS:
        return _c(lambda r: [_int(r, 3, 4)], {"scalar": 2}, kind="exact")
    kind = "exact" if name in SCALAR_CMP else "close"
    grad = name in SCALAR_OPS and dtype == "float32" and \
        name != "_npi_rldexp_scalar"
    ties = name in SCALAR_CMP
    return _c(lambda r: [_scalar_input(r, dtype, ties)], {"scalar": S}, grad,
              kind)


def _nan_row(rng):
    x = _f(rng, 3, 4)
    x[1, 2] = onp.nan
    return [x]


def _kl_input(rng):
    return [onp.abs(_f(rng, 3, 4)) * 0.3 + 0.05]


_BN = (lambda r: [_f(r, 2, 3, 4, 4), _f(r, 3) + 1.0, _f(r, 3),
                  _f(r, 3) * 0.1, onp.abs(_f(r, 3)) + 0.5])

LEGACY = {n: [_scalar_case(n)] for n in SCALAR_OPS + SCALAR_INT_OPS +
          SCALAR_CMP}
LEGACY.update({
    "_npi_add_scalar": "_plus_scalar",
    "_npi_subtract_scalar": "_minus_scalar",
    "_npi_rsubtract_scalar": "_rminus_scalar",
    "_npi_multiply_scalar": "_mul_scalar",
    "_npi_true_divide_scalar": "_div_scalar",
    "_npi_rtrue_divide_scalar": "_rdiv_scalar",
    "_npi_mod_scalar": "_mod_scalar",
    "_npi_rmod_scalar": "_rmod_scalar",
    "_npi_power_scalar": "_power_scalar",
    "_npi_rpower_scalar": "_rpower_scalar",
    "_npi_where_lscalar": [_c(lambda r: [_bool(r, 3, 4), _f(r, 3, 4)],
                              {"scalar": 9.0}, True)],
    "_npi_where_rscalar": [_c(lambda r: [_bool(r, 3, 4), _f(r, 3, 4)],
                              {"scalar": 9.0}, True)],
    "_npi_where_scalar2": [_c(lambda r: [_bool(r, 3)],
                              {"x": 1.0, "y": -1.0}, kind="exact")],
    # unary extras
    "reciprocal_sqrt": [_c(lambda r: [onp.abs(_f(r, 3, 4)) + 0.2], {},
                           True)],
    "rcbrt": [_c(lambda r: [onp.abs(_f(r, 3, 4)) + 0.2], {}, True)],
    "digamma": [_c(lambda r: [onp.abs(_f(r, 3, 4)) + 0.5], {}, True)],
    "hard_sigmoid": [_c(lambda r: [_f(r, 3, 4) * 5], {}, True)],
    "nanprod": [_c(lambda r: [_f(r, 3, 4)], {"axis": 1}),
                _c(_nan_row, {"axis": 0, "keepdims": True})],
    "ones_like": [_c(lambda r: [_f(r, 3, 4)], {}, kind="exact")],
    "zeros_like": [_c(lambda r: [_f(r, 3, 4)], {}, kind="exact")],
    "_npi_ones_like": "ones_like", "_npi_zeros_like": "zeros_like",
    "rsqrt": "reciprocal_sqrt",
    # identities with a backward of their own
    "make_loss": [_c(lambda r: [_f(r, 3, 4)], {}, True),
                  _c(lambda r: [_f(r, 3, 4)], {"grad_scale": 0.25}, True)],
    "MakeLoss": "make_loss",
    "gradientmultiplier": [_c(lambda r: [_f(r, 3, 4)], {"scalar": 2.0},
                              True),
                           _c(lambda r: [_f(r, 3, 4)], {"scalar": -1.0},
                              True)],
    "_contrib_gradientmultiplier": "gradientmultiplier",
    "IdentityAttachKLSparseReg": [
        _c(lambda r: [onp.abs(_f(r, 3, 4))], {}, True),
        _c(_kl_input, {"sparseness_target": 0.2, "penalty": 0.01}, True)],
    "_grad_add": [_c(lambda r: [_f(r, 3, 4), _f(r, 3, 4)], {}, True)],
    "add_n": [_c(lambda r: [_f(r, 3, 4), _f(r, 3, 4), _f(r, 3, 4)], {},
                 True)],
    "ElementWiseSum": "add_n",
    "_identity_with_attr_like_rhs": [
        _c(lambda r: [_f(r, 3, 4), _f(r, 3, 4)], {}, kind="exact")],
    "_npx_constraint_check": [_c(lambda r: [onp.array([True, True])],
                                 {"msg": "ok"}, kind="exact")],
    "div_sqrt_dim": [_c(lambda r: [_f(r, 3, 16)], {}, True)],
    "_contrib_div_sqrt_dim": "div_sqrt_dim",
    # creation
    "zeros": [_c(lambda r: [], {"shape": (2, 3)}, kind="exact"),
              _c(lambda r: [], {"shape": 4, "dtype": "int32"},
                 kind="exact")],
    "ones": [_c(lambda r: [], {"shape": (2, 3)}, kind="exact")],
    "full": [_c(lambda r: [], {"shape": (2, 3), "value": 7.0},
                kind="exact")],
    "full_like": [_c(lambda r: [_f(r, 2, 3)], {"fill_value": 2.5},
                     kind="exact"),
                  _c(lambda r: [_f(r, 2, 3)],
                     {"fill_value": 2.5, "dtype": "int32"}, kind="exact")],
    "eye": [_c(lambda r: [], {"N": 3, "k": 1}, kind="exact"),
            _c(lambda r: [], {"N": 3, "M": 5, "k": -1}, kind="exact")],
    "_npi_identity": [_c(lambda r: [], {"n": 3}, kind="exact"),
                      _c(lambda r: [], {"shape": (4, 4)}, kind="exact")],
    "arange": [_c(lambda r: [], {"start": 2, "stop": 8, "step": 2,
                                 "dtype": "float32"}, kind="exact"),
               _c(lambda r: [], {"start": 5}, kind="exact"),
               _c(lambda r: [], {"start": 0.5, "stop": 3.0, "step": 0.3,
                                 "repeat": 2}, kind="exact"),
               _c(lambda r: [], {"start": 1, "stop": 9, "step": 3,
                                 "dtype": "int32"}, kind="exact")],
    "linspace": [_c(lambda r: [], {"start": 0.0, "stop": 1.0, "num": 5},
                    kind="ulp"),
                 _c(lambda r: [], {"start": -2.0, "stop": 3.0, "num": 7,
                                   "endpoint": False}, kind="ulp")],
    "logspace": [_c(lambda r: [], {"start": 0.0, "stop": 2.0, "num": 3},
                    kind="ulp"),
                 _c(lambda r: [], {"start": -1.0, "stop": 1.0, "num": 6,
                                   "base": 2.0}, kind="ulp")],
    "tri": [_c(lambda r: [], {"N": 3, "k": 0}, kind="exact"),
            _c(lambda r: [], {"N": 3, "M": 4, "k": 1}, kind="exact")],
    "indices": [_c(lambda r: [], {"dimensions": (2, 3)}, kind="exact")],
    "_zeros": "zeros", "_zeros_without_dtype": "zeros", "_ones": "ones",
    "_full": "full", "_eye": "eye", "_arange": "arange",
    "_linspace": "linspace", "_npi_zeros": "zeros", "_npi_ones": "ones",
    "_npi_full": "full", "_npi_full_like": "full_like", "_npi_eye": "eye",
    "_npi_arange": "arange", "_npi_linspace": "linspace",
    "_npi_logspace": "logspace", "_npi_tri": "tri",
    "_npi_indices": "indices",
    # stack and split
    "hstack": [_c(lambda r: [_f(r, 2, 3), _f(r, 2, 3)], {}, True)],
    "vstack": [_c(lambda r: [_f(r, 2, 3), _f(r, 2, 3)], {}, True)],
    "dstack": [_c(lambda r: [_f(r, 2, 3), _f(r, 2, 3)], {}, True)],
    "column_stack": [_c(lambda r: [_f(r, 3), _f(r, 3)], {}, True)],
    "hsplit": [_c(lambda r: [_f(r, 2, 4)], {"indices_or_sections": 2}, True),
               _c(lambda r: [_f(r, 2, 5)],
                  {"indices_or_sections": (1, 3)}, True)],
    "dsplit": [_c(lambda r: [_f(r, 2, 3, 4)], {"indices_or_sections": 2},
                  True)],
    "_npi_hstack": "hstack", "_npi_vstack": "vstack",
    "_npi_dstack": "dstack", "_npi_column_stack": "column_stack",
    "_npi_hsplit": "hsplit", "_npi_dsplit": "dsplit",
    # the legacy slice family
    "slice": [_c(lambda r: [_f(r, 4, 5)], {"begin": (1, 0), "end": (3, 4)},
                 True),
              _c(lambda r: [_f(r, 4, 5, 3)],
                 {"begin": (None, -1), "end": (None, 0), "step": (2, -2)},
                 True),
              _c(lambda r: [_f(r, 6, 4)],
                 {"begin": (4,), "end": (None,), "step": (-1,)}, True)],
    "crop": "slice",
    "slice_axis": [_c(lambda r: [_f(r, 4, 5)],
                      {"axis": 1, "begin": 1, "end": 4}, True),
                   _c(lambda r: [_f(r, 4, 5)],
                      {"axis": 0, "begin": -3, "end": None}, True)],
    "slice_like": [_c(lambda r: [_f(r, 4, 5), _f(r, 2, 3)], {}, True),
                   _c(lambda r: [_f(r, 4, 5), _f(r, 2, 3)], {"axes": (-1,)},
                      True)],
    "broadcast_axis": [_c(lambda r: [_f(r, 1, 4)], {"axis": 0, "size": 3},
                          True)],
    "broadcast_axes": "broadcast_axis",
    "broadcast_like": [_c(lambda r: [_f(r, 1, 4), _f(r, 3, 4)], {}, True),
                       _c(lambda r: [_f(r, 1, 4), _f(r, 4, 6)],
                          {"lhs_axes": (0,), "rhs_axes": (1,)}, True)],
    "reshape_like": [_c(lambda r: [_f(r, 2, 6), _f(r, 3, 4)], {}, True),
                     _c(lambda r: [_f(r, 2, 12), _f(r, 3, 4)],
                        {"lhs_begin": 1, "lhs_end": 2, "rhs_begin": 0,
                         "rhs_end": 2}, True)],
    "Reshape": [_c(lambda r: [_f(r, 3, 4)], {"shape": (-1, 0)}, True)],
    "_npx_reshape": [_c(lambda r: [_f(r, 3, 4)], {"newshape": (-2, -1)},
                        True)],
    "SliceChannel": [_c(lambda r: [_f(r, 4, 6)],
                        {"num_outputs": 2, "axis": 1}, True),
                     _c(lambda r: [_f(r, 3, 2, 5)],
                        {"num_outputs": 3, "axis": 0, "squeeze_axis": True},
                        True)],
    "split_legacy": "SliceChannel",
    "_split_v2": [_c(lambda r: [_f(r, 4, 6)], {"sections": 3, "axis": 1},
                     True),
                  _c(lambda r: [_f(r, 5, 2)],
                     {"indices": (0, 2, 3), "axis": 0}, True)],
    "swapaxes_legacy": [_c(lambda r: [_f(r, 3, 4, 2)],
                           {"dim1": 0, "dim2": 2}, True)],
    "SwapAxis": "swapaxes_legacy",
    "_rnn_param_concat": [_c(lambda r: [_f(r, 2, 3), _f(r, 4)], {}, True)],
    # scatter and assignment
    "scatter_nd": [_c(lambda r: [_f(r, 2), onp.array([[0, 1], [1, 2]])],
                      {"shape": (3, 4)}, True)],
    "_scatter_set_nd": [_c(lambda r: [_f(r, 2),
                                      onp.array([[0, 1], [1, 2]])],
                           {"shape": (3, 4)}, True)],
    "_slice_assign": [_c(lambda r: [_f(r, 4, 5), _f(r, 2, 5)],
                         {"begin": (1,), "end": (3,)}, True),
                      _c(lambda r: [_f(r, 4, 5), _f(r, 2, 3)],
                         {"begin": (3, 0), "end": (None, 5),
                          "step": (-2, 2)}, True)],
    "_crop_assign": "_slice_assign",
    "_slice_assign_scalar": [_c(lambda r: [_f(r, 4, 5)],
                                {"begin": (1,), "end": (3,), "scalar": 9.0},
                                True)],
    "_crop_assign_scalar": "_slice_assign_scalar",
    # storage and multi-tensor helpers
    "cast_storage": [_c(lambda r: [_f(r, 3, 4)], {"stype": "default"},
                        True)],
    "_sparse_retain": [_c(lambda r: [_f(r, 5, 3), onp.array([1, 3])], {},
                          True)],
    "square_sum": [_c(lambda r: [_f(r, 3, 4)], {"axis": 1}, True),
                   _c(lambda r: [_f(r, 3, 4)], {}, True)],
    "_square_sum": "square_sum",
    "multi_sum_sq": [_c(lambda r: [_f(r, 3), _f(r, 4)], {"num_arrays": 2})],
    "reset_arrays": [_c(lambda r: [_f(r, 3), _f(r, 4)], {"num_arrays": 2},
                        kind="exact")],
    "multi_lars": [_c(lambda r: [onp.full(3, 0.1, "float32"),
                                 onp.array([4.0, 0.0, 2.0], "float32"),
                                 onp.array([1.0, 1.0, 0.5], "float32"),
                                 onp.array([0.0, 0.1, 0.01], "float32")],
                      {"eta": 1.0, "eps": 0.0})],
    "histogram": [_c(lambda r: [_f(r, 32)], {"bin_cnt": 4, "range": (-1, 1)},
                     kind="exact"),
                  _c(lambda r: [_f(r, 40) * 3], {"bin_cnt": 5},
                     kind="exact"),
                  _c(lambda r: [onp.append(_f(r, 30), [1.0, -1.0, 2.5])
                                .astype("float32"),
                                onp.array([-1.0, -0.2, 0.3, 1.0],
                                          "float32")], {}, kind="exact")],
    "_histogram": "histogram",
    "index_array": [_c(lambda r: [_f(r, 2, 3)], {}, kind="exact"),
                    _c(lambda r: [_f(r, 2, 3, 2)], {"axes": (2, 0)},
                       kind="exact")],
    "_contrib_index_array": "index_array",
    "_npi_share_memory": [_c(lambda r: [_f(r, 2), _f(r, 2)], {},
                             kind="exact")],
    "_npi_diag_indices_from": [_c(lambda r: [_f(r, 3, 3)], {},
                                  kind="exact")],
    "_contrib_dynamic_reshape": [_c(lambda r: [_f(r, 3, 4),
                                               onp.array([4, 3])], {})],
    # legacy NN extras
    "lrn": [_c(lambda r: [onp.abs(_f(r, 1, 8, 2, 2)) + 0.1], {"nsize": 5},
               True),
            _c(lambda r: [_f(r, 2, 6, 3, 3) * 4],
               {"alpha": 1e-2, "beta": 0.75, "knorm": 2.0, "nsize": 3},
               True)],
    "LRN": "lrn",
    "softmax_activation": [_c(lambda r: [_f(r, 2, 5)], {"mode": "instance"},
                              True),
                           _c(lambda r: [_f(r, 2, 3, 2, 2)],
                              {"mode": "channel"}, True)],
    "SoftmaxActivation": "softmax_activation",
    "batch_norm_with_relu": [_c(_BN, {}), _c(_BN, {"fix_gamma": False,
                                                   "eps": 1e-3})],
    "_contrib_BatchNormWithReLU": "batch_norm_with_relu",
    "sync_batch_norm": [_c(_BN, {}), _c(_BN, {"fix_gamma": False})],
    "_contrib_SyncBatchNorm": "sync_batch_norm",
})

# ---------------------------------------------------------------------------
# linalg_legacy
# ---------------------------------------------------------------------------
LINALG = {
    "linalg_gemm": [_c(lambda r: [_f(r, 3, 4), _f(r, 4, 5), _f(r, 3, 5)],
                       {"alpha": 2.0, "beta": 0.5}, True),
                    _c(lambda r: [_f(r, 2, 4, 3), _f(r, 2, 5, 4),
                                  _f(r, 2, 3, 5)],
                       {"transpose_a": True, "transpose_b": True}, True)],
    "linalg_gemm2": [_c(lambda r: [_f(r, 3, 4), _f(r, 5, 4)],
                        {"transpose_b": True}, True),
                     _c(lambda r: [_f(r, 2, 4, 3), _f(r, 2, 4, 5)],
                        {"transpose_a": True, "alpha": 0.5}, True)],
    "linalg_potrf": [_c(lambda r: [_spd(r, 4)], {}, True),
                     _c(lambda r: [_spd(r, 3, (2,))], {"lower": False},
                        True)],
    "linalg_potri": [_c(lambda r: [onp.linalg.cholesky(_spd(r, 4))], {},
                        True)],
    "linalg_trmm": [_c(lambda r: [_f(r, 4, 4), _f(r, 4, 3)], {}, True),
                    _c(lambda r: [_f(r, 2, 3, 3), _f(r, 2, 4, 3)],
                       {"rightside": True, "lower": False,
                        "transpose": True, "alpha": 2.0}, True)],
    "linalg_trsm": [_c(lambda r: [_spd(r, 4), _f(r, 4, 3)], {}, True),
                    _c(lambda r: [_spd(r, 3, (2,)), _f(r, 2, 4, 3)],
                       {"rightside": True, "transpose": True,
                        "alpha": 0.5}, True),
                    _c(lambda r: [_spd(r, 4), _f(r, 4, 2)],
                       {"lower": False}, True)],
    "linalg_syrk": [_c(lambda r: [_f(r, 3, 4)], {}, True),
                    _c(lambda r: [_f(r, 2, 3, 4)],
                       {"transpose": True, "alpha": 3.0}, True)],
    "linalg_syevd": [_c(lambda r: [_spd(r, 4)], {}, True, "eigh")],
    "linalg_gelqf": [_c(lambda r: [_f(r, 3, 5)], {}, True, "lq")],
    "linalg_makediag": [_c(lambda r: [_f(r, 4)], {}, True),
                        _c(lambda r: [_f(r, 2, 3)], {"offset": 1}, True)],
    "linalg_extractdiag": [_c(lambda r: [_f(r, 4, 4)], {}, True),
                           _c(lambda r: [_f(r, 2, 4, 4)], {"offset": -1},
                              True)],
    "linalg_maketrian": [_c(lambda r: [_f(r, 10)], {}, True),
                         _c(lambda r: [_f(r, 2, 6)], {"lower": False},
                            True)],
    "linalg_extracttrian": [_c(lambda r: [_f(r, 4, 4)], {}, True),
                            _c(lambda r: [_f(r, 2, 4, 4)],
                               {"offset": 1, "lower": False}, True)],
    "linalg_sumlogdiag": [_c(lambda r: [_spd(r, 4)], {}, True)],
    "linalg_inverse": [_c(lambda r: [_spd(r, 4)], {}, True)],
    "linalg_eig": [_c(lambda r: [_f(r, 4, 4)], {}, kind="eig")],
    "linalg_eigvals": [_c(lambda r: [_f(r, 4, 4)], {}, kind="eig")],
}
LINALG.update({"_linalg_" + n[len("linalg_"):]: n for n in list(LINALG)
               if n not in ("linalg_eig", "linalg_eigvals")})
LINALG.update({"_npi_eig": "linalg_eig", "_npi_eigvals": "linalg_eigvals"})


# ---------------------------------------------------------------------------
# npi_manip
# ---------------------------------------------------------------------------
def _hawkes(rng):
    k, n, t = 2, 3, 4
    return [onp.array([0.5, 0.3], "float32"), onp.array([0.2, 0.4], "float32"),
            onp.array([1.0, 2.0], "float32"),
            onp.abs(_f(rng, n, k)) * 0.1, onp.abs(_f(rng, n, t)) + 0.1,
            rng.randint(0, k, size=(n, t)).astype("float32"),
            onp.array([4.0, 2.0, 3.0], "float32"),
            onp.array([3.0, 2.5, 4.0], "float32")]


def _mrcnn(rng):
    rois = onp.array([[[0., 0., 15., 15.], [4., 4., 12., 12.],
                       [2.5, 1.0, 9.0, 14.0]],
                      [[1., 2., 8., 8.], [0., 0., 6., 10.],
                       [3., 3., 15., 15.]]], "float32")
    gt = (rng.rand(2, 3, 16, 16) > 0.5).astype("float32")
    return [rois, gt, onp.array([[1, 0, 2], [2, 2, 0]]),
            onp.array([[1, 0, 2], [0, -1, 1]])]


def _rrois(rng, n, size):
    r = rng.uniform(0, 1, size=(n, 6)).astype("float32")
    r[:, 0] = rng.randint(0, 2, size=n)
    r[:, 1:3] = r[:, 1:3] * (size - 1)
    r[:, 3:5] = r[:, 3:5] * size / 2 + 1
    r[:, 5] = rng.uniform(-180, 180, size=n)
    return r


def _calib(rng):
    data = rng.randn(20000)
    h, e = onp.histogram(onp.abs(data), bins=512, range=(0, 8))
    return [h.astype("float32"), e.astype("float32")]


NPI = {
    "unique": [_c(lambda r: [onp.array([3, 1, 2, 2, 3, 3], "float32")], {},
                  kind="exact"),
               _c(lambda r: [r.randint(0, 5, size=(3, 4)).astype("int32")],
                  {"return_index": True, "return_inverse": True,
                   "return_counts": True}, kind="exact"),
               _c(lambda r: [r.randint(0, 2, size=(4, 3)).astype("float32")],
                  {"axis": 0, "return_index": True, "return_inverse": True},
                  kind="exact")],
    "_npi_unique": "unique",
    "nonzero": [_c(lambda r: [onp.array([[1, 0, 2], [0, 3, 0]])], {},
                   kind="exact"),
                _c(lambda r: [_bool(r, 2, 3, 4)], {}, kind="exact")],
    "_npx_nonzero": "nonzero",
    "boolean_mask": [_c(lambda r: [onp.arange(12, dtype="float32")
                                   .reshape(4, 3),
                                   onp.array([1, 0, 1, 0])], {},
                        kind="exact"),
                     _c(lambda r: [_f(r, 3, 5), onp.array([0, 1, 1, 0, 1],
                                                          "float32")],
                        {"axis": 1}, kind="exact")],
    "_contrib_boolean_mask": "boolean_mask",
    "_npi_boolean_mask_assign_scalar": [
        _c(lambda r: [_f(r, 4, 3), _bool(r, 4, 3)], {"value": -1.0}, True),
        _c(lambda r: [_f(r, 4, 3), _bool(r, 4)], {"value": 2.0}, True)],
    "_npi_boolean_mask_assign_tensor": [
        _c(lambda r: [onp.arange(12, dtype="float32").reshape(4, 3),
                      onp.arange(12).reshape(4, 3) > 5,
                      onp.full(6, 9.0, "float32")], {}, kind="exact")],
    "delete": [_c(lambda r: [onp.arange(6, dtype="float32"),
                             onp.array([0, 5])], {}, kind="exact"),
               _c(lambda r: [onp.arange(6, dtype="float32")],
                  {"start": 1, "stop": 5, "step": 2}, kind="exact"),
               _c(lambda r: [_f(r, 3, 4)], {"int_ind": -1, "axis": 1},
                  kind="exact")],
    "_npi_delete": "delete",
    "_npi_insert_scalar": [_c(lambda r: [onp.arange(6, dtype="float32")],
                              {"int_ind": 0, "val": 7.0}, kind="exact"),
                           _c(lambda r: [_f(r, 3, 4),
                                         onp.array([1.0, 2.0, 3.0],
                                                   "float32")],
                              {"int_ind": 2, "axis": 1}, kind="exact")],
    "_npi_insert_slice": [_c(lambda r: [onp.arange(6, dtype="float32"),
                                        onp.array([7.0, 8.0, 9.0],
                                                  "float32")],
                             {"start": 0, "stop": 6, "step": 2},
                             kind="exact")],
    "_npi_insert_tensor": [_c(lambda r: [onp.arange(6, dtype="float32"),
                                         onp.array([8.0, 9.0], "float32"),
                                         onp.array([1, 3])], {},
                              kind="exact"),
                           _c(lambda r: [_f(r, 2, 3),
                                         onp.array([5.0, 6.0], "float32"),
                                         onp.array([3, -1])], {"axis": 1},
                              kind="exact")],
    "advanced_indexing": [_c(lambda r: [_f(r, 4, 5), onp.array([3, 1])], {},
                             kind="exact"),
                          _c(lambda r: [_f(r, 4, 5), _bool(r, 4, 5)], {},
                             kind="exact")],
    "_npi_advanced_indexing": "advanced_indexing",
    "advanced_indexing_multiple": [
        _c(lambda r: [_f(r, 4, 5), onp.array([0, 2]), onp.array([1, 4])], {},
           kind="exact")],
    "_npi_advanced_indexing_multiple": "advanced_indexing_multiple",
    "Concat": [_c(lambda r: [_f(r, 2, 2), _f(r, 2, 3)], {"dim": 1}, True),
               _c(lambda r: [_f(r, 2, 3), _f(r, 1, 3), _f(r, 2, 3)],
                  {"dim": 0, "num_args": 3}, True)],
    "concat": "Concat",
    "hawkesll": [_c(_hawkes, {}, True)],
    "_contrib_hawkesll": "hawkesll",
    "mrcnn_mask_target": [_c(_mrcnn, {"num_rois": 3, "mask_size": (4, 5),
                                      "num_classes": 3}, kind="exact")],
    "_contrib_mrcnn_mask_target": "mrcnn_mask_target",
    "rroi_align": [_c(lambda r: [r.rand(2, 3, 8, 8).astype("float32"),
                                 _rrois(r, 5, 8)],
                      {"pooled_size": (2, 3), "spatial_scale": 1.0}),
                   _c(lambda r: [r.rand(2, 2, 10, 10).astype("float32"),
                                 _rrois(r, 4, 20)],
                      {"pooled_size": (3, 3), "spatial_scale": 0.5})],
    "_contrib_RROIAlign": "rroi_align",
    "calibrate_entropy": [_c(_calib, {}),
                          _c(_calib, {"num_quantized_bins": 63})],
    "_contrib_calibrate_entropy": "calibrate_entropy",
}

MODULES = {"legacy_elemwise": LEGACY, "linalg_legacy": LINALG,
           "npi_manip": NPI}
ALL = {**LEGACY, **LINALG, **NPI}


def cases(name, table=None):
    """The cases of ``name``: its own, or its alias target's. ``table``: a
    table of cases of this form (``ALL`` by default)."""
    table = ALL if table is None else table
    c = table[name]
    return table[c] if isinstance(c, str) else c


def target(name, table=None):
    c = (ALL if table is None else table)[name]
    return c if isinstance(c, str) else name


def inputs(name, i, seed=0, table=None):
    """The numpy inputs of ``name``'s case ``i`` (64-bit narrowed to the
    reference's 32-bit dtypes), made from ``seed`` and the target's name."""
    import zlib

    build = cases(name, table)[i][0]
    rng = onp.random.RandomState(zlib.crc32(
        f"{target(name, table)}/{i}".encode()) + seed)
    out = []
    for a in build(rng):
        a = onp.asarray(a)
        if a.dtype == onp.int64:
            a = a.astype("int32")
        elif a.dtype == onp.float64:
            a = a.astype("float32")
        out.append(a)
    return out


# ---------------------------------------------------------------------------
# the runners: the port's, and the reference's (which imports JAX when it
# is called)
# ---------------------------------------------------------------------------
def cotangents(specs, seed=1):
    """A numpy cotangent for each ``(shape, floating)`` output spec (None
    for the outputs that are not floating)."""
    rng = onp.random.RandomState(seed)
    return [rng.standard_normal(shape).astype("float32") if floating
            else None for shape, floating in specs]


def scalarize(outs, cots, kind):
    """The scalar whose gradient the tests compare: ``sum(o * c)`` over the
    outputs, with the sign-free ``o * o`` for the factors of ``"eigh"`` and
    ``"lq"`` (fixed only up to sign). Works on jax and torch arrays."""
    total = 0
    for j, (o, c) in enumerate(zip(outs, cots)):
        if c is None:
            continue
        sq = kind == "lq" or (kind == "eigh" and j == 0)
        total = total + ((o * o if sq else o) * c).sum()
    return total


def _dtype_of(dtype, j):
    """The dtype input ``j`` is cast to: ``dtype``, or its entry ``j`` where
    it is a dict (None: as made)."""
    return dtype.get(j) if isinstance(dtype, dict) else dtype


def run_port(name, i, device="cpu", attrs=None, dtype=None, seed=0,
             table=None, grad=None):
    """``name``'s case ``i`` on the port at ``device``: ``(outputs, grads)``
    as lists of CPU tensors (``grads`` None unless the case asks for them;
    one per floating input). ``dtype`` casts the floating inputs (a dict:
    the inputs it names by position). ``grad`` False: no gradients,
    whatever the case asks."""
    import torch

    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch.base import narrow, to_dtype
    from mxnet_tpu_torch.ops.registry import get_op

    _, cattrs, cgrad, kind = cases(name, table)[i]
    attrs = cattrs if attrs is None else attrs
    grad = cgrad if grad is None else grad
    ins = []
    for j, a in enumerate(inputs(name, i, seed, table)):
        t = torch.from_numpy(a).to(device)
        dt = _dtype_of(dtype, j)
        if dt is not None and t.is_floating_point():
            t = t.to(to_dtype(dt))
        ins.append(t)
    ctx = tmx.cpu() if device == "cpu" else tmx.gpu()
    with ctx:
        f = get_op(name).fn(**attrs)
        if not grad:
            with torch.no_grad():
                outs = f(*ins)
            outs = outs if isinstance(outs, (tuple, list)) else (outs,)
            return [narrow(o).cpu() for o in outs], None
        leaves = [t.detach().requires_grad_(t.is_floating_point())
                  for t in ins]
        with torch.enable_grad():
            outs = f(*leaves)
            outs = outs if isinstance(outs, (tuple, list)) else (outs,)
            cots = [None if c is None else torch.from_numpy(c).to(device)
                    for c in cotangents([(tuple(o.shape),
                                          o.dtype.is_floating_point)
                                         for o in outs])]
            loss = scalarize(outs, cots, kind)
            wrt = [t for t in leaves if t.requires_grad]
            gs = torch.autograd.grad(loss, wrt, allow_unused=True)
        grads = [torch.zeros_like(w) if g is None else g
                 for g, w in zip(gs, wrt)]
        return ([narrow(o).detach().cpu() for o in outs],
                [g.cpu() for g in grads])


def run_reference(name, i, attrs=None, dtype=None, seed=0, table=None,
                  grad=None):
    """``name``'s case ``i`` on the JAX package (CPU): ``(outputs, grads)``
    as lists of numpy arrays, as :func:`run_port` gives them, and the
    outputs' dtype names."""
    import jax
    import jax.numpy as jnp

    from mxnet_tpu.ops.registry import get_op

    _, cattrs, cgrad, kind = cases(name, table)[i]
    attrs = cattrs if attrs is None else attrs
    grad = cgrad if grad is None else grad
    ins = [jnp.asarray(a) for a in inputs(name, i, seed, table)]
    ins = [x.astype(_dtype_of(dtype, j))
           if _dtype_of(dtype, j) is not None and
           jnp.issubdtype(x.dtype, jnp.floating) else x
           for j, x in enumerate(ins)]
    f = get_op(name).fn(**attrs)
    outs = f(*ins)
    outs = outs if isinstance(outs, (tuple, list)) else (outs,)
    dtypes = [str(o.dtype) for o in outs]
    if not grad:
        return [onp.asarray(o.astype(jnp.float32) if o.dtype == jnp.bfloat16
                            else o) for o in outs], None, dtypes
    fl = [j for j, x in enumerate(ins) if jnp.issubdtype(x.dtype,
                                                          jnp.floating)]
    cots = [None if c is None else jnp.asarray(c)
            for c in cotangents([(o.shape, jnp.issubdtype(o.dtype,
                                                          jnp.floating))
                                 for o in outs])]

    def loss(*xs):
        full = list(ins)
        for j, x in zip(fl, xs):
            full[j] = x
        o = f(*full)
        return scalarize(o if isinstance(o, (tuple, list)) else (o,), cots,
                         kind)

    grads = jax.grad(loss, argnums=tuple(range(len(fl))))(
        *[ins[j] for j in fl])
    return [onp.asarray(o) for o in outs], [onp.asarray(g) for g in grads], \
        dtypes


def compare(kind, got, want, ins=None, rtol=1e-5):
    """Raise AssertionError unless ``got`` (torch tensors) matches ``want``
    (numpy arrays, or tensors) as ``kind`` says; ``ins`` are the numpy
    inputs (the factorizations are checked against them)."""
    got, want = _np(got), _np(want)
    assert len(got) == len(want), (len(got), len(want))
    if kind == "eigh":
        u, w = got
        a = ins[0].astype("float64")
        recon = onp.swapaxes(u, -1, -2) @ (w[..., None] * u)
        _close(recon, a, 1e-4)
        _close(u @ onp.swapaxes(u, -1, -2),
               onp.broadcast_to(onp.eye(u.shape[-1]), u.shape), 1e-4)
        _close(w, want[1], 1e-4)
        return
    if kind == "lq":
        lo, q = got
        a = ins[0].astype("float64")
        _close(lo @ q, a, 1e-4)
        _close(q @ onp.swapaxes(q, -1, -2),
               onp.broadcast_to(onp.eye(q.shape[-2]), q.shape[:-1] +
                                (q.shape[-2],)), 1e-4)
        assert onp.allclose(onp.triu(lo, 1), 0, atol=1e-6)
        _close(abs(lo), abs(want[0]), 1e-4)
        return
    if kind == "eig":
        a = ins[0].astype("complex128")
        w = got[0]
        _close(onp.sort_complex(w), onp.sort_complex(want[0]), 1e-4)
        if len(got) == 2:
            v = got[1]
            _close(a @ v, v * w[..., None, :], 1e-4)
        return
    for g, w in zip(got, want):
        assert g.shape == w.shape, (g.shape, w.shape)
        if kind == "exact":
            onp.testing.assert_array_equal(g, w)
        else:
            _close(g, w, 2.0 ** -21 if kind == "ulp" else rtol)


def _np(xs):
    out = []
    for x in xs:
        if hasattr(x, "detach"):
            import torch

            x = x.detach().cpu()
            x = x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
        out.append(onp.asarray(x))
    return out


def _close(got, want, rtol):
    got = onp.asarray(got, dtype="complex128" if onp.iscomplexobj(got) or
                      onp.iscomplexobj(want) else "float64")
    want = onp.asarray(want, dtype=got.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    nan = onp.isnan(want)
    assert (onp.isnan(got) == nan).all()
    # infinities where the reference has them, the same ones; the scale
    # and the error over the finite entries
    inf = ~nan & ~onp.isfinite(want)
    assert (got[inf] == want[inf]).all()
    scale = max(float(abs(want[~inf & ~nan]).max(initial=0.0)), 1e-30)
    with onp.errstate(invalid="ignore"):
        err = float(abs(onp.where(nan | inf, 0, got - want)).max(
            initial=0.0))
    assert err <= rtol * scale, (err, scale, rtol)


def grad_rtol(kind):
    """The gradients' tolerance, of the largest entry: 1e-5, and 1e-4 for
    the factorizations (inputs of condition number below 100)."""
    return 1e-4 if kind in ("eigh", "lq") else 1e-5


def check_against_reference(name, dtype=None):
    """Every case of ``name`` on the port (CPU) against the JAX package:
    the outputs as the case's kind says, their dtypes, and the floating
    inputs' gradients where the case asks for them."""
    from mxnet_tpu_torch.base import dtype_name

    for i, (_, _, grad, kind) in enumerate(cases(name)):
        want, want_g, want_dt = run_reference(name, i, dtype=dtype)
        got, got_g = run_port(name, i, dtype=dtype)
        ins = inputs(name, i)
        assert [dtype_name(g.dtype) for g in got] == want_dt, \
            (name, i, [g.dtype for g in got], want_dt)
        compare(kind, got, want, ins,
                rtol=1e-5 if kind != "close" or dtype is None else 0.0)
        if grad and dtype is None:
            assert len(got_g) == len(want_g), name
            for g, w in zip(got_g, want_g):
                _close(_np([g])[0], w, grad_rtol(kind))


def check_card(name):
    """Every case of ``name`` on the card against the port on the CPU."""
    for i, (_, _, grad, kind) in enumerate(cases(name)):
        want, want_g = run_port(name, i, "cpu")
        got, got_g = run_port(name, i, "cuda")
        compare(kind, got, want, inputs(name, i))
        if grad:
            for g, w in zip(got_g, want_g):
                _close(_np([g])[0], _np([w])[0], grad_rtol(kind))
