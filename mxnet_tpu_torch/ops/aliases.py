"""Reference-name aliases of registered ops.

Counterpart of ``mxnet_tpu/ops/aliases.py``: the same tables, entry for
entry, and the same rule. The reference names a kernel several ways at once
(a CamelCase legacy name such as ``RNN`` or ``Cast``, ``_npi_``/``_npx_``
numpy-internal names, ``_contrib_`` names); each entry here is a true rename
whose attributes are the target op's. An alias is registered only where its
target exists and the alias itself is not yet a name of the registry;
:func:`_register_all` runs at the end of the ops' import and again at the
end of the package's, as the reference's does, for the targets that
``contrib.quantization`` registers in between (``_contrib_quantize``,
``_contrib_dequantize``).
"""
from .registry import register_alias

# -- legacy CamelCase layer names (reference: src/operator/nn/*.cc) ---------
_LEGACY_CAMEL = {
    "Activation": "activation",
    "BatchNorm": "batch_norm",
    "CuDNNBatchNorm": "batch_norm",   # reference alias: cudnn_batch_norm.cc
    "Convolution": "convolution",
    "Deconvolution": "deconvolution",
    "Dropout": "dropout",
    "Embedding": "embedding",
    "Flatten": "flatten",
    "FullyConnected": "fully_connected",
    "GroupNorm": "group_norm",
    "InstanceNorm": "instance_norm",
    "LayerNorm": "layer_norm",
    "LeakyReLU": "leaky_relu",
    "Pad": "pad",
    "Pooling": "pooling",
    "SequenceMask": "sequence_mask",
    "SequenceLast": "sequence_last",
    "SequenceReverse": "sequence_reverse",
    "CTCLoss": "ctc_loss",
    "RNN": "rnn",
    "ROIPooling": "roi_pooling",
    "UpSampling": "upsampling",
    "SwapAxis": "swapaxes_legacy",     # the reference's legacy_elemwise.py
    "Cast": "astype",
    "BlockGrad": "stop_gradient",
    # spatial-warping / deformable tier (ops/warp_ops.py)
    "BilinearSampler": "bilinear_sampler",
    "GridGenerator": "grid_generator",
    "SpatialTransformer": "spatial_transformer",
    "Correlation": "correlation",
    "_contrib_DeformableConvolution": "deformable_convolution",
    "_contrib_ModulatedDeformableConvolution":
        "modulated_deformable_convolution",
    "_contrib_PSROIPooling": "psroi_pooling",
    "_contrib_DeformablePSROIPooling": "deformable_psroi_pooling",
}

# -- legacy underscore elemwise names (elemwise_binary_op_basic.cc etc.) ----
_LEGACY_UNDER = {
    "_copy": "copy",
    "_copyto": "copy",
    # elemwise_unary_op_basic.cc:245 — bare `identity` is an alias of _copy
    # in the reference; the matrix creator lives at _npi_identity only
    "identity": "copy",
    "_equal": "equal",
    "_not_equal": "not_equal",
    "_greater": "greater",
    "_greater_equal": "greater_equal",
    "_lesser": "less",
    "_lesser_equal": "less_equal",
    "_logical_and": "logical_and",
    "_logical_or": "logical_or",
    "_logical_xor": "logical_xor",
    "_maximum": "maximum",
    "_minimum": "minimum",
    "_hypot": "hypot",
    "_mod": "mod",
    "_power": "power",
    # broadcast_* — every binary op of the registry broadcasts, so the
    # broadcast_ names are true aliases (reference:
    # elemwise_binary_broadcast_op_basic.cc)
    "broadcast_add": "add",
    "broadcast_plus": "add",
    "broadcast_sub": "subtract",
    "broadcast_minus": "subtract",
    "broadcast_mul": "multiply",
    "broadcast_div": "true_divide",
    "broadcast_mod": "mod",
    "broadcast_power": "power",
    "broadcast_maximum": "maximum",
    "broadcast_minimum": "minimum",
    "broadcast_hypot": "hypot",
    "broadcast_equal": "equal",
    "broadcast_not_equal": "not_equal",
    "broadcast_greater": "greater",
    "broadcast_greater_equal": "greater_equal",
    "broadcast_lesser": "less",
    "broadcast_lesser_equal": "less_equal",
    "broadcast_logical_and": "logical_and",
    "broadcast_logical_or": "logical_or",
    "broadcast_logical_xor": "logical_xor",
    # elemwise_* strict (same-shape) variants — broadcasting superset
    "elemwise_add": "add",
    "elemwise_sub": "subtract",
    "elemwise_mul": "multiply",
    "elemwise_div": "true_divide",
    "rsqrt": "reciprocal_sqrt",        # the reference's legacy_elemwise.py
    "_adabelief_update": "adabelief_update",
    "_adamw_update": "adamw_update",
    "_sparse_adagrad_update": "sparse_adagrad_update",
    "_unravel_index": "unravel_index",
    "_ravel_multi_index": "ravel_multi_index",
}

# -- _contrib_* names (src/operator/contrib/*.cc) ---------------------------
_CONTRIB = {
    "_contrib_allclose": "allclose",
    "_contrib_arange_like": "arange_like",
    "_contrib_bipartite_matching": "bipartite_matching",
    "_contrib_box_decode": "box_decode",
    "_contrib_box_encode": "box_encode",
    "_contrib_box_iou": "box_iou",
    "_contrib_box_nms": "box_nms",
    "_contrib_box_non_maximum_suppression": "box_nms",
    "_contrib_group_adagrad_update": "group_adagrad_update",
    "_contrib_index_copy": "index_copy",
    "_contrib_quadratic": "quadratic",
    "_contrib_AdaptiveAvgPooling2D": "adaptive_avg_pool2d",
    "_contrib_BilinearResize2D": "bilinear_resize_2d",
    "_contrib_MultiBoxPrior": "multibox_prior",
    "_contrib_MultiBoxTarget": "multibox_target",
    "_contrib_MultiBoxDetection": "multibox_detection",
    "_contrib_ROIAlign": "roi_align",
    "_contrib_interleaved_matmul_selfatt_qk": "interleaved_matmul_selfatt_qk",
    "_contrib_interleaved_matmul_selfatt_valatt":
        "interleaved_matmul_selfatt_valatt",
    "_contrib_interleaved_matmul_encdec_qk": "interleaved_matmul_encdec_qk",
    "_contrib_interleaved_matmul_encdec_valatt":
        "interleaved_matmul_encdec_valatt",
    "_contrib_quantize": "contrib_quantize",
    "_contrib_dequantize": "contrib_dequantize",
    # the reference operand layout (qdata, qweight[, qbias], min/max ranges)
    # is the _v2 op's contract; the plain contrib op has a scale-based API
    "_contrib_quantized_fully_connected": "quantized_fully_connected_v2",
}

# -- _npi_* numpy-internal names (src/operator/numpy/*.cc) ------------------
_NPI = {
    "_np_reshape": "reshape",
    "_npi_add": "add",
    "_npi_subtract": "subtract",
    "_npi_multiply": "multiply",
    "_npi_true_divide": "true_divide",
    "_npi_mod": "mod",
    "_npi_fmod": "fmod",
    "_npi_power": "power",
    "_npi_powerd": "power",
    "_npi_copysign": "copysign",
    "_npi_arctan2": "arctan2",
    "_npi_hypot": "hypot",
    "_npi_fmax": "fmax",
    "_npi_fmin": "fmin",
    "_npi_gcd": "gcd",
    "_npi_lcm": "lcm",
    "_npi_ldexp": "ldexp",
    "_npi_bitwise_and": "bitwise_and",
    "_npi_bitwise_or": "bitwise_or",
    "_npi_bitwise_xor": "bitwise_xor",
    "_npi_bitwise_not": "invert",
    "_npi_log": "log",
    "_npi_matmul": "matmul",
    "_npi_dot": "dot",
    "_npi_tensordot": "tensordot",
    "_npi_tensordot_int_axes": "tensordot",
    "_npi_kron": "kron",
    "_npi_cross": "cross",
    "_npi_einsum": "einsum",
    "_npi_sum": "sum",
    "_npi_mean": "mean",
    "_npi_prod": "prod",
    "_npi_std": "std",
    "_npi_var": "var",
    "_npi_max": "max",
    "_npi_min": "min",
    "_npi_all": "all",
    "_npi_any": "any",
    "_npi_argmax": "argmax",
    "_npi_argmin": "argmin",
    "_npi_average": "average",
    "_npi_norm": "norm",
    "_npi_trace": "trace",
    "_npi_cumsum": "cumsum",
    "_npi_diff": "diff",
    "_npi_ediff1d": "ediff1d",
    "_npi_percentile": "percentile",
    "_npi_bincount": "bincount",
    "_npi_interp": "interp",
    "_npi_polyval": "polyval",
    "_npi_nan_to_num": "nan_to_num",
    "_npi_around": "round",
    "_npi_deg2rad": "deg2rad",
    "_npi_rad2deg": "rad2deg",
    "_npi_atleast_1d": "atleast_1d",
    "_npi_atleast_2d": "atleast_2d",
    "_npi_atleast_3d": "atleast_3d",
    "_npi_broadcast_to": "broadcast_to",
    "_npi_concatenate": "concatenate",
    "_npi_stack": "stack",
    "_npi_copy": "copy",
    "_npi_flip": "flip",
    "_npi_roll": "roll",
    "_npi_rot90": "rot90",
    "_npi_rollaxis": "rollaxis",
    "_npi_moveaxis": "moveaxis",
    "_npi_squeeze": "squeeze",
    "_npi_transpose": "transpose",
    "_npi_diag": "diag",
    "_npi_diagflat": "diagflat",
    "_npi_diagonal": "diagonal",
    "_npi_fill_diagonal": "fill_diagonal",
    "_npi_tril": "tril",
    "_npi_triu": "triu",
    "_npi_tril_indices": "tril_indices",
    "_npi_pad": "pad",
    "_npi_where": "where",
    "_npi_blackman": "blackman",
    "_npi_hamming": "hamming",
    "_npi_hanning": "hanning",
    "_npi_repeats": "repeat",
    # linalg (src/operator/numpy/linalg/*.cc) — one op, several dispatch
    # names
    "_npi_cholesky": "linalg_cholesky",
    "_npi_eigh": "linalg_eigh",
    "_npi_eigvalsh": "linalg_eigvalsh",
    "_npi_svd": "linalg_svd",
    "_npi_qr": "linalg_qr",
    "_npi_solve": "linalg_solve",
    "_npi_lstsq": "linalg_lstsq",
    "_npi_matrix_rank": "linalg_matrix_rank",
    "_npi_matrix_rank_none_tol": "linalg_matrix_rank",
    "_npi_pinv": "linalg_pinv",
    "_npi_pinv_scalar_rcond": "linalg_pinv",
    "_npi_tensorinv": "linalg_tensorinv",
    "_npi_tensorsolve": "linalg_tensorsolve",
    "_npx_index_add": "index_add",
    "_npx_index_update": "index_update",
}

# legacy _linalg_* names (src/operator/tensor/la_op.cc) → the reference's
# linalg_legacy ops
_LINALG_LEGACY = {
    "_linalg_gemm": "linalg_gemm",
    "_linalg_gemm2": "linalg_gemm2",
    "_linalg_potrf": "linalg_potrf",
    "_linalg_potri": "linalg_potri",
    "_linalg_trmm": "linalg_trmm",
    "_linalg_trsm": "linalg_trsm",
    "_linalg_syrk": "linalg_syrk",
    "_linalg_syevd": "linalg_syevd",
    "_linalg_gelqf": "linalg_gelqf",
    "_linalg_makediag": "linalg_makediag",
    "_linalg_maketrian": "linalg_maketrian",
    "_linalg_extractdiag": "linalg_extractdiag",
    "_linalg_extracttrian": "linalg_extracttrian",
    "_linalg_sumlogdiag": "linalg_sumlogdiag",
    "_linalg_det": "linalg_det",
    "_linalg_inverse": "linalg_inverse",
    "_linalg_slogdet": "linalg_slogdet",
}

ALIASES = {}
for _tbl in (_LEGACY_CAMEL, _LEGACY_UNDER, _CONTRIB, _NPI, _LINALG_LEGACY):
    ALIASES.update(_tbl)


def _register_all():
    """Register every alias whose target exists and whose name is free;
    callable more than once. Targets registered by subpackages imported
    after ``ops`` are picked up by the second call, at the end of the
    package's import."""
    from .registry import _OPS

    for alias, target in ALIASES.items():
        if alias not in _OPS and target in _OPS:
            register_alias(alias, target)
