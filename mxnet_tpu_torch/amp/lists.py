"""The AMP op lists of the port (a copy of ``mxnet_tpu/amp/lists.py``).

Same names, same order, same roles as the reference's:

- ``MXU_FUNCS``: ops whose products run on the matrix units (the
  tensor cores here). With AMP on, the ops of the port named here cast
  every float32 tensor argument to the AMP dtype at their entry: the
  registry adds the ``__amp__`` attribute to them and wraps their function
  with the casts (:func:`mxnet_tpu_torch.ops.registry._amp_wrap`, the
  reference's ``_amp_wrap``, ``ops/registry.py:283-297``).
- ``FP32_FUNCS``: numerically fragile ops that must never receive
  downcast inputs. They get no cast and no upcast: they follow the dtype
  that flows in, as in the reference, where this list is the audited
  contract.
- every other op follows the dtype that flows in.

The port implements only some of these ops; a name without an op here is
kept so that the lists stay equal to the reference's.
"""
from __future__ import annotations

# matmul/conv-bound ops: cast inputs to the AMP dtype (reference:
# FP16_FUNCS — Convolution/FullyConnected/RNN/_linalg_gemm*/_npi_matmul...)
MXU_FUNCS = (
    "fully_connected",
    "convolution",
    "deconvolution",
    "matmul",
    "dot",
    "batch_dot",
    "einsum",
    "tensordot",
    "inner",
    "vdot",
    "kron",
    "multihead_attention",
    "flash_attention",
    "rnn",                    # fused scan RNN: gate matmuls dominate
    "linalg_gemm",
    "linalg_gemm2",
    "linalg_trmm",
    "deformable_convolution",
    "modulated_deformable_convolution",
    "correlation",            # displacement dot-products
)

# numerically fragile: never downcast inputs (reference: FP32_FUNCS +
# the loss/norm entries of CONDITIONAL_FP32_FUNCS)
FP32_FUNCS = (
    "softmax",
    "log_softmax",
    "masked_softmax",
    "softmin",
    "batch_norm",
    "layer_norm",
    "group_norm",
    "instance_norm",
    "rms_norm",
    "norm",
    "mean",
    "sum",
    "prod",
    "erfinv",
    "exp",
    "expm1",
    "log",
    "log1p",
    "log2",
    "log10",
    "cosh",
    "sinh",
    "tan",
    "arccos",
    "arcsin",
    "power",
    "smooth_l1",
    "ctc_loss",
    "softmax_cross_entropy",
    "linalg_potrf",
    "linalg_inv",
    "linalg_det",
    "cumsum",
    "moments",
)

# AMP dtype names accepted by amp.init (the fp8 names map to
# torch.float8_e4m3fn / torch.float8_e5m2)
AMP_DTYPES = ("bfloat16", "float16", "float8_e4m3fn", "float8_e5m2")
