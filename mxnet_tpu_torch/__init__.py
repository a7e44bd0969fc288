"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu, for NVIDIA Hopper.

A second package beside ``mxnet_tpu`` (the JAX reference, which it never
imports). It keeps the reference's module layout and names; inside, it is
PyTorch: ``NDArray`` over ``torch.Tensor``, one op registry whose
``invoke`` every ``mx.np`` / ``mx.npx`` call goes through, ``nn.Module``
blocks, an explicit device. Every entry point runs on ``cuda`` unless the
caller asks for the CPU (``device="cpu"``, ``ctx=mx.cpu()`` or
``with mx.cpu():``); without a GPU and without that it raises
:class:`MXNetError`. Typical use, as the reference's::

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import np, npx, autograd

    x = np.array([[1.0, 2.0]], ctx=mx.gpu())
    x.attach_grad()
    with autograd.record():
        y = npx.relu(x * 3).sum()
    y.backward()

The TPU kernels on the ported paths (GPT training through the eager
``gluon.Trainer`` and through the compiled step ``Trainer.compile_step``,
one CUDA graph a step, in fp32 or under ``amp`` in bf16, from tensors or
NDArrays; GPT serving through the paged decode engine, the kernel
autotuner ``tune``) are hand-written CUDA kernels for ``sm_90a``
(``csrc/``), built with nvcc at first use; see
:mod:`mxnet_tpu_torch.ops.cuda_kernels`. ``rtc.CudaModule`` compiles CUDA C
given at run time.

The graph layer is the reference's: ``mx.sym`` / ``mx.var`` / ``Symbol``
with its JSON (each package loads the other's), deferred-compute tracing of
a block's forward, ``HybridBlock.export`` and ``gluon.SymbolBlock.imports``,
the ``Executor`` (``Symbol.bind`` / ``simple_bind``) and ``mx.subgraph``
with ``optimize_for("tpu")``, which fuses hand-written attention onto the
flash kernels.

The input pipeline and training utilities are the reference's too:
``gluon.data`` (datasets, samplers, batchify functions, the ``DataLoader``
with serial, thread and spawned-process workers, the ``DevicePrefetcher``
that stages groups of batches for the compiled multi-step on a CUDA stream
of its own, ``vision`` datasets and transforms), ``mx.metric``,
``mx.callback``, ``mx.model`` and the iterators of ``mx.io`` (``CSVIter``
and ``LibSVMIter`` over the reference's native text parser, built with the
host's C++ compiler at first use).

The legacy ``mx.nd`` namespace (:mod:`mxnet_tpu_torch.nd`) and the sparse
arrays of ``mx.nd.sparse`` (CSR and row-sparse, on the device; ``sparse.dot``
and the optimizers' lazy row-sparse updates) are the reference's, as are
the sequence, detection, ROI and resize ops of ``mx.npx``, the transposed
convolutions and ``npx.foreach`` / ``while_loop`` / ``cond``.

Int8 inference after training is ``mx.contrib.quantization``'s:
``quantize_net`` calibrates a trained net (absmax or KL entropy) and swaps
its ``Dense`` layers for int8 x int8 -> int32 products (cuBLASLt's int8
GEMM on the card) and its 2-D convolutions for the reference's quantized
route; the registry holds the reference's quantized op family and the
intgemm protocol (:mod:`mxnet_tpu_torch.ops.quantized_ops`).
"""
from . import (amp, attribute, autograd, base, callback, context, convert,
               engine, executor, gluon, initializer, io, lr_scheduler, metric,
               model, name, ndarray, ops, optimizer, parallel, random, rtc,
               serve, subgraph, symbol, telemetry, train_step, tune,
               visualization)
from . import numpy as np
from . import numpy_extension as npx
from . import nd
from . import contrib
from . import image, recordio
from .attribute import AttrScope
from .base import MXNetError
from .name import NameManager
from .symbol import Symbol, var
from .context import (Context, Device, cpu, current_context, current_device,
                      device, gpu, gpu_memory_info, num_gpus, resolve_device)
from .convert import params_from_mxnet_tpu, trainer_states_from_mxnet_tpu
from .ndarray import NDArray, array

sym = symbol
viz = visualization

__version__ = "0.1.0"

__all__ = ["MXNetError", "Context", "Device", "NDArray", "array", "cpu",
           "gpu", "device", "current_context", "current_device", "num_gpus",
           "gpu_memory_info", "resolve_device", "waitall",
           "params_from_mxnet_tpu", "trainer_states_from_mxnet_tpu", "np",
           "npx", "nd", "amp", "autograd", "base", "context", "convert",
           "engine", "gluon", "initializer", "lr_scheduler", "ndarray",
           "ops", "optimizer", "parallel", "random", "rtc", "serve",
           "telemetry", "train_step", "tune", "sym", "symbol", "Symbol",
           "var", "executor", "subgraph", "attribute", "name", "AttrScope",
           "NameManager", "visualization", "viz", "metric", "callback",
           "model", "io", "contrib", "image", "recordio"]


def waitall():
    engine.wait_all()


# the reference's alias names of ops that subpackages registered after ops
# (contrib.quantization's quantize and dequantize)
ops.aliases._register_all()
