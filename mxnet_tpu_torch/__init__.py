"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu, for NVIDIA Hopper.

A second package beside ``mxnet_tpu`` (the JAX reference, which it never
imports). It keeps the reference's module layout and names; inside, it is
PyTorch: ``nn.Module``s, plain functions on tensors, an explicit device.
Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; without a GPU and without that argument it raises
:class:`MXNetError`.

The TPU kernels on the ported paths (GPT training through the eager
``gluon.Trainer``, GPT serving through the paged decode engine) are
hand-written CUDA kernels for ``sm_90a`` (``csrc/``), built with nvcc at
first use; see :mod:`mxnet_tpu_torch.ops.cuda_kernels`.
"""
from . import (autograd, base, context, convert, gluon, initializer,
               lr_scheduler, ops, optimizer, random, serve)
from .base import MXNetError
from .context import cpu, gpu, resolve_device
from .convert import params_from_mxnet_tpu, trainer_states_from_mxnet_tpu

__version__ = "0.1.0"

__all__ = ["MXNetError", "cpu", "gpu", "resolve_device",
           "params_from_mxnet_tpu", "trainer_states_from_mxnet_tpu",
           "autograd", "base", "context", "convert", "gluon", "initializer",
           "lr_scheduler", "ops", "optimizer", "random", "serve"]
