"""gluon.Block / HybridBlock as ``torch.nn.Module``s.

Counterpart of ``mxnet_tpu/gluon/block.py``. A block's parameters are
``torch.nn.Parameter``s registered by attribute, so ``collect_params()``
names them exactly as the reference does (``:52-60``): the attribute path
joined by dots, own parameters before children's, in registration order
(``blocks.0.attn_qkv.weight``, ``ln_f.gamma``, ...).

Execution is eager; ``hybridize`` is accepted for API parity and changes
nothing. A block starts in inference mode (``training`` False). Dropout is
active inside ``autograd.record()`` (which sets the training flag, as in the
reference) or after the torch idiom ``block.train()``; elsewhere it is the
identity, so serving never drops units.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as onp
import torch

from .. import initializer as init_mod
from ..base import MXNetError
from .parameter import Parameter

__all__ = ["Block", "HybridBlock", "new_parameter"]


def new_parameter(shape, dtype, device, init=None, grad_req="write"):
    """A :class:`~mxnet_tpu_torch.gluon.parameter.Parameter` of ``shape``
    filled with zeros until ``initialize`` or ``load_parameters``; ``init``
    is its own initializer (the block's default applies when None)."""
    return Parameter(torch.zeros(shape, dtype=dtype, device=device),
                     grad_req=grad_req, init=init_mod.create(init))


class Block(torch.nn.Module):
    """Base container (reference: gluon/block.py:34)."""

    def __init__(self):
        super().__init__()
        self.train(False)

    def collect_params(self):
        """``OrderedDict`` of name -> parameter."""
        return OrderedDict(self.named_parameters())

    @property
    def device(self):
        for p in self.parameters():
            return p.device
        raise MXNetError(f"{type(self).__name__} holds no parameters")

    @torch.no_grad()
    def initialize(self, init=None, seed=None):
        """Fill every parameter from its own initializer, else ``init``
        (default ``Uniform(0.07)``), drawing from a CPU ``torch.Generator``
        seeded with ``seed`` — so a seed gives the same weights on every
        device."""
        default = init_mod.create(init) or init_mod.Uniform(0.07)
        gen = torch.Generator()
        if seed is None:
            gen.seed()
        else:
            gen.manual_seed(int(seed))
        for p in self.collect_params().values():
            host = torch.empty(p.shape, dtype=torch.float32)
            (getattr(p, "mx_init", None) or default)(host, gen)
            p.copy_(host)

    def hybridize(self, active=True, **kwargs):
        """Accepted for API parity: the port runs eagerly."""

    # -- persistence (reference: block.py:117-153) ---------------------------
    def save_parameters(self, filename):
        """Write the parameters in the reference's ``.params`` format: a
        numpy ``savez`` archive keyed by ``collect_params()`` names
        (bfloat16 stored as float32)."""
        arrays = {}
        for name, p in self.collect_params().items():
            t = p.detach()
            if t.dtype == torch.bfloat16:
                t = t.float()
            arrays[name] = t.cpu().numpy()
        with open(filename, "wb") as fh:
            onp.savez(fh, **arrays)

    def load_parameters(self, filename):
        """Load a ``.params`` file written by either package; every name
        and shape must match."""
        with onp.load(filename) as z:
            self.load_dict({n: z[n] for n in z.files})

    @torch.no_grad()
    def load_dict(self, arrays):
        """Copy ``{name: numpy array or tensor}`` into the parameters
        through :func:`~mxnet_tpu_torch.convert.params_from_mxnet_tpu`,
        which checks every name and shape."""
        from ..convert import params_from_mxnet_tpu

        arrays = {n: (a.detach().cpu().numpy()
                      if isinstance(a, torch.Tensor) else a)
                  for n, a in arrays.items()}
        params = self.collect_params()
        for name, t in params_from_mxnet_tpu(arrays, self).items():
            params[name].copy_(t)


class HybridBlock(Block):
    """Block the reference can compile into one program; eager here."""
