"""Learner: forward, backward and the optimizer update as one CUDA graph a step.

Counterpart of ``mxnet_tpu/parallel/learner.py``. The reference compiles a
Gluon block's whole training step, forward, ``value_and_grad`` and an optax
update, into one donated-buffer program over a mesh. On one card the
reference's default mesh is one ``dp`` device, and the math is the same;
the port captures the step into one ``torch.cuda.CUDAGraph`` through
``cached_op.GraphPool``, the port's one capture policy, and replays it once
a step:

- the step is the reference's (:114-168): a settle forward under
  ``autograd.pause()`` fills deferred shapes; the body runs the forward in
  training mode (``autograd.record()``), the loss ``loss_fn(net(x),
  y).mean()``, its gradients for the trainable parameters (``grad_req`` not
  ``'null'``) with ``torch.autograd.grad``, and the update. The forward
  reads aliases of the trainables (``gluon.block.rebound``: their storage,
  gradient accumulators of their own), so the capture never meets an
  accumulator that an earlier eager step left on another stream, and
  ``p.grad`` and the ``grad_req`` hooks are not part of the step;
- parameters and optimizer state are updated in place, where the reference
  donates them; BatchNorm writes its running statistics in place inside the
  forward, the reference's aux updates written back;
- inputs are copied into static buffers; each new ``(shape, dtype)``
  signature of ``(x, y)`` builds (traces and captures) a program of its
  own, as the reference retraces (:170-176); the optimizer state is kept
  across them;
- the first call of a signature on the card runs the step eagerly on the
  pool's side stream (a real step), then captures it; later calls replay.
  The dropout generator of :mod:`mxnet_tpu_torch.random` is registered with
  the graph, standing in for the reference's per-step key (:180), so each
  replay draws fresh masks;
- the body runs under the AMP state of the call that built its program.

``remat=True`` recomputes the whole forward in backward, as
``jax.checkpoint(fwd)`` (:140-141), by ``torch.utils.checkpoint``
(non-reentrant). Dropout draws from the port's own generator, which
``preserve_rng_state`` does not cover, so the recompute would draw other
masks; the step saves that generator's state before the forward and puts
it back around the recompute (inside a capture, graph-safely: the
recompute draws from a clone of the generator's state registered with the
graph, set to the generator's state before each replay). BatchNorm's
statistics are restored after the recompute, so they move once a step.

The optimizer is mapped to the semantics of the reference's optax
transformations (:func:`to_optax`), not to the port's ``Trainer`` update:
moments in the parameters' dtype (bf16 after
``amp.convert_hybrid_block``), the update in the gradients' dtype, weight
decay on every parameter.

On the CPU, as the tests run it, the same body runs eagerly each step. A
failed capture or replay raises :class:`MXNetError`; nothing falls back to
eager execution. Not ported: the mesh and parameter layouts (ROADMAP A8).
"""
from __future__ import annotations

import contextlib
import os

import numpy as onp
import torch
import torch.utils.checkpoint

from .. import amp as _amp
from .. import autograd as _ag
from .. import random as _random
from ..base import MXNetError, to_dtype
from ..cached_op import GraphPool, _alias, _forget_fresh
from ..gluon.block import rebound, unwrap
from ..ndarray.ndarray import NDArray

__all__ = ["Learner", "to_optax", "GradientTransformation"]

_MESH = ("the port's Learner runs on one device: a mesh and parameter "
         "layouts come with ROADMAP A8 (parallelism) of the PyTorch/CUDA "
         "port")


# ---------------------------------------------------------------------------
# optax's transformations, in place over lists of tensors
# ---------------------------------------------------------------------------
def _rounded(c, dtype):
    """The Python number ``c`` as the reference's weakly typed scalar meets
    an array of ``dtype``: rounded to it."""
    return float(torch.tensor(c, dtype=torch.float64).to(dtype))


_CHUNK = 1 << 25     # values a pass of the update covers at once


def _groups(tensors):
    """Index lists of ``tensors`` by dtype (the foreach ops run one dtype at
    a time, where a scalar is rounded to that dtype), each cut into chunks
    of at most ``_CHUNK`` values (or one tensor), so that the update's
    temporaries stay small beside the activations."""
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    out = []
    for dt, idx in by_dtype.items():
        chunk, n = [], 0
        for i in idx:
            if chunk and n + tensors[i].numel() > _CHUNK:
                out.append((dt, chunk))
                chunk, n = [], 0
            chunk.append(i)
            n += tensors[i].numel()
        out.append((dt, chunk))
    return out


def _take(xs, idx):
    return [xs[i] for i in idx]


class _Clip:
    """``optax.clip(max_delta)``: each update clipped elementwise."""

    def __init__(self, max_delta):
        self.max_delta = float(max_delta)

    def init(self, params):
        return {}

    def update(self, updates, state, params):
        for dt, idx in _groups(updates):
            m = _rounded(self.max_delta, dt)
            u = _take(updates, idx)
            torch._foreach_clamp_min_(u, -m)
            torch._foreach_clamp_max_(u, m)
        return updates


class _AddDecayedWeights:
    """``optax.add_decayed_weights(wd)``: ``g + wd * p`` (every
    parameter)."""

    def __init__(self, wd):
        self.wd = float(wd)

    def init(self, params):
        return {}

    def update(self, updates, state, params):
        for dt, idx in _groups(updates):
            torch._foreach_add_(_take(updates, idx), torch._foreach_mul(
                _take(params, idx), _rounded(self.wd, dt)))
        return updates


class _Trace:
    """``optax.trace(decay)`` (heavy ball, no Nesterov): ``t = g + decay *
    t``, the update ``t``; ``t`` in the parameters' dtype."""

    def __init__(self, decay):
        self.decay = float(decay)

    def init(self, params):
        return {"trace": [torch.zeros_like(p) for p in params]}

    def update(self, updates, state, params):
        for dt, idx in _groups(updates):
            tr = _take(state["trace"], idx)
            torch._foreach_mul_(tr, _rounded(self.decay, dt))
            torch._foreach_add_(tr, _take(updates, idx))
        return [t.clone() for t in state["trace"]]


class _ScaleByAdam:
    """``optax.scale_by_adam(b1, b2, eps)``: moments in the parameters'
    dtype, an int32 count, the bias corrections computed in float32 and
    cast to each moment's dtype before they divide."""

    def __init__(self, b1, b2, eps):
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)

    def init(self, params):
        dev = params[0].device
        return {"count": torch.zeros((), dtype=torch.int32, device=dev),
                "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    def update(self, updates, state, params):
        b1, b2 = self.b1, self.b2
        count = state["count"]
        count.add_(1)
        t = count.float()
        bc1 = 1.0 - torch.pow(b1, t)
        bc2 = 1.0 - torch.pow(b2, t)
        out = list(updates)
        for dt, idx in _groups(updates):
            g = _take(updates, idx)
            mu, nu = _take(state["mu"], idx), _take(state["nu"], idx)
            # (1 - b1) g + b1 mu and (1 - b2) g^2 + b2 nu, in place (the
            # sum's order does not change its rounding)
            torch._foreach_mul_(mu, _rounded(b1, dt))
            torch._foreach_add_(mu, torch._foreach_mul(
                g, _rounded(1.0 - b1, dt)))
            sq = torch._foreach_mul(g, g)
            torch._foreach_mul_(sq, _rounded(1.0 - b2, dt))
            torch._foreach_mul_(nu, _rounded(b2, dt))
            torch._foreach_add_(nu, sq)
            del sq
            upd = torch._foreach_div(mu, bc1.to(dt))
            den = torch._foreach_div(nu, bc2.to(dt))
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, _rounded(self.eps, dt))
            torch._foreach_div_(upd, den)
            for i, u in zip(idx, upd):
                out[i] = u
        return out


class _ScaleByTrustRatio:
    """``optax.scale_by_trust_ratio()`` (LAMB's): each update times
    ``|p| / |u|`` of its whole tensor, 1 where either norm is 0. The
    groups never split a tensor, so each norm is whole. The norms are
    returned in the tensor's dtype, as optax's ``safe_norm`` reduces in the
    array's dtype (``_norms``: summed in float32 on the card, float64 on
    the CPU); the ratio and the product are in the update's dtype, as
    optax's."""

    def init(self, params):
        return {}

    @staticmethod
    def _norms(ts):
        """The tensors' 2-norms, stacked, in their dtype: one multi-tensor
        pass on the card; on the CPU ``optimizer_ops.norm`` (summed in
        float64: torch's CPU ``_foreach_norm`` sums float32 in float32
        lanes)."""
        if ts[0].device.type == "cpu":
            from ..ops.optimizer_ops import norm

            return torch.stack([norm(t) for t in ts])
        return torch.stack(torch._foreach_norm(ts))

    def update(self, updates, state, params):
        for dt, idx in _groups(updates):
            u = _take(updates, idx)
            p_norm = self._norms(_take(params, idx))
            u_norm = self._norms(u)
            ratio = torch.where((p_norm == 0) | (u_norm == 0),
                                torch.ones_like(p_norm), p_norm / u_norm)
            torch._foreach_mul_(u, list(ratio.to(dt).unbind()))
        return updates


class _ScaleByLearningRate:
    """``optax.scale_by_learning_rate(lr)``: the update times ``-lr``."""

    def __init__(self, lr):
        self.lr = float(lr)

    def init(self, params):
        return {}

    def update(self, updates, state, params):
        for dt, idx in _groups(updates):
            torch._foreach_mul_(_take(updates, idx), _rounded(-self.lr, dt))
        return updates


class GradientTransformation:
    """A chain of optax's transformations over the trainable parameters,
    their state kept as tensors (``init``) and advanced in place by
    ``update``, which may write into the gradients it is given (the
    multi-tensor passes run in place, to keep one step's temporaries to two
    copies of the parameters); ``apply`` adds the updates to the parameters
    in place (``optax.apply_updates``, the sum cast to each parameter's
    dtype)."""

    def __init__(self, *transforms):
        self.transforms = list(transforms)

    def init(self, params):
        return [t.init(params) for t in self.transforms]

    def update(self, grads, state, params):
        updates = list(grads)
        for t, st in zip(self.transforms, state):
            updates = t.update(updates, st, params)
        return updates

    @staticmethod
    def apply(params, updates):
        same = [i for i, (p, u) in enumerate(zip(params, updates))
                if u.dtype == p.dtype]
        torch._foreach_add_(_take(params, same), _take(updates, same))
        for i, (p, u) in enumerate(zip(params, updates)):
            if u.dtype != p.dtype:
                p.copy_((p + u).to(p.dtype))


def to_optax(optimizer):
    """The reference's ``to_optax`` (:25-59): the optax semantics of an
    optimizer of the port, as a :class:`GradientTransformation` (the port
    does not use optax; a ``GradientTransformation`` passes through).
    Mapped: ``SGD`` (heavy-ball momentum, decay by
    ``add_decayed_weights``), ``Adam`` (decay by ``add_decayed_weights``
    before the chain), ``AdamW``, and ``LAMB`` as ``optax.lamb``:
    ``scale_by_adam``, ``add_decayed_weights(wd)`` over every parameter,
    ``scale_by_trust_ratio``, ``scale_by_learning_rate`` (LAMB's
    ``lower_bound``, ``upper_bound`` and ``bias_correction`` are not read,
    as in the reference: optax's LAMB always corrects the bias and bounds
    nothing). ``clip_gradient`` is an elementwise ``clip``.
    ``rescale_grad`` and ``lr_mult``/``wd_mult`` are not read, as in the
    reference."""
    from .. import optimizer as opt_mod

    if isinstance(optimizer, GradientTransformation):
        return optimizer
    lr = optimizer.learning_rate
    chain = []
    if optimizer.clip_gradient is not None:
        chain.append(_Clip(optimizer.clip_gradient))
    if isinstance(optimizer, opt_mod.AdamW):
        chain.append(_ScaleByAdam(optimizer.beta1, optimizer.beta2,
                                  optimizer.epsilon))
        if optimizer.wd:
            chain.append(_AddDecayedWeights(optimizer.wd))
        chain.append(_ScaleByLearningRate(lr))
    elif isinstance(optimizer, opt_mod.Adam):
        chain += [_ScaleByAdam(optimizer.beta1, optimizer.beta2,
                               optimizer.epsilon), _ScaleByLearningRate(lr)]
        if optimizer.wd:
            chain.insert(0, _AddDecayedWeights(optimizer.wd))
    elif isinstance(optimizer, opt_mod.LAMB):
        chain.append(_ScaleByAdam(optimizer.beta1, optimizer.beta2,
                                  optimizer.epsilon))
        if optimizer.wd:
            chain.append(_AddDecayedWeights(optimizer.wd))
        chain += [_ScaleByTrustRatio(), _ScaleByLearningRate(lr)]
    elif isinstance(optimizer, opt_mod.SGD):
        if optimizer.wd:
            chain.append(_AddDecayedWeights(optimizer.wd))
        if optimizer.momentum:
            chain.append(_Trace(optimizer.momentum))
        chain.append(_ScaleByLearningRate(lr))
    else:
        raise MXNetError(f"no optax mapping for {type(optimizer).__name__}; "
                         f"pass a GradientTransformation instead")
    return GradientTransformation(*chain)


# ---------------------------------------------------------------------------
# remat: the port's generator around the recompute
# ---------------------------------------------------------------------------
def _capturing():
    return torch.cuda.is_available() and torch.cuda.is_initialized() and \
        torch.cuda.is_current_stream_capturing()


class _RematState:
    """What ``torch.utils.checkpoint`` leaves out: the port's dropout
    generator drawn again in the recompute as in the forward, and the
    net's other parameters (BatchNorm's statistics) as the forward left
    them."""

    def __init__(self, gen, aux):
        self.gen = gen
        self.aux = aux
        self.clone = None       # the recompute's state inside a capture
        self.saved = None

    @contextlib.contextmanager
    def _forward(self):
        if not _capturing():
            self.saved = self.gen.get_state()
        yield

    @contextlib.contextmanager
    def _recompute(self):
        kept = [a.detach().clone() for a in self.aux]
        if _capturing():
            main = self.gen.graphsafe_get_state()
            self.gen.graphsafe_set_state(self.clone)
            try:
                yield
            finally:
                self.gen.graphsafe_set_state(main)
        else:
            after = self.gen.get_state()
            self.gen.set_state(self.saved)
            try:
                yield
            finally:
                self.gen.set_state(after)
        with torch.no_grad():
            for a, k in zip(self.aux, kept):
                a.copy_(k)

    def contexts(self):
        return self._forward(), self._recompute()


# ---------------------------------------------------------------------------
class _Program:
    """The step of one input signature: static buffers, the body and, on
    the card, its graph."""

    def __init__(self, learner, x, y, nd):
        self.learner = learner
        self.device = dev = learner._device
        self.nd = nd
        self.x = torch.empty(x.shape, dtype=x.dtype, device=dev)
        self.y = torch.empty(y.shape, dtype=y.dtype, device=dev)
        self.loss = None        # the loss, in its dtype (the first step)
        self.amp_state = _amp._snapshot()
        self.graph = None
        self.captured_launches = None
        self.captured_dtypes = None
        self.replays = 0
        # the trainables' aliases the body differentiates (their storage;
        # gradient accumulators of their own, made on the capture's stream)
        self.aliases = [_alias(p, True) for p in learner._params]
        self.swap = {id(p): a for p, a in zip(learner._params, self.aliases)}
        self.remat = None
        if learner._remat:
            held = {id(p) for p in learner._params}
            aux = [p for p in learner.net.parameters() if id(p) not in held]
            self.remat = _RematState(_random.generator(dev), aux)

    def _forward_loss(self, x, y):
        """The loss in training mode, recorded: the recompute of remat runs
        it again from inside the backward, where neither holds."""
        ln = self.learner
        if self.nd:
            x, y = NDArray(x), NDArray(y)
        with _amp._scoped(self.amp_state), _ag.record(), \
                rebound(ln.net, self.swap):
            out = ln.loss_fn(ln.net(x), y)
            return unwrap(out).mean()

    def body(self):
        ln = self.learner
        with _amp._scoped(self.amp_state):
            if self.remat is None:
                loss = self._forward_loss(self.x, self.y)
            else:
                loss = torch.utils.checkpoint.checkpoint(
                    self._forward_loss, self.x, self.y,
                    use_reentrant=False, preserve_rng_state=False,
                    context_fn=self.remat.contexts)
            grads = torch.autograd.grad(loss, self.aliases,
                                        allow_unused=True,
                                        materialize_grads=True)
            _forget_fresh(self.aliases)
            with torch.no_grad():
                updates = ln.tx.update(list(grads), ln._opt_state,
                                       ln._params)
                ln.tx.apply(ln._params, updates)
                if self.loss is None:
                    self.loss = torch.empty((), dtype=loss.dtype,
                                            device=self.device)
                self.loss.copy_(loss.detach())

    def run(self, x, y):
        with torch.no_grad():
            self.x.copy_(x, non_blocking=True)
            self.y.copy_(y, non_blocking=True)
        if self.device.type != "cuda":
            self.body()
        elif self.graph is None:
            self._warm_and_capture()
        else:
            if self.remat is not None and self.remat.clone is not None:
                self.remat.clone.set_state(self.remat.gen.get_state())
            GraphPool.replay(self.graph, "Learner.step")
            self.replays += 1

    def _warm_and_capture(self):
        """The real first step of this signature, then its capture
        (``cached_op.GraphPool``), with the dropout generator and, under
        remat, the recompute's clone of its state registered when the step
        draws."""
        def clone(gen):
            if self.remat is None:
                return []
            self.remat.clone = gen.clone_state()
            return [self.remat.clone]

        _, self.graph, _, self.captured_launches, self.captured_dtypes, _ = \
            self.learner._graph_pool().capture(
                self.body, "Learner.step", _random.generator(self.device),
                clone)
        self.learner._captures += 1


class Learner:
    """One-device training-step compiler (reference :62).

    ``net``: the model (initialised; deferred shapes are filled by the
    first step); ``loss_fn(pred, label)``: a loss array (``gluon.loss``
    works); ``optimizer``: an optimizer of the port or a
    :class:`GradientTransformation`; ``remat``: recompute the forward in
    backward. ``mesh`` and ``param_spec_fn`` raise: parallelism is ROADMAP
    A8. ``step(x, y)`` takes NDArrays or tensors and returns the scalar
    loss as an NDArray."""

    def __init__(self, net, loss_fn, optimizer, mesh=None, param_spec_fn=None,
                 remat=False):
        if mesh is not None or param_spec_fn is not None:
            raise MXNetError(f"Learner(mesh=..., param_spec_fn=...): "
                             f"{_MESH}")
        self.net = net
        self.loss_fn = loss_fn
        self.tx = to_optax(optimizer)
        self._remat = bool(remat)
        self._params = None     # collected at the first step
        self._param_names = None
        self._opt_state = None
        self._device = None
        self._programs = {}     # (x, y) signature -> _Program
        self._traces = 0        # programs built
        self._captures = 0      # graphs captured
        self._gpool = None

    def _graph_pool(self):
        if self._gpool is None:
            self._gpool = GraphPool(self._device)
        return self._gpool

    # -- tracing ------------------------------------------------------------
    def _collect(self):
        params = self.net.collect_params()
        for name, p in params.items():
            if p.grad_req != "null" and getattr(p, "is_deferred", False):
                raise MXNetError(
                    f"parameter {name} is still uninitialized after the "
                    "settle forward — initialize it or set grad_req='null'")
        self._param_names = [n for n, p in params.items()
                             if p.grad_req != "null"]
        self._params = [params[n] for n in self._param_names]
        if not self._params:
            raise MXNetError("Learner: the net has no trainable parameter")
        self._device = self._params[0].device

    def _build(self, x, y, nd):
        """The settle forward (deferred shapes, predict mode), the
        trainables and the optimizer state on the first build, and the
        program of this signature."""
        if any(getattr(p, "is_deferred", False)
               for p in self.net.parameters()):
            with _ag.train_mode(), _ag.pause(), torch.no_grad():
                dev = next(iter(self.net.parameters())).device
                xs = x.to(dev)
                self.net(NDArray(xs) if nd else xs)
        if self._params is None:
            self._collect()
        if self._opt_state is None:
            self._opt_state = self.tx.init(self._params)
        self._traces += 1
        return _Program(self, x, y, nd)

    # -- stepping -----------------------------------------------------------
    def step(self, x, y):
        """One fused forward, backward and update step; returns the scalar
        loss as an NDArray."""
        prog = self._program(x, y)
        prog.run(unwrap(x), unwrap(y))
        return NDArray(prog.loss.clone())

    def _program(self, x, y):
        nd = isinstance(x, NDArray) or isinstance(y, NDArray)
        x, y = unwrap(x), unwrap(y)
        sig = (tuple(x.shape), x.dtype, tuple(y.shape), y.dtype, nd)
        prog = self._programs.get(sig)
        if prog is None:
            prog = self._programs[sig] = self._build(x, y, nd)
        return prog

    def _run_eager(self, x, y):
        """The step of ``(x, y)`` run eagerly on the current stream, its
        program's graph untouched: the reference a replay is held to."""
        prog = self._program(x, y)
        with torch.no_grad():
            prog.x.copy_(unwrap(x))
            prog.y.copy_(unwrap(y))
        prog.body()
        return NDArray(prog.loss.clone())

    def graph_stats(self):
        """Per signature: captured launches (None before the capture or
        off the card) and replays."""
        return [{"captured_launches": p.captured_launches,
                 "captured_dtypes": p.captured_dtypes,
                 "replays": p.replays} for p in self._programs.values()]

    # -- checkpointing (reference :194-236) ---------------------------------
    def _checkpoint_tree(self):
        """The reference's tree, flat: ``params/<name>`` (trainables),
        ``aux/<name>`` (the net's other parameters, BatchNorm's statistics)
        and ``opt_state/<i>/<field>[/<name>]``."""
        if self._params is None:
            raise MXNetError("Learner has not traced yet — run a step "
                             "before checkpoint operations (shapes come "
                             "from the live state)")
        tree = {f"params/{n}": p for n, p in zip(self._param_names,
                                                 self._params)}
        held = set(self._param_names)
        for n, p in self.net.collect_params().items():
            if n not in held and not getattr(p, "is_deferred", False):
                tree[f"aux/{n}"] = p
        for i, st in enumerate(self._opt_state):
            for field, val in st.items():
                if isinstance(val, list):
                    for n, t in zip(self._param_names, val):
                        tree[f"opt_state/{i}/{field}/{n}"] = t
                else:
                    tree[f"opt_state/{i}/{field}"] = val
        return tree

    def save_checkpoint(self, directory):
        """Write params, aux and the optimizer state into
        ``directory/checkpoint.npz`` (numpy ``savez``, bfloat16 stored as
        float32, as ``.params`` files)."""
        arrays = {}
        for name, t in self._checkpoint_tree().items():
            t = t.detach()
            if t.dtype == torch.bfloat16:
                t = t.float()
            arrays[name] = t.cpu().numpy()
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, "checkpoint.npz"), "wb") as fh:
            onp.savez(fh, **arrays)

    @torch.no_grad()
    def restore_checkpoint(self, directory):
        """Load what :meth:`save_checkpoint` wrote, in place (a captured
        step reads it at its next replay); every name and shape must match
        the live state."""
        tree = self._checkpoint_tree()
        with onp.load(os.path.join(directory, "checkpoint.npz")) as z:
            if sorted(z.files) != sorted(tree):
                raise MXNetError(
                    f"checkpoint {directory!r} does not match the learner's "
                    f"state: {sorted(set(z.files) ^ set(tree))}")
            for name, t in tree.items():
                a = z[name]
                if tuple(a.shape) != tuple(t.shape):
                    raise MXNetError(f"checkpoint {name}: shape "
                                     f"{a.shape} against {tuple(t.shape)}")
                t.copy_(torch.from_numpy(a).to(to_dtype(t.dtype)))
