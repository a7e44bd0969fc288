"""CompiledTrainStep: the whole training step as one CUDA graph.

Counterpart of ``mxnet_tpu/train_step.py:578-905`` (the one-device path of
``CompiledTrainStep``, ``_collect`` :909, ``_build_program`` :1008, ``_run``
:2146, ``_run_multi`` :2196 and the eager fallback :2267). The reference
traces forward, loss, backward and the optimizer update into one
donated-buffer XLA program; the port captures the same body into one
``torch.cuda.CUDAGraph`` and replays it, one replay a step:

- the body runs the forward under ``autograd.record()`` (so dropout is
  active), takes the mean loss, computes the gradients functionally with
  ``torch.autograd.grad`` (the reference's in-program vjp; ``p.grad`` and
  the ``grad_req`` hooks are not part of the step) and runs the
  ``Trainer``'s fused multi-tensor update on them;
- static buffers stand in for donation: the parameters and the trainer's
  optimizer states are the graph's weights and states, written in place;
  inputs are copied into static ``x``/``y`` buffers before each replay;
- the hypers ride as device tensors filled before each replay by one
  host-to-device copy (a ``[K, 3, n]`` table of lr, wd and t per trainable,
  then ``rescale_grad / loss_scale`` and the loss scale), so an lr schedule
  or a growing t never captures again. One graph is kept per input
  signature; ``_traces`` counts captures;
- update counts are staged (``Optimizer._staged_counts_k``) and committed
  after the step only for steps that were not skipped;
- with a loss scaler the body seeds the backward with the loss scale,
  checks the scaled gradients for finiteness on the device, keeps the old
  weights and states where they are not (``torch.where``) and records the
  flag; reading the flags is the call's one host sync, after which the
  scaler replays them (``LossScaler.replay``). Without a scaler nothing
  syncs;
- the returned loss is a copy on the device (the next replay overwrites
  the static one). Called with NDArrays, the step takes their tensors and
  returns the loss as an NDArray, as the reference's step does.

Multi-step (``multi_step=K``) and accumulation (``accumulate=G``) replay
the one-step graph K times a call, the hyper table's row chosen on the
device by a committed-step counter, so an overflow-skipped inner step reads
its row again as the eager loop would re-stage it; the graph reads its
microbatch from the static input that the host refills (a device copy)
before each replay. ``accumulate=G`` unrolls G forward/backward passes in
the body and averages their gradients before the one update.

On CUDA the first call of a signature runs the body once eagerly on a side
stream (a real, counted step: optimizer states are created, kernels built
and tuning lookups made there), then captures it, by the port's one capture
policy (``cached_op.GraphPool``: one side stream and one memory pool for
the step's programs, ``capture_error_mode="thread_local"``, the garbage
collector paused). The device generator of
:mod:`mxnet_tpu_torch.random` that dropout draws from is registered with
each graph, so every replay draws fresh masks and ``random.seed`` resets
them. A failed capture or replay raises :class:`MXNetError`; nothing falls
back to eager execution. The kernels' tiles are resolved while capturing
and frozen in the graph (the flash backward's tile is resolved in its
forward): keep tuning off, or fixed, while a compiled step trains. The
kernels' launch counters move at capture only; ``captured_launches`` holds
the counts of the last capture, ``captured_dtypes`` its launches by kernel
and operand dtypes (``cuda_kernels.dtype_counts``). On the CPU, as the
tests run it, the same body runs eagerly each step.

Mixed precision: a program runs its body under the AMP state
(:mod:`mxnet_tpu_torch.amp`, on or off and its dtype) of the call that
built it, as the reference traces under the AMP state of its first call
and does not key its cache on that state. A graph captured under
``amp.autocast("bfloat16")`` replays its bf16 casts and the bf16 instances
of the kernels, whatever the state of later calls; on the CPU the body runs
under the recorded state each step. Build a new step (``compile_step``) to
train under another state. A parameter cast to another dtype
(``Parameter.cast``, ``amp.convert_hybrid_block``) lies at a new address,
so the next call captures anew.

BatchNorm: the forward of the body writes the new running statistics into
the net's ``running_mean``/``running_var`` in place, so the update is part
of the captured graph and each replay advances them once a forward (G
times a step with ``accumulate=G``, microbatch by microbatch, as the
reference's scan); the warm step advances them once and the capture runs
nothing, so N calls leave them where N eager steps would. Parameters of
unknown shape (layers built without their input widths) are filled before
the warm step by one forward under ``autograd.pause()`` (the reference's
``_ensure_initialized``), which leaves the statistics as they were; never
inside a capture.

Under ``multi_precision`` the recurrence updates the float32 master
copies (the ``weight_fp32`` states, part of the graph's state) and rounds
them into the low-precision parameters inside the graph, so such a step
captures too (the reference's compiled step takes its eager fallback
there). Semantic fallback (reference :660-670): an optimizer without a
fusable step (SGLD, which draws its noise in ``_apply``) runs the eager
loop
``loss_fn(net(x), y).mean(); backward(); trainer.step(1)`` with a warning
once per (reason, net). A graph holds raw addresses: a call whose
trainables or optimizer states no longer lie where the graph captured them
(a state replaced by ``Trainer.load_states``) captures anew;
``Block.load_dict`` and ``Trainer.load_states`` write in place where they
can, and the graph reads those writes.

Not ported: the mesh, ZeRO-1, FSDP, tensor parallelism, batch padding for
data parallelism and the numerics monitor (a ``mesh`` or ``shard_*``
request raises).
"""
from __future__ import annotations

import torch

from . import amp as _amp
from . import autograd
from . import random as _random
from .base import MXNetError, warn_once
from .cached_op import GraphPool
from .gluon.block import unwrap
from .gluon.trainer import _fused_layout, round_masters, update_targets
from .ndarray.ndarray import NDArray

__all__ = ["CompiledTrainStep"]


class _Program:
    """The step of one input signature: its static buffers, its body and,
    on CUDA, its graph."""

    def __init__(self, step, idxs, x_shape, x_dtype, y_shape, y_dtype, g,
                 k_cap):
        tr = step.trainer
        spec = tr._optimizer.fused_step
        self.step = step
        self.spec = spec
        self.idxs = idxs
        self.g = g
        self.k_cap = k_cap
        self.params = [tr._params[i] for i in idxs]
        # the net's other parameters (BatchNorm's running statistics), which
        # the body writes in place
        held = {id(p) for p in self.params}
        self.aux = [p for p in step.net.parameters() if id(p) not in held]
        self.device = dev = self.params[0].device
        self.states = [tr._states[i] for i in idxs]
        # the tensors the recurrence updates: float32 masters or the params
        self.targets = update_targets(self.params, self.states)
        keys = spec[1]
        buckets = {}
        for k, p in enumerate(self.params):
            buckets.setdefault(p.dtype, []).append(k)
        self.buckets = []
        for pos in buckets.values():
            layout = _fused_layout([self.targets[k] for k in pos],
                                   [self.states[k] for k in pos], keys,
                                   spec[3])
            sel = None if pos == list(range(len(idxs))) else \
                torch.tensor(pos, dtype=torch.int64, device=dev)
            self.buckets.append((layout, pos, sel))
        n = self.n = len(idxs)
        lead = (g,) if g > 1 else ()
        self.x = torch.empty(lead + tuple(x_shape), dtype=x_dtype, device=dev)
        self.y = torch.empty(lead + tuple(y_shape), dtype=y_dtype, device=dev)
        # rows of (lr, wd, t) per trainable, then rescale and loss scale
        self.hyp = torch.zeros(k_cap * 3 * n + 2, dtype=torch.float64,
                               device=dev)
        self.ctr = torch.zeros(2, dtype=torch.int64, device=dev)  # c, j
        self.losses = torch.zeros(k_cap, dtype=torch.float32, device=dev)
        self.flags = torch.zeros(k_cap, dtype=torch.bool, device=dev)
        self.addresses = self._addresses(self.states)
        self.amp_state = _amp._snapshot()
        self.graph = None
        self.captured = None
        self.captured_dtypes = None

    def _addresses(self, states):
        return [(p.data_ptr(), p.dtype) for p in self.params + self.aux] + [
            st[k].data_ptr() for st in states
            for k in (*self.spec[1], "weight_fp32") if k in st]

    def current(self):
        """True while every parameter of the net and trainer, and every
        state, lies where the program (and its graph) found it."""
        tr = self.step.trainer
        states = [tr._states[i] for i in self.idxs]
        if any(st is None or any(k not in st for k in self.spec[1])
               for st in states):
            return False
        return self._addresses(states) == self.addresses

    def load(self, lrs, wds, ts, rescale, loss_scale):
        """Fill the hypers of a call (rows ``[k, n]`` each) with one copy
        and reset the device counters."""
        k, n = len(ts), self.n
        host = torch.zeros(self.hyp.numel(), dtype=torch.float64)
        if k:
            host[:k * 3 * n] = torch.tensor(
                [lrs, wds, ts], dtype=torch.float64).transpose(0, 1) \
                .reshape(-1)
        host[-2] = rescale
        host[-1] = loss_scale
        if self.device.type == "cuda":
            self.hyp.copy_(host.pin_memory(), non_blocking=True)
        else:
            self.hyp.copy_(host)
        self.ctr.zero_()

    # -- the step body: forward, loss, backward, update ---------------------
    def body(self):
        with _amp._scoped(self.amp_state):
            self._body()

    def _body(self):
        step = self.step
        n, g = self.n, self.g
        scaler_on = step.loss_scaler is not None
        table = self.hyp[:self.k_cap * 3 * n].view(self.k_cap, 3, n)
        row = table.index_select(0, self.ctr[:1])[0]
        lrs, wds, ts = row[0].float(), row[1].float(), row[2]
        rescale = self.hyp[-2].float()
        seed = self.hyp[-1].float() if scaler_on else None
        loss = grads = None
        for gi in range(g):
            xb, yb = (self.x[gi], self.y[gi]) if g > 1 else (self.x, self.y)
            with autograd.record():
                li = unwrap(step.loss_fn(step.net(xb), yb)).mean()
            gi_grads = torch.autograd.grad(
                li, self.params,
                grad_outputs=None if seed is None else seed.to(li.dtype),
                allow_unused=True, materialize_grads=True)
            li = li.detach()
            if loss is None:
                loss, grads = li, list(gi_grads)
            else:
                loss = loss + li
                grads = [a + b for a, b in zip(grads, gi_grads)]
        if g > 1:
            # the mean over the G microbatches: sum, then divide
            loss = loss / g
            grads = [gr / g for gr in grads]
        for p in self.params:   # the 'write' hook may have kept one
            if hasattr(p, "_fresh_grad"):
                p._fresh_grad = None
        keys = self.spec[1]
        with torch.no_grad():
            keep = finite = None
            if scaler_on:
                finite = torch.stack([torch.isfinite(gr).all()
                                      for gr in grads]).all()
                keep = ~finite
            for layout, pos, sel in self.buckets:
                hyp = [v if sel is None else v.index_select(0, sel)
                       for v in (lrs, wds, ts)]
                targets = [self.targets[k] for k in pos]
                layout.update(
                    self.spec, targets,
                    [tuple(self.states[k][key] for key in keys)
                     for k in pos],
                    [grads[k] for k in pos], *hyp, rescale, keep)
                round_masters([self.params[k] for k in pos], targets)
            j = self.ctr[1:]
            self.losses.index_copy_(0, j, loss.float().reshape(1))
            if scaler_on:
                self.flags.index_copy_(0, j, keep.reshape(1))
                self.ctr[:1].add_(finite.long().reshape(1))
            else:
                self.ctr[:1].add_(1)
            self.ctr[1:].add_(1)

    def run(self):
        """One step: the body on the CPU; on CUDA a replay of the graph,
        the first time a warm step and the capture."""
        if self.device.type != "cuda":
            self.body()
        elif self.graph is not None:
            GraphPool.replay(self.graph, "compile_step")
        else:
            self._warm_and_capture()

    def _warm_and_capture(self):
        """The real first step of this signature, then its capture
        (``cached_op.GraphPool``), with the dropout generator registered
        when the step draws."""
        _, self.graph, _, self.captured, self.captured_dtypes, _ = \
            self.step._graph_pool(self.device).capture(
                self.body, "compile_step", _random.generator(self.device))


class CompiledTrainStep:
    """Callable ``(x, y) -> loss`` running the whole step as one CUDA
    graph replay (see the module docstring). Built by
    ``Trainer.compile_step(net, loss_fn)``; its semantics are the eager
    loop ``loss_fn(net(x), y).mean(); backward(); trainer.step(1)``, so
    the optimizer's ``rescale_grad`` applies as it is. ``name`` and
    ``strict_batch`` are accepted for the reference's signature: without a
    mesh no batch is padded."""

    def __init__(self, trainer, net, loss_fn, mesh=None, loss_scaler=None,
                 name="train_step", shard_update=None, strict_batch=False,
                 shard_params=None, partition_rules=None):
        asked = [nm for nm, v in (("mesh", mesh),
                                  ("shard_update", shard_update),
                                  ("shard_params", shard_params),
                                  ("partition_rules", partition_rules))
                 if v not in (None, False)]
        if asked:
            raise MXNetError(
                f"compile_step: {', '.join(asked)} not ported: the port's "
                "compiled step runs on one device (the mesh, ZeRO-1, FSDP "
                "and tensor parallelism are not ported yet)")
        self.trainer = trainer
        self.net = net
        self.loss_fn = loss_fn
        self.loss_scaler = loss_scaler if loss_scaler is not None \
            else getattr(trainer, "_amp_loss_scaler", None)
        self.fallback_reason = None
        self._cache = {}        # input signature -> _Program
        self._traces = 0        # captures (programs built)
        self.multi_step = None  # K steps a call (None = off)
        self.accumulate = 1     # microbatches a step
        self.captured_launches = None
        self.captured_dtypes = None
        self._gpool = None      # the steps' capture policy, on first capture
        opt = trainer._optimizer
        if opt.fused_step is None:
            self.fallback_reason = (
                f"{type(opt).__name__} declares no fusable per-tensor step")

    # -- multi-step configuration (reference :770) --------------------------
    def compile_multi_step(self, multi_step, accumulate=1):
        """Take stacked inputs: ``[K, B, ...]`` with ``multi_step=K``,
        ``[G, B, ...]`` with ``accumulate=G``, ``[K, G, B, ...]`` with both.
        Each call runs K optimizer steps (any leading extent; K is
        nominal), each averaging the gradients of G microbatches, and
        returns the K losses. Returns ``self``."""
        if multi_step is not None:
            multi_step = int(multi_step)
            if multi_step < 1:
                raise MXNetError(
                    f"multi_step must be >= 1, got {multi_step}")
        accumulate = int(accumulate)
        if accumulate < 1:
            raise MXNetError(f"accumulate must be >= 1, got {accumulate}")
        if self.fallback_reason is not None:
            raise MXNetError(
                "compile_multi_step: the step cannot compile "
                f"({self.fallback_reason}) and a stacked super-batch has "
                "no eager fallback")
        self.multi_step = multi_step
        self.accumulate = accumulate
        return self

    # -- stepping -----------------------------------------------------------
    def __call__(self, x, y):
        if isinstance(x, NDArray) or isinstance(y, NDArray):
            return NDArray(self(unwrap(x), unwrap(y)))
        if self.multi_step is not None or self.accumulate > 1:
            return self._call_multi(x, y)
        if self.fallback_reason is not None:
            return self._eager_step(x, y)
        self._ensure_initialized(x)
        prog = self._program(x, y, 1, 1)
        if prog is None:
            return self._eager_step(x, y)
        return self._run(prog, x[None], y[None], 1)[0]

    def _call_multi(self, x, y):
        if self.fallback_reason is not None:
            raise MXNetError(
                "multi-step dispatch cannot fall back to the eager loop "
                f"(stacked inputs): {self.fallback_reason}")
        k, x, y = self._split_super(x, y)
        self._ensure_initialized(x[0][0] if self.accumulate > 1 else x[0])
        prog = self._program(x[0], y[0], self.accumulate, k)
        if prog is None:
            raise MXNetError(
                "multi-step dispatch cannot fall back to the eager loop "
                f"(stacked inputs): {self.fallback_reason}")
        return self._run(prog, x, y, k)

    def _split_super(self, x, y):
        """Validate the stacked layout (reference :849); returns
        ``(k, x, y)`` with a leading step axis (accumulate-only inputs gain
        one of length 1)."""
        g = self.accumulate
        lead = 2 if g > 1 else 1
        if self.multi_step is None:
            if x.dim() < 2 or x.shape[0] != g:
                raise MXNetError(
                    f"accumulate={g} expects inputs stacked [G, batch, "
                    f"...]; got x of shape {tuple(x.shape)}")
            x, y = x[None], y[None]
        elif g > 1:
            if x.dim() < 3 or x.shape[1] != g:
                raise MXNetError(
                    f"multi_step with accumulate={g} expects inputs "
                    f"stacked [K, G, batch, ...]; got x of shape "
                    f"{tuple(x.shape)}")
        elif x.dim() < 2:
            raise MXNetError(
                "multi_step expects inputs stacked [K, batch, ...]; got "
                f"x of shape {tuple(x.shape)}")
        if tuple(y.shape[:lead]) != tuple(x.shape[:lead]):
            raise MXNetError(
                f"stacked x/y leading axes disagree: {tuple(x.shape)} vs "
                f"{tuple(y.shape)}")
        return int(x.shape[0]), x, y

    # -- building -----------------------------------------------------------
    def _graph_pool(self, device):
        """The side stream and memory pool every program of this step
        captures from (one graph a signature, replayed one at a time)."""
        if self._gpool is None:
            self._gpool = GraphPool(device)
        return self._gpool

    def _ensure_initialized(self, x):
        """Fill the net's parameters of unknown shape by one forward of the
        microbatch ``x`` under ``autograd.pause()`` (reference
        ``gluon/block.py:222-236``): predict mode, so no statistic moves."""
        params = list(self.net.parameters())
        if not any(getattr(p, "is_deferred", False) for p in params):
            return
        with autograd.pause(), torch.no_grad():
            self.net(x.to(params[0].device))

    def _collect(self):
        """Trainables in trainer order (reference :909): parameters whose
        ``grad_req`` is not ``'null'``. Returns ``(indices, reason)``."""
        tr = self.trainer
        idxs = [i for i in range(len(tr._params)) if tr._trainable(i)]
        if not idxs:
            return None, "no trainable parameters"
        for i in idxs:
            if not tr._params[i].is_floating_point():
                return None, \
                    f"non-float trainable parameter {tr._names[i]}"
        if len({tr._params[i].device for i in idxs}) > 1:
            raise MXNetError("compile_step: the trainables lie on more than "
                             "one device")
        return idxs, None

    def _program(self, x, y, g, k):
        """The program of this input signature, built (captured) when
        missing, when its table has fewer than ``k`` rows, or when a
        trainable or state moved since its capture."""
        lead = 1 if g > 1 else 0
        sig = (g, tuple(x.shape[lead:]), x.dtype, tuple(y.shape[lead:]),
               y.dtype)
        prog = self._cache.get(sig)
        if prog is not None and (prog.k_cap < k or not prog.current()):
            del self._cache[sig]
            prog = None
        if prog is None:
            prog = self._build(sig, k)
            if prog is not None:
                self._cache[sig] = prog
        return prog

    def _build(self, sig, k):
        tr = self.trainer
        opt = tr._optimizer
        idxs, reason = self._collect()
        if reason is not None:
            self.fallback_reason = reason
            return None
        keys = opt.fused_step[1]
        for i in idxs:
            if tr._states[i] is None:
                tr._states[i] = opt.create_state_multi_precision(
                    i, tr._params[i])
            if any(key not in tr._states[i] for key in keys):
                self.fallback_reason = (
                    f"optimizer state for {tr._names[i]} lacks {keys} "
                    "(restored from an older run?)")
                return None
        g, x_shape, x_dtype, y_shape, y_dtype = sig
        self._traces += 1
        return _Program(self, idxs, x_shape, x_dtype, y_shape, y_dtype, g,
                        max(self.multi_step or 1, k))

    # -- running ------------------------------------------------------------
    def _run(self, prog, x, y, k):
        """K steps of ``prog`` over stacked ``x``/``y``; returns the K
        losses as a tensor on the device."""
        opt = self.trainer._optimizer
        idxs = prog.idxs
        scaler = self.loss_scaler
        # counts are staged: a skipped step must leave the schedule where
        # the eager skip would
        rows, nus = opt._staged_counts_k(idxs, k)
        lrs = [[opt._get_lr(i, num_update=nu) for i in idxs] for nu in nus]
        wds = [[opt._get_wd(i) for i in idxs]] * k
        scale = float(scaler.loss_scale) if scaler is not None else 1.0
        prog.load(lrs, wds, rows, self.trainer._scale / scale, scale)
        if x.device != prog.device:
            if prog.device.type == "cuda" and x.device.type == "cpu":
                x, y = x.pin_memory(), y.pin_memory()
            x = x.to(prog.device, non_blocking=True)
            y = y.to(prog.device, non_blocking=True)
        for j in range(k):
            prog.x.copy_(x[j])
            prog.y.copy_(y[j])
            prog.run()
        if prog.captured is not None:
            self.captured_launches = prog.captured
            self.captured_dtypes = prog.captured_dtypes
        losses = prog.losses[:k].clone()
        if scaler is not None:
            # the call's one host sync: K overflow flags
            clean = scaler.replay(prog.flags[:k].tolist())
        else:
            clean = k
        for _ in range(clean):
            opt._commit_counts(idxs)
        return losses

    # -- the uncompiled fallback (reference :2267) ---------------------------
    def _eager_step(self, x, y):
        warn_once(("train_step_fallback", self.fallback_reason,
                   id(self.net)),
                  f"compile_step: falling back to the eager path — "
                  f"{self.fallback_reason}", RuntimeWarning, stacklevel=3)
        tr = self.trainer
        scaler = self.loss_scaler
        dev = next(iter(self.net.parameters())).device
        x, y = x.to(dev), y.to(dev)
        with autograd.record():
            loss = unwrap(self.loss_fn(self.net(x), y)).mean()
            head = loss if scaler is None else loss * float(scaler.loss_scale)
        autograd.backward(head)
        if scaler is not None:
            if scaler.has_overflow(tr._params):
                scaler.update_scale(True)
                return loss.detach()
            with torch.no_grad():
                for i, p in enumerate(tr._params):
                    if tr._trainable(i) and p.grad is not None:
                        p.grad.div_(scaler.loss_scale)
            scaler.update_scale(False)
        tr.step(1)    # the loss carries the batch mean already
        return loss.detach()
