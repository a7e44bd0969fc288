"""CachedOp: a forward, or a Symbol's executor, replayed as one CUDA graph
per input signature.

Counterpart of ``mxnet_tpu/cached_op.py``. The reference traces a forward
through deferred compute into a Symbol and compiles it into one XLA program
per input signature. The port's CachedOp has two bodies:

- a traced forward kept as a Python callable (``trace`` without a
  ``transform``; a hybridized block's programs): its Symbol is made on
  demand (:attr:`CachedOp.sym`, ``lower``, a block's ``export``) by tracing
  the callable through deferred compute
  (:mod:`mxnet_tpu_torch._deferred_compute`) at the inputs of its first
  program;
- a Symbol (``CachedOp(sym, var_nodes, aux_updates=(), name=...)`` as in
  the reference, ``trace(..., transform=pass)``, a block after
  ``optimize_for``): its body is :func:`build_executor`'s walk of the graph
  through each node's ``Op.fn(**attrs)``. Constant tensors move to the
  program's device once, at its first (warm) call, outside any capture.

Either way a *program* is one ``torch.cuda.CUDAGraph`` per input
signature:

- a program owns static buffers for its inputs; a call copies the inputs in,
  replays the graph and returns clones of the graph's outputs, since the
  next replay overwrites the static ones;
- a program is made (:meth:`CachedOp.aot_compile`, or its first call) by
  one warm call of the body, then the capture (:class:`GraphPool`, the
  port's one capture policy, which the decode programs, the compiled step
  and ``parallel.Learner`` use too); the
  programs of one op, or of all the ops of a hybridized block, share a side
  stream and a memory pool, and capture and replay one at a time (one
  lock), which is what makes the shared pool sound;
- parameters are operands, in the reference's call order ``[*inputs,
  *params]``. A program reads the traced parameters where they lie: their
  addresses are part of its signature (a ``cast`` moves them, and the next
  call captures anew), and a call that passes other tensors than the
  traced parameters raises, where the reference would compute with them.
  A ``Predictor`` serves a copy of its block, traced on its own
  (``HybridBlock._serving_graph``);
- when the body draws random numbers (dropout in training mode, seen as a
  change of the device generator's state across the warm call), the
  generator of :mod:`mxnet_tpu_torch.random` is registered with the graph,
  so every replay draws fresh numbers (``_uses_rng``);
- the body runs under the AMP state and the training flag of the call that
  traced it, as the reference's trace fixes both; hybridized blocks called
  inside it (or while any CUDA stream captures, or while a deferred-compute
  trace records) run their bodies inline, so nested blocks capture once, at
  the top (:func:`is_inlined`);
- the kernels' launch counters move at the warm call and the capture only:
  a replay moves none (``graph_stats`` gives each program's captured
  launches and replays);
- an array a body makes from host data on the card (``mx.np.array(-1e30)``)
  is made at the warm call and kept in the family's store
  (``GraphPool.consts``, by value), so the capture copies nothing from the
  host and every replay reads the same value;
- a failed capture or replay raises :class:`MXNetError`; nothing falls back
  to eager execution.

On the CPU (an op whose parameters, or inputs, lie there) each call runs the
body eagerly: that is the tests' path.

Under ``autograd.record()`` a call records **one** tape node, a
``torch.autograd.Function`` whose backward is the vjp of the whole body, as
the reference records the ``jax.vjp`` of its jitted function as one node
(``mxnet_tpu/cached_op.py:10-12``). A recorded signature is a program of
its own (:class:`_Recorded`): on the card, a forward graph captured with
grad mode on (its autograd graph, and the tensors it saves for backward,
live in the pool that the recorded programs share) and a backward graph,
the capture of ``torch.autograd.grad`` through it, reading gradient
buffers and writing the operands' gradients. Those saved tensors are a
step's activations, kept for the program's life, so a block keeps at most
``GraphPool.recorded_limit`` recorded programs and drops the least
recently used. The first call runs the body eagerly on the side
stream (its warm call, the node of that call) and captures the forward;
the first backward runs eagerly (through the node's own graph), then
captures the backward; later calls and backwards replay. Gradients go back
through the node to the inputs and parameters, so torch accumulates them
by each parameter's ``grad_req`` as in the eager tape; inside the node the
body reads aliases of the parameters (``rebind``: the same storage,
gradient accumulators of their own, made on the capture's stream), since an
accumulator the tape made on another stream would synchronise with the
capture and end it. A Symbol's executor takes its parameters as operands,
so it rebinds by passing the aliases; a hybridized block's body swaps them
into its modules. The tensors the
forward saves are the reference's residual operands: a second call before
the first node's backward (a siamese use, or two micro-batches) copies the
first node's saved tensors aside before its replay overwrites them, and
puts them back for that node's backward. A dropout mask is one of them, so
the backward sees the forward's mask. On the CPU the node's forward runs
the body eagerly into a graph of its own and its backward differentiates
that graph. A backward whose outputs reach no operand that takes gradients
(a body that cut its graph) raises :class:`MXNetError`; an operand the
outputs do not reach, beside others they do, gets zeros. An op that cannot
rebind its body (one that :func:`trace`
made from a closure) runs the body eagerly under ``record()``, on the tape
as any other code. ``lower``/``lower_hlo`` give the program's Symbol (its
JSON is the port's text of the lowered program).
"""
from __future__ import annotations

import contextlib
import threading
import weakref

import torch
from torch.autograd.function import once_differentiable

from . import _deferred_compute as _dc
from . import amp as _amp
from . import autograd as _ag
from . import random as _random
from .base import MXNetError, collector_paused
from .ndarray.ndarray import NDArray, host_constants
from .ops import cuda_kernels as _ck
from .symbol.symbol import Literal, Symbol, topo_sort

__all__ = ["CachedOp", "GraphPool", "trace", "unflatten_out", "is_inlined",
           "inlined", "build_executor"]

_local = threading.local()


@contextlib.contextmanager
def inlined():
    """Run hybridized blocks called inside the block inline (their bodies
    eagerly, without a program of their own)."""
    depth = getattr(_local, "depth", 0)
    _local.depth = depth + 1
    try:
        yield
    finally:
        _local.depth = depth


def is_inlined():
    """True inside a CachedOp body on this thread (or an :func:`inlined`
    block), while a deferred-compute trace records on this thread, or while
    the current CUDA stream captures a graph."""
    if getattr(_local, "depth", 0) or _dc._state.ctx is not None:
        return True
    return torch.cuda.is_initialized() and \
        torch.cuda.is_current_stream_capturing()


def _tensor(x):
    return x._data if isinstance(x, NDArray) else x


def build_executor(out_entries, var_nodes):
    """The body of a graph (reference :28-66): ``(fn, uses_rng)``, where
    ``fn(*tensors)`` takes one tensor per variable of ``var_nodes``, in
    order, walks the graph through each node's ``Op.fn(**attrs)`` and
    returns the tuple of the ``out_entries``' tensors. A node of an RNG op
    gets the port's generator of its operands' device (of the first
    variable's where it has none), as ``invoke`` gives it. Constants move
    to the device of the first tensor operand at the first call there
    (then cached). An op whose function does not take the node's
    attributes raises :class:`MXNetError` here, naming both. Inside a
    deferred-compute trace every node is recorded."""
    topo = topo_sort(out_entries)
    var_index = {id(n): i for i, n in enumerate(var_nodes)}
    for n in topo:
        if n.is_var and id(n) not in var_index:
            raise MXNetError(f"graph references unbound variable '{n.name}'")
    fns = {}
    for n in topo:
        if n.op is not None:
            try:
                fns[id(n)] = n.op.fn(**n.attrs)
            except (TypeError, ValueError, MXNetError) as e:
                raise MXNetError(f"op '{n.op.name}' with attributes "
                                 f"{n.attrs}: {e}") from e
    uses_rng = any(n.op is not None and n.op.needs_rng for n in topo)
    placed = {}     # (const node, device) -> its tensor there

    def const(node, device):
        if device is None or node.value.device == device:
            return node.value
        key = (id(node), device)
        t = placed.get(key)
        if t is None:
            t = placed[key] = node.value.to(device)
        return t

    def fn(*args):
        device = next((a.device for a in args
                       if isinstance(a, torch.Tensor)), None)
        tracing = _dc._state.ctx is not None
        env = {}
        for node in topo:
            if node.is_var:
                env[id(node)] = (args[var_index[id(node)]],)
                continue
            if node.is_const:
                env[id(node)] = (const(node, device),)
                continue
            ins = [e.value if isinstance(e, Literal) else env[id(e[0])][e[1]]
                   for e in node.inputs]
            if node.op.needs_rng:
                at = next((t.device for t in ins
                           if isinstance(t, torch.Tensor)), device)
                ins.insert(0, _random.generator(at))
            f = fns[id(node)]
            try:
                out = _dc.call(node.op, node.attrs, f, ins) if tracing \
                    else f(*ins)
            except MXNetError:
                raise
            except Exception as e:  # noqa: BLE001 — name the failing node
                raise MXNetError(f"op '{node.op.name}' ({node.name}) "
                                 f"failed: {e}") from e
            env[id(node)] = tuple(out) if isinstance(out, (tuple, list)) \
                else (out,)
        return tuple(env[id(n)][i] for n, i in out_entries)

    return fn, uses_rng


def _flatten_out(out):
    """A forward's (nested tuple/list) outputs as a flat tensor list and the
    tree that :func:`unflatten_out` rebuilds them from."""
    if isinstance(out, (torch.Tensor, NDArray)):
        return [_tensor(out)], None
    if isinstance(out, (tuple, list)):
        flat, spec = [], []
        for o in out:
            f, s = _flatten_out(o)
            spec.append((len(f), s))
            flat.extend(f)
        return flat, (type(out), spec)
    raise MXNetError(
        f"hybridized forward must return tensors or NDArrays, got "
        f"{type(out)}")


def unflatten_out(flat, tree):
    if tree is None:
        return flat[0]
    typ, spec = tree
    out, i = [], 0
    for n, s in spec:
        if s is None and n == 1:
            out.append(flat[i])
        else:
            out.append(unflatten_out(flat[i:i + n], s))
        i += n
    return typ(out)


class GraphPool:
    """The side stream, the memory pools and the lock that a family of CUDA
    graphs shares on ``device`` (a hybridized block's programs, of every
    signature; a traced CachedOp's; the decode engine's; a compiled step's
    or a ``parallel.Learner``'s), and the port's capture policy:

    - the warm call runs on the family's one side stream, fenced against
      the current stream on both sides (each new stream would hold a cuBLAS
      workspace of its own); kernels are built and tuned tiles looked up
      there, outside the capture;
    - the capture runs on that stream too, with the garbage collector
      paused and with ``capture_error_mode="thread_local"``, so that other
      threads may launch work meanwhile; every graph allocates from the one
      pool, made at the first capture, but the recorded programs' forward
      and backward graphs (:class:`_Recorded`), which share a pool of
      their own (:meth:`pair_pool`). Graphs that share a pool replay one
      at a time (under ``lock``), so each reuses the others' temporaries
      and never a tensor that another keeps;
    - at most ``recorded_limit`` recorded programs live at once
      (:meth:`admit`): each keeps the tensors its forward saved for its
      backward, a training step's activations, so the least recently used
      is dropped for a new one; a dropped program lives on while a tape
      node of one of its calls does (an output of the call, or a loss made
      from one, is still referenced), and its memory then serves the
      pool's next captures;
    - the arrays the bodies make from host data on the card are made at
      the warm call and kept in ``consts`` (by value) for the captures to
      read (``ndarray.host_constants``);
    - a failed capture or replay raises :class:`MXNetError` naming the
      site."""

    recorded_limit = 4

    def __init__(self, device):
        self.device = torch.device(device)
        self.side = None
        self.handle = None
        self.pairs = None       # the recorded programs' pool (pair_pool)
        self.lock = threading.RLock()
        self._recorded = {}     # id -> weak reference, least recent first
        self.evicted = 0        # recorded programs dropped (admit)
        self.consts = {}        # the bodies' host constants on the card

    def _side(self):
        if self.side is None:
            self.side = torch.cuda.Stream(self.device)
        return self.side

    @contextlib.contextmanager
    def on_side(self):
        """Run the block on the side stream, fenced against the current
        stream on both sides."""
        cur = torch.cuda.current_stream(self.device)
        side = self._side()
        side.wait_stream(cur)
        with torch.cuda.stream(side), host_constants(self.consts):
            yield
        cur.wait_stream(side)

    def pair_pool(self):
        """The memory pool of the recorded programs' graph pairs."""
        if self.pairs is None:
            self.pairs = torch.cuda.graph_pool_handle()
        return self.pairs

    def admit(self, prog):
        """Count ``prog`` (a recorded program, new or used again) as the
        most recent, and drop the least recent beyond ``recorded_limit``
        from their ops (``prog.drop()``)."""
        with self.lock:
            self._recorded.pop(id(prog), None)
            self._recorded = {k: r for k, r in self._recorded.items()
                              if r() is not None}
            self._recorded[id(prog)] = weakref.ref(prog)
            while len(self._recorded) > self.recorded_limit:
                victim = self._recorded.pop(next(iter(self._recorded)))()
                if victim is not None:
                    victim.drop()
                    self.evicted += 1

    def record(self, body, site, generators=(), pool=None):
        """Capture ``body()`` into a new graph, without a warm call (the
        caller warmed it), registering ``generators``. Returns ``(graph,
        out, captured_launches, captured_dtypes)``: the graph, its output
        tensors (in the pool) and the kernel launches the capture recorded,
        by kernel and by (kernel, operand dtypes)."""
        if pool is None:
            if self.handle is None:
                self.handle = torch.cuda.graph_pool_handle()
            pool = self.handle
        graph = torch.cuda.CUDAGraph()
        before, before_dt = _ck.launch_counts(), _ck.dtype_counts()
        try:
            for gen in generators:
                graph.register_generator_state(gen)
            with collector_paused(), host_constants(self.consts), \
                    torch.cuda.graph(graph, pool=pool, stream=self._side(),
                                     capture_error_mode="thread_local"):
                out = body()
        except RuntimeError as e:
            raise MXNetError(f"{site}: capturing the program into a CUDA "
                             f"graph failed: {e}") from e
        after, after_dt = _ck.launch_counts(), _ck.dtype_counts()
        dtypes = {k: n - before_dt.get(k, 0) for k, n in after_dt.items()
                  if n != before_dt.get(k, 0)}
        return graph, out, {n: after[n] - before[n] for n in after}, dtypes

    def capture(self, body, site, generator=None, companions=None):
        """Run ``body()`` once on the side stream, then capture it.
        ``generator`` is registered with the graph when the warm call moved
        its state (the body draws random numbers), and with it the
        generators that ``companions(generator)`` returns then (a state the
        body sets the generator to, as remat's recompute does). Returns
        ``(warm_out, graph, out, captured_launches, captured_dtypes,
        uses_rng)``: the warm call's result, then :meth:`record`'s, then
        whether the body draws."""
        state = None if generator is None else generator.get_state()
        with self.on_side():
            warm = body()
        uses_rng = state is not None and \
            not torch.equal(generator.get_state(), state)
        gens = []
        if uses_rng:
            gens = [generator, *(companions(generator) if companions
                                 else ())]
        return (warm, *self.record(body, site, gens), uses_rng)

    @staticmethod
    def replay(graph, site):
        try:
            graph.replay()
        except RuntimeError as e:
            raise MXNetError(f"{site}: replaying the program's CUDA graph "
                             f"failed: {e}") from e

    def bytes(self):
        """Bytes the allocator holds in the family's pools (their segments
        in ``torch.cuda.memory_snapshot()``); 0 before the first capture."""
        pools = {tuple(h) for h in (self.handle, self.pairs)
                 if h is not None}
        if not pools:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) in pools)


class _Program:
    """One input signature of a CachedOp: its static inputs and, on the
    card, its graph."""

    def __init__(self, op, inputs):
        self.op = op
        self.on_card = op.device.type == "cuda"
        self.static = [torch.empty(x.shape, dtype=x.dtype, device=op.device)
                       for x in inputs] if self.on_card else None
        self.graph = None
        self.out = None             # the graph's outputs (in the pool)
        self.captured_launches = None
        self.replays = 0

    def __call__(self, *inputs):
        """The flat outputs of one run, as tensors of their own."""
        op = self.op
        with op._lock:
            if not self.on_card:
                return tuple(op._run_body(inputs))
            with torch.cuda.device(op.device):
                for buf, x in zip(self.static, inputs):
                    buf.copy_(_tensor(x), non_blocking=True)
                if self.graph is None:
                    _, self.graph, self.out, self.captured_launches, _, \
                        rng = op._gpool.capture(
                            lambda: op._run_body(self.static), op._name,
                            _random.generator(op.device))
                    op._uses_rng = op._uses_rng or rng
                    op._captures += 1
                GraphPool.replay(self.graph, op._name)
                self.replays += 1
                return tuple(o.clone() for o in self.out)


def _grad(outs, wrt, gouts, site="cached_op"):
    """The gradients of ``outs`` (seeded with ``gouts``) for ``wrt``,
    zeros where a tensor is not reached; the graph is kept. Raises
    :class:`MXNetError` when no output reaches any tensor of ``wrt`` (a
    body that cut its graph), rather than handing back zeros."""
    grads = torch.autograd.grad(outs, wrt, gouts, retain_graph=True,
                                allow_unused=True) if outs else ()
    if all(g is None for g in grads):
        raise MXNetError(
            f"{site}: no output of the recorded call is connected to an "
            "input or parameter that takes gradients: the body cut its "
            "graph (a detached copy, or work outside autograd.record())")
    return [torch.zeros_like(w) if g is None else g
            for g, w in zip(grads, wrt)]


def _forget_fresh(params):
    """Drop what the parameters' ``'write'`` hooks kept while a gradient
    was taken for them inside a step or a node (which hands its gradients
    on to torch, which runs the hooks again for them); nothing for
    aliases, which carry no hooks."""
    for p in params:
        if getattr(p, "_fresh_grad", None) is not None:
            p._fresh_grad = None


def _alias(p, grad):
    """A parameter over ``p``'s storage (so layers read it as they read
    ``p``, and its ``data()`` wraps it), taking gradients when ``grad``. It
    carries ``p``'s attributes but none of its hooks: its gradients are
    taken with ``torch.autograd.grad``, never accumulated, so the
    ``'write'`` hooks have nothing to do, and registering them costs host
    time on every recorded call."""
    if not isinstance(p, torch.nn.Parameter):
        return p.detach().requires_grad_(grad)
    alias = torch.Tensor._make_subclass(type(p), p.detach(), grad)
    alias.__dict__.update(p.__dict__)
    return alias


class _Node:
    """One recorded call: its outputs, and where its backward finds what
    the forward saved (its own eager graph, the program's residual buffers,
    or a stash of them)."""

    __slots__ = ("eager", "stash", "pending", "__weakref__")

    def __init__(self, eager=None):
        self.eager = eager      # (outputs, leaves) of an eager forward
        self.stash = None       # the residuals, set aside
        self.pending = True     # its backward has not run


class _Recorded:
    """The recorded program of one signature: a call under
    ``autograd.record()`` as one tape node (see the module docstring).
    ``need`` says which operands (inputs, then parameters) take
    gradients."""

    def __init__(self, op, key, inputs, need):
        self.op = op
        self.key = key
        self.on_card = op.device.type == "cuda"
        self.n_in = len(inputs)
        self.need = need
        # the leaves the node differentiates for the parameters: aliases
        # (their storage, gradient accumulators of their own, no hooks)
        # where the op can rebind its body to them, else the parameters
        need_p = need[self.n_in:]
        self.params = op._params if op._rebind is None else [
            _alias(p, n) for p, n in zip(op._params, need_p)]
        self.static = None      # the forward graph's inputs
        self.fwd = self.bwd = None
        self.outs = None        # the forward graph's outputs (in the pool)
        self.gouts = None       # the backward graph's gradient inputs
        self.grads = None       # its gradient outputs (in the pool)
        self.views = None       # byte views of the saved tensors' storages
        self.owner = None       # the node whose residuals lie in place
        self.captured_launches = self.backward_launches = None
        self.replays = self.backward_replays = 0

    def drop(self):
        """Leave the op's programs (``GraphPool.admit``); the memory goes
        back to the pool once no tape node holds the program."""
        self.op._recorded.pop(self.key, None)

    def _wrt(self, leaves):
        return [x for x, n in zip(leaves, self.need) if n] + \
            [p for p, n in zip(self.params, self.need[self.n_in:]) if n]

    # -- forward ----------------------------------------------------------
    def forward(self, inputs):
        """The outputs of one call and its node."""
        op = self.op
        with op._lock:
            if self.fwd is None:
                return self._eager(inputs)
            with torch.cuda.device(op.device):
                self._evict()
                for buf, x in zip(self.static, inputs):
                    buf.copy_(x, non_blocking=True)
                GraphPool.replay(self.fwd, op._name)
                self.replays += 1
                node = _Node()
                self.owner = weakref.ref(node)
                return [o.detach().clone() for o in self.outs], node

    def _body(self, leaves):
        op = self.op
        rebound = contextlib.nullcontext() if op._rebind is None else \
            op._rebind(self.params)
        with torch.enable_grad(), rebound:
            return op._run_body(leaves)

    def _eager(self, inputs):
        """The body eagerly into a graph of the node's own (on the card:
        the warm call, on the side stream, then the forward's capture)."""
        op = self.op
        leaves = [x.detach().requires_grad_(n)
                  for x, n in zip(inputs, self.need)]
        if not self.on_card:
            outs = self._body(leaves)
        else:
            gen = _random.generator(op.device)
            state = gen.get_state()
            with torch.cuda.device(op.device):
                with op._gpool.on_side():
                    outs = self._body(leaves)
                rng = not torch.equal(gen.get_state(), state)
                op._uses_rng = op._uses_rng or rng
                self._capture_forward(inputs, [gen] if rng else [])
        return [o.detach() for o in outs], _Node((outs, leaves))

    def _capture_forward(self, inputs, generators):
        op = self.op
        self.static = [torch.empty(x.shape, dtype=x.dtype, device=op.device)
                       .requires_grad_(n)
                       for x, n in zip(inputs, self.need)]
        with torch.no_grad():
            for buf, x in zip(self.static, inputs):
                buf.copy_(x)
        saved = []

        def pack(t):
            saved.append(t)
            return t

        def body():
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                return self._body(self.static)

        self.fwd, self.outs, self.captured_launches, _ = op._gpool.record(
            body, op._name, generators, op._gpool.pair_pool())
        # the residuals: every saved tensor's storage on the card but the
        # parameters' (a replay writes neither those nor a host scalar that
        # an op saved)
        held = {p.untyped_storage().data_ptr() for p in op._params}
        stores = {}
        for t in saved:
            st = t.untyped_storage()
            if st.nbytes() and st.device == op.device and \
                    st.data_ptr() not in held:
                stores.setdefault(st.data_ptr(), st)
        self.views = [torch.empty(0, dtype=torch.uint8, device=op.device)
                      .set_(st) for st in stores.values()]
        op._captures += 1

    # -- residuals ----------------------------------------------------------
    def _evict(self):
        """Set the residuals of the node that owns them aside while its
        backward is pending: the next replay overwrites them."""
        node = self.owner() if self.owner is not None else None
        if node is not None and node.pending and node.stash is None:
            node.stash = [v.clone() for v in self.views]
        self.owner = None

    def _restore(self, node):
        if self.owner is not None and self.owner() is node:
            return
        if node.stash is None:
            raise MXNetError(
                f"{self.op._name}: the tensors this node saved for backward "
                "were overwritten by a later call of the block: a second "
                "backward through a captured node (retain_graph) must come "
                "before the block's next call under record()")
        self._evict()
        for v, st in zip(self.views, node.stash):
            v.copy_(st, non_blocking=True)
        node.stash = None
        self.owner = weakref.ref(node)

    # -- backward -----------------------------------------------------------
    def backward(self, node, gouts):
        """The gradients of the operands that take them, for the output
        gradients ``gouts``; None for the others."""
        op = self.op
        with op._lock, (torch.cuda.device(op.device) if self.on_card
                        else contextlib.nullcontext()):
            if node.eager is not None:
                outs, leaves = node.eager
                grads = self._eager_grad(outs, self._wrt(leaves), gouts)
            else:
                self._restore(node)
                if self.bwd is None:
                    grads = self._eager_grad(self.outs,
                                             self._wrt(self.static), gouts)
                else:
                    for buf, g, o in zip(self.gouts, gouts, self.outs):
                        if o.requires_grad:
                            buf.copy_(g, non_blocking=True)
                    GraphPool.replay(self.bwd, op._name + " backward")
                    self.backward_replays += 1
                    grads = [g.clone() for g in self.grads]
            node.pending = False
            if self.on_card and self.bwd is None:
                self._capture_backward()
        it = iter(grads)
        return [next(it) if n else None for n in self.need]

    def _eager_grad(self, outs, wrt, gouts):
        pairs = [(o, g) for o, g in zip(outs, gouts) if o.requires_grad]
        if not self.on_card:
            grads = _grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                          self.op._name)
        else:
            with self.op._gpool.on_side():
                grads = _grad([o for o, _ in pairs], wrt,
                              [g for _, g in pairs], self.op._name)
            grads = [g.clone() for g in grads]
        _forget_fresh(self.params)
        return grads

    def _capture_backward(self):
        op = self.op
        diff = [o for o in self.outs if o.requires_grad]
        self.gouts = [torch.empty_like(o) if o.requires_grad else None
                      for o in self.outs]
        wrt = self._wrt(self.static)
        self.bwd, self.grads, self.backward_launches, _ = op._gpool.record(
            lambda: _grad(diff, wrt, [g for g in self.gouts
                                      if g is not None]),
            op._name + " backward", (), op._gpool.pair_pool())
        _forget_fresh(self.params)
        op._backward_captures += 1


class _Tape(torch.autograd.Function):
    """The tape node of a recorded call: its forward replays (or runs) the
    program, its backward the program's backward."""

    @staticmethod
    def forward(ctx, prog, *operands):
        outs, node = prog.forward(operands[:prog.n_in])
        ctx.prog, ctx.node = prog, node
        ctx.mark_non_differentiable(
            *[o for o in outs if not o.is_floating_point()])
        return tuple(outs)

    @staticmethod
    @once_differentiable
    def backward(ctx, *gouts):
        return (None, *ctx.prog.backward(ctx.node, gouts))


class CachedOp:
    """A forward kept as programs, one per input signature (see the module
    docstring). Built by :func:`trace`, or from a Symbol.

    ``fn(*inputs)`` is the forward; ``params`` the ``(name, tensor)``
    pairs it reads, which every call passes after the inputs; ``nd_inputs``
    which inputs ``fn`` takes as NDArrays. The op runs where its parameters
    lie (its inputs, without parameters), under the AMP state and training
    flag current at construction.

    From a Symbol, as the reference: ``CachedOp(sym, var_nodes,
    aux_updates=(), name=...)``; ``var_nodes`` are the graph's variables in
    call order, the last ``len(params)`` of them bound to ``params`` (then
    passed by keyword); ``aux_updates`` ``(target tensor, entry)`` pairs
    whose entries are extra outputs written into the targets after every
    call (BatchNorm's running statistics). Without parameters the op runs
    on the device of its first call's inputs.

    ``rebind(tensors)``: a context in which ``fn`` reads ``tensors`` in
    place of the parameters (a hybridized block's, swapped in its modules).
    A recorded program differentiates such aliases; an op without
    ``rebind`` runs its body eagerly under ``record()``, on the tape as any
    other code (a Symbol's op always rebinds). ``gpool``: the
    :class:`GraphPool` of the op's programs (a hybridized block gives all
    its ops one), else a pool of its own."""

    def __init__(self, fn, nd_inputs, params=(), name="cached_op",
                 device=None, rebind=None, gpool=None, aux_updates=()):
        self._sym = self._exec = None
        self._aux_targets = []
        params = list(params)
        if isinstance(fn, Symbol):
            if params and not isinstance(params[0][0], str):
                # the reference's positional form: (sym, var_nodes, aux)
                aux_updates, params = params, []
            var_nodes = list(nd_inputs)
            self._sym = fn
            self._var_nodes = var_nodes
            self._aux_targets = [t for t, _ in aux_updates]
            self._n_sym = len(fn._entries)
            self._exec, self._uses_rng = build_executor(
                list(fn._entries) + [e for _, e in aux_updates], var_nodes)
            nd_inputs = [False] * (len(var_nodes) - len(params))
            fn, rebind = None, self._rebind_params
        self._fn = fn
        self._rebind = rebind
        self._nd_in = [bool(b) for b in nd_inputs]
        self._param_names = [n for n, _ in params]
        self._params = [_tensor(p) for _, p in params]
        self._bound = None          # aliases in the parameters' place
        self._name = name
        if device is not None:
            device = torch.device(device)
        elif self._params:
            device = self._params[0].device
        elif self._exec is None:
            device = torch.device("cpu")
        self.device = device        # None: the first call's
        self._amp_state = _amp._snapshot()
        self._training = _ag.is_training()
        self._n_main = None         # flat outputs, known after a first run
        self._tree = None           # their structure (unflatten_out)
        if self._exec is None:
            self._uses_rng = False
        else:
            self._n_main = self._n_sym
            if self._n_sym > 1:
                self._tree = (tuple, [(1, None)] * self._n_sym)
        self._examples = None       # the first call's inputs (sym, export)
        self._programs = {}         # signature -> _Program
        self._recorded = {}         # signature -> _Recorded
        self._captures = 0          # programs made ready (graphs captured)
        self._backward_captures = 0     # backward graphs captured
        self._gpool = gpool if gpool is not None or device is None \
            else GraphPool(device)
        self._lock = self._gpool.lock if self._gpool is not None \
            else threading.RLock()

    @property
    def num_inputs(self):
        return len(self._nd_in) + len(self._params)

    @contextlib.contextmanager
    def _rebind_params(self, tensors):
        """A Symbol's body reads ``tensors`` in place of its parameters."""
        prev, self._bound = self._bound, list(tensors)
        try:
            yield
        finally:
            self._bound = prev

    def _run_body(self, inputs):
        """The forward on ``inputs``: its flat outputs."""
        grad = contextlib.nullcontext() if _ag.is_recording() \
            else torch.no_grad()
        if self._exec is not None:
            params = self._params if self._bound is None else self._bound
            with inlined(), grad:
                outs = self._exec(*[_tensor(x) for x in inputs], *params)
            if self._aux_targets:
                with torch.no_grad():
                    for t, o in zip(self._aux_targets, outs[self._n_sym:]):
                        t.copy_(o)
            return list(outs[:self._n_sym])
        args = [NDArray(_tensor(x)) if nd else _tensor(x)
                for x, nd in zip(inputs, self._nd_in)]
        with inlined(), grad, _amp._scoped(self._amp_state), \
                _ag._scope(training=self._training):
            flat, self._tree = _flatten_out(self._fn(*args))
        self._n_main = len(flat)
        return flat

    @property
    def sym(self):
        """The op's Symbol: a Symbol op's own; a traced forward's, traced
        through deferred compute at the inputs of the op's first call."""
        if self._sym is None:
            if self._examples is None:
                raise MXNetError(f"{self._name}: call the op once before "
                                 "asking for its Symbol")
            self._sym = self.symbolize(self._examples)[0]
        return self._sym

    def symbolize(self, inputs):
        """Trace the body at ``inputs`` (the data operands) through deferred
        compute: ``(sym, var_nodes, aux_updates, flat_outputs)``; the
        variables are ``data0, data1, ...`` then the parameters by name."""
        tensors = [_tensor(x) for x in inputs]
        with self._lock, _ag.pause(train_mode=self._training), \
                _dc.context() as ctx:
            var_nodes = [_dc.set_variable(t, f"data{i}")
                         for i, t in enumerate(tensors)]
            var_nodes += [_dc.set_variable(p, n) for n, p in
                          zip(self._param_names, self._params)]
            flat = self._run_body(tensors)
            entries = []
            for o in flat:
                e = ctx.entries.get(id(o))
                if e is None:
                    # an output unconnected to the inputs: bake it
                    e = _dc._input_entry(ctx, o)
                entries.append(e)
        return Symbol(entries), var_nodes, ctx.aux_updates, flat

    def _split(self, datas):
        """The data operands of ``datas``; its parameters must be the
        traced ones, where they lie now."""
        if len(datas) != self.num_inputs:
            raise MXNetError(f"CachedOp expects {self.num_inputs} inputs, "
                             f"got {len(datas)}")
        n = len(self._nd_in)
        if self.device is None:
            first = next((_tensor(x) for x in datas
                          if isinstance(_tensor(x), torch.Tensor)), None)
            self.device = first.device if first is not None \
                else torch.device("cpu")
            self._gpool = GraphPool(self.device)
            self._gpool.lock = self._lock
        for i, (p, d) in enumerate(zip(self._params, datas[n:])):
            d = _tensor(d)
            if d is not p and (d.data_ptr() != p.data_ptr() or
                               d.dtype != p.dtype or d.shape != p.shape):
                raise MXNetError(
                    f"{self._name}: parameter operand {i} is not the traced "
                    "parameter: a CachedOp reads its parameters where they "
                    "lie; trace again to serve other weights")
        return [_tensor(x) for x in datas[:n]]

    def _program(self, inputs):
        """The program of these inputs' shapes and dtypes and the
        parameters' current addresses, made (not yet captured) when
        missing."""
        key = (tuple((tuple(x.shape), x.dtype) for x in inputs),
               tuple((p.data_ptr(), p.dtype) for p in self._params))
        with self._lock:
            prog = self._programs.get(key)
            if prog is None:
                prog = self._programs[key] = _Program(self, inputs)
                if not prog.on_card:
                    self._captures += 1
        return prog

    def _record(self, inputs):
        """A call under ``record()``: one tape node (:class:`_Tape`) over
        the recorded program of these inputs' signature and of which
        operands take gradients; the forward alone when none does; the
        body eagerly, on the tape, without ``rebind``."""
        need = tuple(isinstance(t, torch.Tensor) and t.requires_grad and
                     t.is_floating_point()
                     for t in list(inputs) + self._params)
        if not any(need):
            return self._program(inputs)(*inputs)
        if self._rebind is None:
            with self._lock:
                return self._run_body(inputs)
        key = (tuple((tuple(x.shape), x.dtype) for x in inputs),
               tuple((p.data_ptr(), p.dtype) for p in self._params), need)
        with self._lock:
            prog = self._recorded.get(key)
            if prog is None:
                prog = self._recorded[key] = _Recorded(self, key, inputs,
                                                       need)
                if not prog.on_card:
                    self._captures += 1
            self._gpool.admit(prog)
        return _Tape.apply(prog, *inputs, *self._params)

    def __call__(self, *datas):
        """The outputs for ``[*inputs, *params]``: one tensor, or a tuple of
        the flat outputs; NDArrays when any operand is one."""
        nd = any(isinstance(x, NDArray) for x in datas)
        inputs = self._split(datas)
        if self._examples is None:
            self._examples = [x.detach() for x in inputs]
        if is_inlined():
            with self._lock:
                flat = self._run_body(inputs)
        elif _ag.is_recording():
            flat = self._record(inputs)
        else:
            flat = self._program(inputs)(*inputs)
        if nd:
            flat = [NDArray(t) for t in flat]
        return flat[0] if self._n_main == 1 else tuple(flat)

    def aot_compile(self, *example_inputs):
        """Make the program of the examples' signature ahead of time (on
        the card: the warm call, the capture and one replay) and return it:
        a callable taking the inputs alone (its parameters are bound) and
        returning the flat outputs as a tuple. It serves only inputs of
        that signature; pad to it before calling."""
        inputs = self._split(example_inputs)
        prog = self._program(inputs)
        if prog.on_card and prog.graph is None:
            prog(*inputs)
        return prog

    def lower(self, *example_inputs, donate=()):
        """The program at the examples' signature, lowered (the reference's
        ``jax`` Lowered): ``as_text()`` is its Symbol's JSON, ``compile()``
        is :meth:`aot_compile`'s program. The examples are the data
        operands, with or without the parameters after them. ``donate`` is
        accepted: a CUDA graph's inputs are static buffers of its own."""
        inputs = self._split(example_inputs) \
            if len(example_inputs) == self.num_inputs else \
            [_tensor(x) for x in example_inputs]
        sym = self._sym if self._exec is not None else \
            self.symbolize(inputs)[0]
        return _Lowered(self, sym, inputs)

    def lower_hlo(self, *example_inputs):
        """The lowered program's text: its Symbol JSON."""
        return self.lower(*example_inputs).as_text()

    def pool_bytes(self):
        """Bytes the allocator holds in the op's graph pools (a hybridized
        block's: those of all its ops); 0 before the first capture."""
        return self._gpool.bytes()

    def graph_stats(self):
        """Per program, in the order made (the forward programs, then the
        recorded ones): the kernel launches its capture recorded (None off
        the card) and its replays; a recorded program adds its backward
        graph's."""
        stats = [{"captured_launches": p.captured_launches,
                  "replays": p.replays} for p in self._programs.values()]
        return stats + [
            {"captured_launches": p.captured_launches, "replays": p.replays,
             "recorded": True,
             "backward_captured_launches": p.backward_launches,
             "backward_replays": p.backward_replays}
            for p in self._recorded.values()]


class _Lowered:
    """A CachedOp's program at one signature, lowered: its Symbol."""

    def __init__(self, op, sym, inputs):
        self.op, self.sym, self._inputs = op, sym, inputs

    def as_text(self):
        return self.sym.tojson()

    def compile(self):
        return self.op.aot_compile(*self._inputs, *self.op._params)


def trace(fn, inputs, params=(), transform=None, rebind=None, gpool=None):
    """Trace ``fn(*inputs)`` into ``(out_tree, flat_outputs, CachedOp)``.

    ``inputs``: tensors or NDArrays, the data operands in order; ``params``:
    ``(name, tensor)`` pairs that ``fn`` reads, passed after the inputs on
    every call. ``fn`` runs once here, eagerly (filling deferred shapes);
    its flat outputs are returned (NDArrays when an input is one).
    ``transform`` (a Symbol -> Symbol pass, the ``optimize_for`` hook):
    ``fn`` is traced through deferred compute, the pass rewrites the
    Symbol, and the op's body is the rewritten graph's executor (the
    returned outputs are the trace's, from before the pass). ``rebind``
    and ``gpool`` are :class:`CachedOp`'s."""
    nd_in = [isinstance(x, NDArray) for x in inputs]
    tensors = [_tensor(x) for x in inputs]
    params = list(params)
    device = None if params else (tensors[0].device if tensors else None)
    op = CachedOp(fn, nd_in, params, device=device, rebind=rebind,
                  gpool=gpool)
    gen = _random.generator(op.device)
    state = gen.get_state()
    if transform is None:
        with op._lock:
            flat = op._run_body(tensors)
    else:
        sym, var_nodes, aux, flat = op.symbolize(tensors)
        tree = op._tree
        op = CachedOp(transform(sym), var_nodes, params=params,
                      device=op.device, gpool=gpool, aux_updates=aux)
        op._tree = tree
    op._examples = [t.detach() for t in tensors]
    op._uses_rng = op._uses_rng or not torch.equal(gen.get_state(), state)
    if any(nd_in):
        flat = [NDArray(t) for t in flat]
    return op._tree, flat, op
