"""CachedOp: a traced forward replayed as one CUDA graph per input signature.

Counterpart of ``mxnet_tpu/cached_op.py``. The reference traces a forward
through deferred compute into a Symbol and compiles it into one XLA program
per input signature. The port has no graph layer yet (Symbol and deferred
compute are ROADMAP A10), so its CachedOp keeps the forward as a Python
callable, and a *program* is one ``torch.cuda.CUDAGraph`` per input
signature:

- a program owns static buffers for its inputs; a call copies the inputs in,
  replays the graph and returns clones of the graph's outputs, since the
  next replay overwrites the static ones;
- a program is made (:meth:`CachedOp.aot_compile`, or its first call) by
  one warm call of the body, then the capture (:class:`GraphPool`, the
  port's one capture policy, which the decode programs use too); the
  programs of one op share its side stream and its memory pool, and
  capture and replay one at a time (one lock), which is what makes the
  shared pool sound;
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
  inside it (or while any CUDA stream captures) run their bodies inline, so
  nested blocks capture once, at the top (:func:`is_inlined`);
- the kernels' launch counters move at the warm call and the capture only:
  a replay moves none (``graph_stats`` gives each program's captured
  launches and replays);
- a failed capture or replay raises :class:`MXNetError`; nothing falls back
  to eager execution.

On the CPU (an op whose parameters, or inputs, lie there) each call runs the
body eagerly: that is the tests' path. Under ``autograd.record()`` a call
runs the body eagerly through the tape on every device; the reference's one
tape node for a CachedOp (its backward as one program) is ROADMAP A5.
``lower``/``lower_hlo`` and a ``transform`` pass need the graph layer and
raise.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from . import amp as _amp
from . import autograd as _ag
from . import random as _random
from .base import MXNetError, collector_paused
from .ndarray.ndarray import NDArray
from .ops import cuda_kernels as _ck

__all__ = ["CachedOp", "GraphPool", "trace", "unflatten_out", "is_inlined",
           "inlined"]

_GRAPH_LAYER = ("needs the graph layer (Symbol, deferred compute), which "
                "comes with ROADMAP A10 of the PyTorch/CUDA port")

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
    block), or while the current CUDA stream captures a graph."""
    if getattr(_local, "depth", 0):
        return True
    return torch.cuda.is_initialized() and \
        torch.cuda.is_current_stream_capturing()


def _tensor(x):
    return x._data if isinstance(x, NDArray) else x


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
    """The side stream and the memory pool that a family of CUDA graphs
    shares on ``device``, and the port's capture policy (a CachedOp's
    programs and the decode engine's use it):

    - the warm call runs on the family's one side stream, fenced against
      the current stream on both sides (each new stream would hold a cuBLAS
      workspace of its own); kernels are built and tuned tiles looked up
      there, outside the capture;
    - the capture runs with the garbage collector paused and with
      ``capture_error_mode="thread_local"``, so that other threads may
      launch work meanwhile; every graph allocates from the one pool, made
      at the first capture;
    - a failed capture or replay raises :class:`MXNetError` naming the
      site."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.side = None
        self.handle = None

    def capture(self, body, site, generator=None):
        """Run ``body()`` once on the side stream, then capture it.
        ``generator`` is registered with the graph when the warm call moved
        its state (the body draws random numbers). Returns ``(warm_out,
        graph, out, captured_launches, uses_rng)``: the warm call's result,
        the graph, its output tensors (in the pool) and the kernel launches
        the capture recorded."""
        dev = self.device
        cur = torch.cuda.current_stream(dev)
        if self.side is None:
            self.side = torch.cuda.Stream(dev)
        state = None if generator is None else generator.get_state()
        self.side.wait_stream(cur)
        with torch.cuda.stream(self.side):
            warm = body()
        cur.wait_stream(self.side)
        uses_rng = state is not None and \
            not torch.equal(generator.get_state(), state)
        if self.handle is None:
            self.handle = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = _ck.launch_counts()
        try:
            if uses_rng:
                graph.register_generator_state(generator)
            with collector_paused(), torch.cuda.graph(
                    graph, pool=self.handle,
                    capture_error_mode="thread_local"):
                out = body()
        except RuntimeError as e:
            raise MXNetError(f"{site}: capturing the program into a CUDA "
                             f"graph failed: {e}") from e
        after = _ck.launch_counts()
        return (warm, graph, out, {n: after[n] - before[n] for n in after},
                uses_rng)

    @staticmethod
    def replay(graph, site):
        try:
            graph.replay()
        except RuntimeError as e:
            raise MXNetError(f"{site}: replaying the program's CUDA graph "
                             f"failed: {e}") from e

    def bytes(self):
        """Bytes the allocator holds in the pool (its segments in
        ``torch.cuda.memory_snapshot()``); 0 before the first capture."""
        if self.handle is None:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) ==
                   tuple(self.handle))


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
                    _, self.graph, self.out, self.captured_launches, rng = \
                        op._gpool.capture(
                            lambda: op._run_body(self.static), op._name,
                            _random.generator(op.device))
                    op._uses_rng = op._uses_rng or rng
                    op._captures += 1
                GraphPool.replay(self.graph, op._name)
                self.replays += 1
                return tuple(o.clone() for o in self.out)


class CachedOp:
    """A forward kept as programs, one per input signature (see the module
    docstring). Built by :func:`trace`.

    ``fn(*inputs)`` is the forward; ``params`` the ``(name, tensor)``
    pairs it reads, which every call passes after the inputs; ``nd_inputs``
    which inputs ``fn`` takes as NDArrays. The op runs where its parameters
    lie (its inputs, without parameters), under the AMP state and training
    flag current at construction."""

    def __init__(self, fn, nd_inputs, params=(), name="cached_op",
                 device=None):
        self._fn = fn
        self._nd_in = [bool(b) for b in nd_inputs]
        self._params = [_tensor(p) for _, p in params]
        self._name = name
        self.device = torch.device(device) if device is not None else (
            self._params[0].device if self._params else torch.device("cpu"))
        self._amp_state = _amp._snapshot()
        self._training = _ag.is_training()
        self._n_main = None         # flat outputs, known after a first run
        self._tree = None           # their structure (unflatten_out)
        self._uses_rng = False
        self._programs = {}         # signature -> _Program
        self._captures = 0          # programs made ready (graphs captured)
        self._lock = threading.RLock()
        self._gpool = GraphPool(self.device)

    @property
    def num_inputs(self):
        return len(self._nd_in) + len(self._params)

    def _run_body(self, inputs):
        """The forward on ``inputs``: its flat outputs."""
        args = [NDArray(_tensor(x)) if nd else _tensor(x)
                for x, nd in zip(inputs, self._nd_in)]
        grad = contextlib.nullcontext() if _ag.is_recording() \
            else torch.no_grad()
        with inlined(), grad, _amp._scoped(self._amp_state), \
                _ag._scope(training=self._training):
            flat, self._tree = _flatten_out(self._fn(*args))
        self._n_main = len(flat)
        return flat

    def _split(self, datas):
        """The data operands of ``datas``; its parameters must be the
        traced ones, where they lie now."""
        if len(datas) != self.num_inputs:
            raise MXNetError(f"CachedOp expects {self.num_inputs} inputs, "
                             f"got {len(datas)}")
        n = len(self._nd_in)
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

    def __call__(self, *datas):
        """The outputs for ``[*inputs, *params]``: one tensor, or a tuple of
        the flat outputs; NDArrays when any operand is one."""
        nd = any(isinstance(x, NDArray) for x in datas)
        inputs = self._split(datas)
        if _ag.is_recording() or is_inlined():
            with self._lock:
                flat = self._run_body(inputs)
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
        raise MXNetError(f"CachedOp.lower {_GRAPH_LAYER}")

    def lower_hlo(self, *example_inputs):
        raise MXNetError(f"CachedOp.lower_hlo {_GRAPH_LAYER}")

    def pool_bytes(self):
        """Bytes the allocator holds in the op's graph pool; 0 before the
        first capture."""
        return self._gpool.bytes()

    def graph_stats(self):
        """Per program, in the order made: the kernel launches its capture
        recorded (None off the card) and its replays."""
        return [{"captured_launches": p.captured_launches,
                 "replays": p.replays} for p in self._programs.values()]


def trace(fn, inputs, params=(), transform=None):
    """Trace ``fn(*inputs)`` into ``(out_tree, flat_outputs, CachedOp)``.

    ``inputs``: tensors or NDArrays, the data operands in order; ``params``:
    ``(name, tensor)`` pairs that ``fn`` reads, passed after the inputs on
    every call. ``fn`` runs once here, eagerly (filling deferred shapes);
    its flat outputs are returned (NDArrays when an input is one).
    ``transform`` (a Symbol pass) needs the graph layer and raises."""
    if transform is not None:
        raise MXNetError(f"a trace transform (optimize_for) {_GRAPH_LAYER}")
    nd_in = [isinstance(x, NDArray) for x in inputs]
    tensors = [_tensor(x) for x in inputs]
    params = list(params)
    device = None if params else (tensors[0].device if tensors else None)
    op = CachedOp(fn, nd_in, params, device=device)
    gen = _random.generator(op.device)
    state = gen.get_state()
    with op._lock:
        flat = op._run_body(tensors)
    op._uses_rng = not torch.equal(gen.get_state(), state)
    if any(nd_in):
        flat = [NDArray(t) for t in flat]
    return op._tree, flat, op
