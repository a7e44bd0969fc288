"""gluon.Block / HybridBlock as ``torch.nn.Module``s.

Counterpart of ``mxnet_tpu/gluon/block.py``. A block's parameters are
``torch.nn.Parameter``s registered by attribute, so ``collect_params()``
names them exactly as the reference does (``:52-60``): the attribute path
joined by dots, own parameters before children's, in registration order
(``blocks.0.attn_qkv.weight``, ``ln_f.gamma``, ...).

A plain block runs eagerly. ``hybridize()`` (reference :198-291) turns a
``HybridBlock``'s calls into :mod:`~mxnet_tpu_torch.cached_op` programs,
one CUDA graph per signature: the shapes, dtypes and devices of its
tensors (arguments, keyword arguments, and tensors inside their tuples and
lists, all data operands), the rest of the arguments (static: numbers,
strings, None, and the structure of the containers), the training flags,
the AMP state and every parameter's address and dtype, so that a ``cast``
or a deferred shape's fill (new memory) makes a new program, and the
programs of the old addresses go, while ``load_parameters`` (a copy in
place) is read by the next replay. A call with any other argument runs
eagerly. Under ``autograd.record()`` a hybridized call records one tape
node whose backward is the vjp of its whole forward: on the card two CUDA
graphs a signature, the forward and its backward (see
:mod:`~mxnet_tpu_torch.cached_op`). All the programs of a block share one
``GraphPool`` (a side stream, memory pools, a lock), which keeps at most
``GraphPool.recorded_limit`` recorded signatures and drops the least
recently used. Inside another hybridized block's body
and while a CUDA stream captures, a hybridized block runs eagerly, so
nested blocks capture once, at the top. A block starts in inference mode (``training`` False). Dropout is
active inside ``autograd.record()`` (which sets the training flag, as in the
reference) or after the torch idiom ``block.train()``; elsewhere it is the
identity, so serving never drops units.

A block takes tensors or NDArrays, and its body may mix them. A body
written as the reference's (a user's block, a container, a lambda) receives
its arguments as the caller passed them, NDArrays as NDArrays, so it may
call NDArray methods on them (``valid_length.astype("int32")``); the
port's own layers and models, whose bodies are torch code
(``_tensor_body``), receive NDArray arguments as tensors. Either way the
outputs of a call made with NDArrays come back as NDArrays, and the torch
graph is kept: ``mx.np``/``mx.npx`` wrap tensor operands without a copy,
an NDArray's arithmetic takes tensors, a torch function given an NDArray
runs on its tensor (``NDArray.__torch_function__``), and
``Parameter.data()`` is an NDArray over the parameter itself; so
``loss.backward()`` on an NDArray loss reaches the inputs and parameters.
Outside ``autograd.record()`` (and inside ``pause()``) the door runs the
body with grad mode off, as the reference records nothing there. Under
``record()`` a hybridized call's node raises :class:`MXNetError` at its
backward when none of its outputs is connected to an input or parameter
that takes gradients (a body that cut its graph), rather than handing back
zeros. A hybridized body that makes an array from host data
(``mx.np.array(-1e30)``) is captured too: the array is made at the warm
call and kept with the block's graphs (``ndarray.host_constants``).

The reference's ``Block`` surface (:34-190): ``initialize(init, ctx,
verbose, force_reinit, device)`` (and the port's ``seed``),
``collect_params(select)``, ``zero_grad`` in place, ``reset_ctx``,
``register_child``, forward hooks with the reference's signatures,
``summary``, ``save_parameters``/``load_parameters`` with the reference's
options, ``save``/``load`` by prefix; ``apply`` is torch's, which visits
the children first and returns the block, as the reference's.
"""
from __future__ import annotations

import contextlib
import copy
import math
import re
from collections import OrderedDict

import numpy as onp
import torch

from .. import amp as _amp
from .. import autograd as _ag
from .. import cached_op as _cached_op
from .. import initializer as init_mod
from ..base import MXNetError, dtype_name, to_dtype
from ..convert import _LOW_PRECISION
from ..ndarray.ndarray import NDArray, unwrap, wrap
from .parameter import Parameter

__all__ = ["Block", "HybridBlock", "SymbolBlock", "new_parameter",
           "unwrap", "wrap", "rebound"]


@contextlib.contextmanager
def rebound(block, swap):
    """Inside the block, ``block``'s modules read ``swap[id(p)]`` (a tensor)
    in place of each parameter ``p`` that ``swap`` names; restored after.
    A recorded program and the ``parallel.Learner`` differentiate such
    aliases (the parameters' storage, gradient accumulators of their own,
    made on the capture's stream) and hand the gradients on."""
    saved = []
    for mod in block.modules():
        for name, p in mod._parameters.items():
            if p is not None and id(p) in swap:
                saved.append((mod, name, p))
                mod._parameters[name] = swap[id(p)]
    try:
        yield
    finally:
        for mod, name, p in saved:
            mod._parameters[name] = p


def _has_nd(args, kwargs):
    return any(isinstance(a, NDArray) for a in args) or \
        any(isinstance(v, NDArray) for v in kwargs.values())


def new_parameter(shape, dtype, device, init=None, grad_req="write"):
    """A layer's :class:`~mxnet_tpu_torch.gluon.parameter.Parameter` of
    ``shape`` on ``device``: zeros, not initialized, until ``initialize``,
    a load or a write fills it (a 0 in ``shape`` defers it); ``init`` is its
    own initializer (the block's default applies when None)."""
    p = Parameter(torch.zeros(shape, dtype=dtype, device=device),
                  grad_req=grad_req, init=init_mod.create(init))
    p._initialized = False
    p._v0 = p._version
    return p


def _ignore_result(hook):
    """``hook`` as a torch hook whose return value is dropped (the
    reference's hooks observe; torch's may replace args or outputs)."""
    def run(*args):
        hook(*args)

    return run


class Block(torch.nn.Module):
    """Base container (reference: gluon/block.py:34)."""

    # the port's own blocks, whose bodies are torch code, set this: their
    # NDArray arguments reach the body as tensors
    _tensor_body = False

    def __init__(self, prefix=None, params=None):
        # prefix and params: accepted and ignored, as the reference's
        super().__init__()
        self.train(False)

    def __call__(self, *args, **kwargs):
        if not _has_nd(args, kwargs):
            return super().__call__(*args, **kwargs)
        if self._tensor_body:
            args, kwargs = unwrap(args), {k: unwrap(v)
                                          for k, v in kwargs.items()}
        with torch.set_grad_enabled(_ag.is_recording()):
            return wrap(super().__call__(*args, **kwargs))

    def collect_params(self, select=None):
        """``OrderedDict`` of name -> parameter; with ``select``, those
        whose name the regular expression matches at its start
        (``re.match``, reference :62)."""
        params = OrderedDict(self.named_parameters())
        for name, p in params.items():
            if isinstance(p, Parameter):
                p._name = name
        if select is None:
            return params
        pat = re.compile(select)
        return OrderedDict((n, p) for n, p in params.items()
                           if pat.match(n))

    @property
    def device(self):
        for p in self.parameters():
            return p.device
        raise MXNetError(f"{type(self).__name__} holds no parameters")

    @torch.no_grad()
    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, device=None, seed=None):
        """Fill every parameter from its own initializer, else ``init``
        (default ``Uniform(0.07)``), by the reference's fill by name
        (``Initializer.init_array``), drawing from a CPU ``torch.Generator``
        seeded with ``seed`` — so a seed gives the same weights on every
        device (reference :70). A parameter already initialized is left as
        it is unless ``force_reinit``. ``ctx``/``device`` moves every
        parameter there in place (the same objects, so a ``Trainer`` built
        before holds them). A parameter of unknown shape records its
        initializer, the generator and its name, and is drawn at its first
        forward. ``verbose`` is accepted, as in the reference."""
        default = init_mod.create(init) or init_mod.Uniform(0.07)
        gen = torch.Generator()
        if seed is None:
            gen.seed()
        else:
            gen.manual_seed(int(seed))
        where = ctx if device is None else device
        for name, p in self.collect_params().items():
            if isinstance(p, Parameter):
                p._initialize(None, where, default, force_reinit, gen, name)
                continue
            host = torch.empty(p.shape, dtype=torch.float32)
            (getattr(p, "mx_init", None) or default).init_array(
                name, host, gen)
            p.copy_(host)

    def zero_grad(self):
        """Zero every parameter's gradient in place (reference :92);
        torch's ``Module.zero_grad`` would drop them instead."""
        for p in self.parameters():
            if isinstance(p, Parameter):
                p.zero_grad()
            elif p.grad is not None:
                p.grad.zero_()

    def reset_ctx(self, ctx):
        """Move every parameter to ``ctx`` in place (reference :96)."""
        for p in self.collect_params().values():
            p.reset_ctx(ctx)

    reset_device = reset_ctx

    def register_child(self, block, name=None):
        """Register ``block`` as a child under ``name`` (default: the
        number of children so far), as the reference (:107)."""
        self.add_module(name or str(len(self._modules)), block)

    def register_forward_hook(self, hook):
        """``hook(block, args, out)`` after each forward (reference :112);
        its return value is ignored. Returns torch's removable handle."""
        return super().register_forward_hook(_ignore_result(hook))

    def register_forward_pre_hook(self, hook):
        """``hook(block, args)`` before each forward (reference :116)."""
        return super().register_forward_pre_hook(_ignore_result(hook))

    def summary(self, *inputs):
        """Print each parameter's name, shape and dtype and their total, as
        the reference's lines (:176); ``inputs`` are accepted."""
        params = self.collect_params()
        lines = [f"{type(self).__name__}:"]
        for name, p in params.items():
            shape = None if p.shape is None else tuple(p.shape)
            lines.append(f"  {name:<40} {str(shape):<20} "
                         f"{dtype_name(p.dtype)}")
        n = sum(math.prod(p.shape) for p in params.values() if p.shape)
        lines.append(f"  total parameters: {n}")
        print("\n".join(lines))

    def hybridize(self, active=True, **kwargs):
        """Hybridize every child (reference :77); the reference's keyword
        options (``static_alloc``, ``static_shape``) are what a CUDA graph
        does anyway and are accepted."""
        for child in self.children():
            if isinstance(child, Block):
                child.hybridize(active, **kwargs)

    def cast(self, dtype):
        """Cast every parameter to ``dtype`` in place (reference :81)."""
        for param in self.collect_params().values():
            param.cast(dtype)

    # -- persistence (reference: block.py:117-159) ---------------------------
    def save_parameters(self, filename, deduplicate=False):
        """Write the parameters in the reference's ``.params`` format: a
        numpy ``savez`` archive keyed by ``collect_params()`` names
        (bfloat16 stored as float32). A parameter still of unknown shape is
        left out, as in the reference; ``deduplicate`` is accepted, as
        there."""
        arrays = {}
        for name, p in self.collect_params().items():
            if getattr(p, "is_deferred", False):
                continue
            t = p.detach()
            if t.dtype == torch.bfloat16:
                t = t.float()
            arrays[name] = t.cpu().numpy()
        with open(filename, "wb") as fh:
            onp.savez(fh, **arrays)

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current", device=None):
        """Load a ``.params`` file written by either package (reference
        :133-153) through :meth:`load_dict`."""
        with onp.load(filename) as z:
            loaded = {n: z[n] for n in z.files}
        self.load_dict(loaded, ctx, allow_missing, ignore_extra, cast_dtype,
                       dtype_source, device)

    def save(self, prefix):
        """``save_parameters`` to ``{prefix}-model.params.npz``."""
        self.save_parameters(f"{prefix}-model.params.npz")

    def load(self, prefix):
        """``load_parameters`` from ``{prefix}-model.params.npz``."""
        self.load_parameters(f"{prefix}-model.params.npz")

    @torch.no_grad()
    def load_dict(self, arrays, ctx=None, allow_missing=False,
                  ignore_extra=False, cast_dtype=False,
                  dtype_source="current", device=None):
        """Set the parameters from ``{name: numpy array, tensor or
        NDArray}`` with the reference's ``load_parameters`` semantics: each
        parameter takes its array by name (``Parameter.set_data``: a copy in
        place where it is initialized, so captured programs read the new
        values; a placeholder of unknown shape takes the array's), in its
        own dtype (``dtype_source="current"``) or the array's
        (``"saved"``); a name missing from ``arrays`` raises unless
        ``allow_missing``, a name the block lacks unless ``ignore_extra``;
        ``ctx``/``device`` moves the parameters there. ``cast_dtype`` is
        accepted, as in the reference."""
        if dtype_source not in ("current", "saved"):
            raise MXNetError(f"dtype_source must be 'current' or 'saved', "
                             f"got {dtype_source!r}")
        arrays = dict(arrays)
        where = ctx if device is None else device
        for name, p in self.collect_params().items():
            if name not in arrays:
                if not allow_missing:
                    raise MXNetError(f"parameter {name} missing in the "
                                     "loaded arrays")
                continue
            t = _host_array(name, arrays.pop(name))
            if where is not None:
                p.reset_ctx(where)
            if dtype_source == "saved" and t.dtype != p.dtype:
                p.cast(t.dtype)
            p.set_data(t)
        if arrays and not ignore_extra:
            raise MXNetError(f"extra parameters: {sorted(arrays)}")


_SCALARS = (int, float, str, bool, type(None))
_SLOT = object()    # a tensor operand's place in an argument key


class _Unkeyable(Exception):
    """An argument that a signature cannot hold: the call runs eagerly."""


def _arg_key(x, tensors, nds=None):
    """``x``'s hashable key: every tensor or NDArray in it (at any depth of
    tuples and lists) appended to ``tensors`` as a tensor (and whether it
    was an NDArray to ``nds``) and replaced by a slot, containers as
    ``(type, items)``, other values as ``(type, value)``."""
    if isinstance(x, (torch.Tensor, NDArray)):
        nd = isinstance(x, NDArray)
        tensors.append(x._data if nd else x)
        if nds is not None:
            nds.append(nd)
        return _SLOT
    if isinstance(x, (tuple, list)):
        return (type(x), tuple(_arg_key(v, tensors, nds) for v in x))
    if isinstance(x, _SCALARS):
        return (type(x), x)
    raise _Unkeyable


def _from_key(key, tensors):
    """The arguments ``key`` stands for, its slots taken from the iterator
    ``tensors``."""
    if key is _SLOT:
        return next(tensors)
    typ, val = key
    if typ in (tuple, list):
        return typ(_from_key(v, tensors) for v in val)
    return val


class HybridBlock(Block):
    """A block whose forward ``hybridize()`` turns into cached programs
    (see the module docstring)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix, params)
        self._active = False
        self._cached = {}   # signature -> (CachedOp, out_tree, parameters)
        self._gpools = {}   # device -> the GraphPool of all its CachedOps
        self._pass_backend = None   # optimize_for's subgraph backend

    def hybridize(self, active=True, **kwargs):
        self._active = bool(active)
        self._cached = {}
        self._gpools = {}
        self._pass_backend = None   # hybridize() drops an optimize_for
        super().hybridize(active, **kwargs)

    def optimize_for(self, x, *args, backend=None, clear=True, **kwargs):
        """Hybridize with a subgraph backend's passes applied to the traced
        graph (reference :204-217): from then on the block's programs are
        CUDA graphs of the rewritten graph's executor, one per signature,
        until ``hybridize()``. Runs one forward on ``(x, *args)``; with
        ``clear=False`` the programs made before are kept."""
        from .. import subgraph

        if kwargs:
            raise MXNetError(
                f"optimize_for: unsupported options {sorted(kwargs)}: "
                "passes receive only the Symbol")
        if backend is not None:
            subgraph.get_passes(backend)
        kept = {} if clear else dict(self._cached)
        self.hybridize()
        self._pass_backend = backend
        self._cached.update(kept)
        self(x, *args)

    def infer_shape(self, *args, **kwargs):
        """Give every parameter of unknown shape its shape from ``args`` by
        one eager forward in predict mode."""
        self._ensure_initialized(*unwrap(args), **{
            k: unwrap(v) for k, v in kwargs.items()})

    def export(self, path, epoch=0, remove_amp_cast=True):
        """Write ``{path}-symbol.json`` (the reference's Symbol JSON) and
        ``{path}-{epoch:04d}.params.npz`` (the parameters by
        ``collect_params()`` name), as the reference (:318-332); returns the
        two file names. The graph is the block's first program's, traced at
        that program's signature with the inputs it holds (the rewritten one
        after ``optimize_for``); the AMP cast attribute ``__amp__`` is left
        out (``remove_amp_cast``). Raises before a hybridized forward, and
        for bfloat16 parameters (no package of the card's machine reads
        numpy's bfloat16)."""
        import json

        if not self._cached:
            raise MXNetError("hybridize() and run a forward pass before "
                             "export()")
        cop = next(iter(self._cached.values()))[0]
        graph = json.loads(cop.sym.tojson())
        if remove_amp_cast:
            for node in graph["nodes"]:
                node.get("attrs", {}).pop("__amp__", None)
        params = {}
        for name, p in self.collect_params().items():
            if p.dtype == torch.bfloat16:
                raise MXNetError(f"export: parameter {name} is bfloat16; "
                                 "bfloat16 graphs are not exported")
            params[name] = p.detach().cpu().numpy()
        sym_file = f"{path}-symbol.json"
        with open(sym_file, "w") as f:
            json.dump(graph, f, indent=1)
        param_file = f"{path}-{epoch:04d}.params.npz"
        with open(param_file, "wb") as fh:
            onp.savez(fh, **params)
        return sym_file, param_file

    def _ensure_initialized(self, *args, **kwargs):
        """Fill the parameters still of unknown shape by one eager forward
        in predict mode (reference :222), before any capture: a fill
        inside a capture raises."""
        if any(getattr(p, "is_deferred", False) for p in self.parameters()):
            with _ag.pause(), torch.no_grad(), _cached_op.inlined():
                torch.nn.Module.__call__(self, *args, **kwargs)

    def __call__(self, *args, **kwargs):
        if not self._active or _cached_op.is_inlined():
            return super().__call__(*args, **kwargs)
        nd = _has_nd(args, kwargs)
        tensors, nds = [], []
        try:
            key = _arg_key((args, tuple(sorted(kwargs.items()))), tensors,
                           nds)
        except _Unkeyable:
            return super().__call__(*args, **kwargs)
        if self._tensor_body:
            nds = [False] * len(nds)
            self._ensure_initialized(*unwrap(args), **{
                k: unwrap(v) for k, v in kwargs.items()})
        else:
            self._ensure_initialized(*args, **kwargs)
        where = tuple((p.data_ptr(), p.dtype) for p in self.parameters())
        sig = (tuple((tuple(t.shape), t.dtype, t.device) for t in tensors),
               (key, tuple(nds)), _ag.is_training(), self.training,
               _amp._snapshot(), where)
        entry = self._cached.get(sig)
        if entry is None:
            # programs that read the parameters at other addresses (before
            # a cast or a fill) would not be found again
            self._cached = {s: e for s, e in self._cached.items()
                            if s[-1] == where}
            entry = self._cached[sig] = self._build_cache(
                key, tensors, nds, traced=not _ag.is_recording())
        cop, _, params = entry
        out = cop(*tensors, *params)
        out = _cached_op.unflatten_out(
            list(out) if isinstance(out, tuple) else [out], cop._tree)
        return wrap(out) if nd else out

    def _build_cache(self, key, tensors, nds, traced=True):
        """Trace the forward of the call that ``key`` and its ``tensors``
        stand for into a CachedOp (reference :266); returns
        ``(cached_op, out_tree, parameters)``. The body receives as
        NDArrays the operands that ``nds`` marks. Without ``traced`` (a
        call under ``record()``, whose node runs the body once itself) the
        forward is not run here and the tree is None until the first
        call."""
        params = list(self.collect_params().items())
        plist = [p for _, p in params]
        device = plist[0].device if plist else tensors[0].device
        gpool = self._gpools.get(device)
        if gpool is None:
            gpool = self._gpools[device] = _cached_op.GraphPool(device)

        def fn(*data):
            args, kwargs = _from_key(key, iter(data))
            return torch.nn.Module.__call__(self, *args, **dict(kwargs))

        def rebind(aliases):
            return rebound(self, dict(zip(map(id, plist), aliases)))

        inputs = [NDArray(t) if n else t for t, n in zip(tensors, nds)]
        backend = self._pass_backend
        if backend is not None:
            from .. import subgraph

            with _ag.pause(train_mode=_ag.is_training()):
                tree, _, cop = _cached_op.trace(
                    fn, inputs, params, gpool=gpool,
                    transform=lambda s: subgraph.apply_passes(s, backend))
            return cop, tree, plist
        if not traced:
            cop = _cached_op.CachedOp(fn, nds, params, device=device,
                                      rebind=rebind, gpool=gpool)
            return cop, None, plist
        tree, _, cop = _cached_op.trace(fn, inputs, params, rebind=rebind,
                                        gpool=gpool)
        return cop, tree, plist

    # -- serving (serve.Predictor construction) ------------------------------
    def _serving_graph(self, inputs):
        """Trace a copy of this block (:meth:`_serving_copy`) in predict
        mode into ``(CachedOp, out_tree, parameters)``: the
        ``serve.Predictor``'s hook (reference :293). The reference's
        predictor serves the immutable arrays it was built with; the port's
        parameters change in place, so it serves a copy that nothing else
        calls. Dropout is the identity and BatchNorm reads its running
        statistics, so the programs write nothing and may replay from the
        serving thread."""
        inputs = tuple(unwrap(inputs))
        self._ensure_initialized(*(inputs if self._tensor_body
                                   else wrap(inputs)))
        tensors = []
        key = _arg_key((inputs, ()), tensors)
        with _ag.pause():
            return self._serving_copy()._build_cache(
                key, tensors, [not self._tensor_body] * len(tensors))

    def _serving_copy(self):
        """This block with a clone of every parameter (``grad_req``
        ``'null'``) and no programs: a later ``load_parameters``, ``cast``
        or training step of the block does not reach it."""
        memo = {id(p): Parameter(p.detach().clone(), grad_req="null")
                for p in self.parameters()}
        for blk in self.modules():
            if isinstance(blk, HybridBlock):
                memo[id(blk._cached)] = {}
                memo[id(blk._gpools)] = {}
            if isinstance(blk, SymbolBlock):
                memo[id(blk._sym)] = blk._sym   # immutable: shared
        return copy.deepcopy(self, memo)

    def predictor(self, example=None, **kwargs):
        """A ``serve.Predictor`` serving this block (reference :308);
        keyword arguments pass through: ``max_batch``, ``buckets``,
        ``max_wait_us``, ``cache_dir``, ``manifest``."""
        from ..serve import Predictor

        return Predictor(self, example, **kwargs)


class SymbolBlock(HybridBlock):
    """A Symbol run as a block (reference :335-386): the graph's variables
    named in ``inputs`` are its data operands, in that order; the others
    are its parameters, filled from ``params`` (``{name: tensor or numpy
    array}``). It is a ``HybridBlock``: ``hybridize()`` makes one CUDA
    graph of the graph's executor per signature, it is differentiable under
    ``autograd.record()`` (one tape node when hybridized), and ``cast``,
    ``load_parameters``, ``collect_params()``, ``export``,
    ``optimize_for`` and a ``Predictor`` work as on any block.

    ``torch.nn.Module`` refuses dotted names, so the parameters are
    registered under ``arg0, arg1, ...``; ``collect_params()`` gives the
    graph's own names (``encoder.layers.0.attn_qkv.weight``)."""

    _tensor_body = True

    def __init__(self, outputs, inputs, params=None, device=None):
        super().__init__()
        from ..cached_op import build_executor
        from ..context import resolve_device
        from ..symbol import Group, Symbol, topo_sort

        if isinstance(outputs, (list, tuple)):
            outputs = Group(outputs)
        if not isinstance(outputs, Symbol):
            raise MXNetError("SymbolBlock needs a Symbol (or a list of them)")
        names = [s.name if isinstance(s, Symbol) else s for s in
                 (inputs if isinstance(inputs, (list, tuple)) else [inputs])]
        var_nodes = [n for n in topo_sort(outputs._entries) if n.is_var]
        by_name = {n.name: n for n in var_nodes}
        unknown = [n for n in names if n not in by_name]
        if unknown:
            raise MXNetError(f"SymbolBlock: inputs {unknown} are not "
                             f"variables of the graph")
        self._sym = outputs
        self._input_names = names
        param_nodes = [n for n in var_nodes if n.name not in names]
        self._param_names = [n.name for n in param_nodes]
        self._exec, _ = build_executor(
            outputs._entries, [by_name[n] for n in names] + param_nodes)
        self._slots = {}    # graph name -> registered name
        self._param_device = resolve_device(device)
        for name, value in (params or {}).items():
            if name in self._param_names:
                self._set_param(name, value)

    def _set_param(self, name, value):
        value = _host_array(name, value)
        slot = self._slots.get(name)
        if slot is None:
            slot = self._slots[name] = f"arg{self._param_names.index(name)}"
        value = value.detach().to(self._param_device).clone()
        self.register_parameter(slot, Parameter(
            value, grad_req="write" if value.is_floating_point() else "null"))

    def collect_params(self, select=None):
        params = OrderedDict((n, self._parameters[self._slots[n]])
                             for n in self._param_names if n in self._slots)
        for name, p in params.items():
            p._name = name
        if select is None:
            return params
        pat = re.compile(select)
        return OrderedDict((n, p) for n, p in params.items()
                           if pat.match(n))

    @torch.no_grad()
    def load_dict(self, arrays, ctx=None, allow_missing=False,
                  ignore_extra=False, cast_dtype=False,
                  dtype_source="current", device=None):
        """As :meth:`Block.load_dict`; a name that is not one of the graph's
        parameters raises unless ``ignore_extra``, and a parameter of the
        graph not yet set (``imports(..., allow_missing_params=True)``)
        takes its array."""
        extra = sorted(set(arrays) - set(self._param_names))
        if extra and not ignore_extra:
            raise MXNetError(f"parameters {extra} are not in the graph")
        for name in self._param_names:
            if name not in self._slots and name in arrays:
                self._set_param(name, arrays[name])
        super().load_dict(arrays, ctx, allow_missing, True, cast_dtype,
                          dtype_source, device)

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None,
                allow_missing_params=False):
        """A SymbolBlock from ``export``'s files (either package's): the
        graph, its inputs by name, and the parameters on ``ctx``'s device
        (the GPU by default). A parameter missing from ``param_file``
        raises unless ``allow_missing_params`` (then ``load_parameters``
        fills it before the first forward)."""
        from ..symbol import Symbol

        sym = Symbol.load(symbol_file)
        params = {}
        if param_file:
            with onp.load(param_file) as z:
                params = {k: _host_array(k, z[k]) for k in z.files}
        blk = SymbolBlock(sym, [input_names] if isinstance(input_names, str)
                          else input_names, params, device=ctx)
        missing = [n for n in blk._param_names if n not in blk._slots]
        if missing and not allow_missing_params:
            raise MXNetError(f"parameters {missing} missing in "
                             f"{param_file}")
        return blk

    def forward(self, *args):
        if len(args) != len(self._input_names):
            raise MXNetError(f"SymbolBlock takes {len(self._input_names)} "
                             f"inputs {self._input_names}, got {len(args)}")
        missing = [n for n in self._param_names if n not in self._slots]
        if missing:
            raise MXNetError(f"SymbolBlock: parameters {missing} are not "
                             "loaded")
        outs = self._exec(*args, *[self._parameters[self._slots[n]]
                                   for n in self._param_names])
        return outs[0] if len(outs) == 1 else outs


def _host_array(name, a):
    """A loaded value as a tensor: a tensor or an NDArray as it is, a numpy
    array copied (the JAX package's bfloat16 and fp8 arrays through
    float32). A file's bfloat16 array that numpy cannot read (no
    ``ml_dtypes``: raw bytes) raises."""
    if isinstance(a, NDArray):
        a = a._data
    if isinstance(a, torch.Tensor):
        return a.detach()
    a = onp.asarray(a)
    if a.dtype.name in _LOW_PRECISION:
        return torch.from_numpy(a.astype("float32")).to(
            to_dtype(a.dtype.name))
    if a.dtype.kind not in "fiub":
        raise MXNetError(f"parameter {name}: dtype {a.dtype} is not read "
                         "(bfloat16 files are not supported)")
    return torch.from_numpy(onp.array(a, copy=True))
