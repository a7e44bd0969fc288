"""gluon.Trainer — applies an optimizer to a set of parameters on one device.

Counterpart of ``mxnet_tpu/gluon/trainer.py:28-446``, for one device and one
worker: the eager loop ::

    with autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(batch_size)

``step`` sets ``rescale_grad = scale / batch_size`` (reference :196), runs
``allreduce_grads`` (nothing to reduce with one worker) and updates every
parameter whose ``grad_req`` is not ``'null'`` in place under
``torch.no_grad()``. A parameter that no backward has reached yet updates
with a zero gradient, as the reference's zero-filled gradient buffer does.

The update is the fused multi-tensor update of the reference (:240-390) by
default: float parameters are bucketed by dtype; in each bucket a tensor
over ``_FUSE_FLAT_MAX`` (4096) elements runs the optimizer's registered
recurrence once, and the small ones are flattened into one vector and run
it once together, the hypers spread per element (for a recurrence the
optimizer declares elementwise). GPT-2 small's 148 trainables take 51 calls
instead of 148. The arithmetic per element is the per-parameter path's: on
the CPU the two give the same bits; on CUDA the loop's Python-scalar hypers
divide by a reciprocal multiply, so they differ in the last bits.
``MXNET_FUSED_TRAINER=0`` keeps the
per-parameter loop; non-float parameters, optimizers without a fusable
step and parameters whose gradient is a ``RowSparseNDArray`` (the
optimizer's lazy row-sparse update, reference :255-263) take it too. Under ``multi_precision`` the fused update runs the
recurrence on the float32 master copies (the ``weight_fp32`` states) and
rounds them into the low-precision weights with one multi-tensor copy a
bucket, as the per-parameter path does one tensor at a time (the
reference's fused update leaves ``multi_precision`` to the per-parameter
loop). An optimizer that is not elementwise (LAMB, LARS, LANS,
GroupAdaGrad, NAG) runs the recurrence once a tensor, never over the
flattened small tensors, so its whole-tensor norms see one tensor.

``compile_step(net, loss_fn)`` builds the compiled train step
(:class:`mxnet_tpu_torch.train_step.CompiledTrainStep`): forward, loss,
backward and this update as one CUDA graph a step.

The optimizer state is saved and loaded in the reference's layout (a
pickle of numpy arrays), so a state file of the JAX package loads here and
the other way round. Loading writes into the state tensors in place where
they exist, so a captured compiled step keeps reading them.

Not ported yet: the kvstore and multi-worker reduction.
"""
from __future__ import annotations

import math
import os
import pickle

import torch

from .. import optimizer as opt_mod
from ..base import MXNetError
from ..ndarray.sparse import RowSparseNDArray
from ..parallel.collectives import BucketSpec

__all__ = ["Trainer"]

# tensors at or under this many elements are flattened into one call of an
# elementwise recurrence (reference trainer.py:283): biases and LayerNorm
# gains are two thirds of GPT-2's tensors and 0.1 % of its elements
_FUSE_FLAT_MAX = 4096


class _FusedBucket:
    """The layout of one dtype bucket of the fused update: which tensors
    (by position in the bucket) run the recurrence alone (``big``) and
    which are flattened into one call (``small``, with its
    :class:`BucketSpec`)."""

    def __init__(self, shapes, elementwise, flat_ok):
        small = [k for k in range(len(shapes))
                 if elementwise and math.prod(shapes[k]) <= _FUSE_FLAT_MAX
                 and flat_ok[k]]
        self.small = small if len(small) > 1 else []
        chosen = set(self.small)
        self.big = [k for k in range(len(shapes)) if k not in chosen]
        self.spec = BucketSpec([shapes[k] for k in self.small]) \
            if self.small else None
        self._small_pos = {}

    @property
    def calls(self):
        """Calls of the recurrence per update."""
        return len(self.big) + (1 if self.small else 0)

    def _spread(self, vec):
        """Per-tensor hypers of the bucket -> per element of the flat
        small tensors."""
        pos = self._small_pos.get(vec.device)
        if pos is None:
            pos = self._small_pos[vec.device] = torch.tensor(
                self.small, dtype=torch.int64).to(vec.device)
        return self.spec.spread(vec.index_select(0, pos))

    def update(self, step, ws, ss, gs, lrs, wds, ts, rescale, keep=None):
        """Run ``step = (raw, state_keys, needs_t, _)`` over the bucket and
        write the new weights ``ws`` and states ``ss`` (tuples in
        ``state_keys`` order) in place. ``lrs``/``wds`` are float32 and
        ``ts`` float64 tensors, one entry a tensor; ``rescale`` multiplies
        the gradients. Where the 0-dim bool tensor ``keep`` is True the old
        values stay (the loss scaler's skip). Returns the number of calls
        of the recurrence."""
        raw, keys, needs_t, _ = step

        def run(w, st, g, lr, wd, t, dsts):
            args = [w, *st, g * rescale, lr, wd]
            if needs_t:
                args.append(t)
            out = raw(*args)
            out = out if keys else (out,)
            # an output that is an input (DCASGD's previous weight) is
            # read before its tensor is written
            out = [o.clone() if any(o is x for x in (w, *st)) else o
                   for o in out]
            for old, new, dst in zip((w, *st), out, dsts):
                if keep is not None:
                    new = torch.where(keep, old, new)
                if dst is None:
                    old.copy_(new)
                else:   # one multi-tensor copy back, not one a tensor
                    torch._foreach_copy_(dst, self.spec.unflatten(new))

        for k in self.big:
            run(ws[k], ss[k], gs[k], lrs[k], wds[k], ts[k],
                [None] * (1 + len(keys)))
        if self.small:
            flat = self.spec.flatten
            sw = [ws[k] for k in self.small]
            sst = [[ss[k][j] for k in self.small] for j in range(len(keys))]
            run(flat(sw), [flat(col) for col in sst],
                flat([gs[k] for k in self.small]), self._spread(lrs),
                self._spread(wds), self._spread(ts), [sw, *sst])
        return self.calls


def update_targets(params, states):
    """The tensors the recurrence updates: each parameter's float32 master
    copy (``multi_precision``'s ``weight_fp32`` state) where it has one,
    else the parameter."""
    return [st.get("weight_fp32", p) for p, st in zip(params, states)]


def round_masters(params, targets):
    """Round the updated master copies into their low-precision
    parameters, one multi-tensor copy."""
    pairs = [(p, w) for p, w in zip(params, targets) if w is not p]
    if pairs:
        torch._foreach_copy_([p for p, _ in pairs], [w for _, w in pairs])


def _fused_layout(weights, states, state_keys, elementwise):
    """:class:`_FusedBucket` of one dtype bucket: a tensor may be flattened
    only when each of its states has its shape."""
    return _FusedBucket(
        [tuple(w.shape) for w in weights], elementwise,
        [all(st[k].shape == w.shape for k in state_keys)
         for w, st in zip(weights, states)])


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore=None, compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, dict):
            names, params = list(params), list(params.values())
        elif isinstance(params, (list, tuple)):
            names = [f"param{i}" for i in range(len(params))]
        else:
            raise MXNetError("params must be a dict or list of Parameters")
        for n, p in zip(names, params):
            if not isinstance(p, torch.nn.Parameter):
                raise MXNetError(f"invalid parameter {n}: {type(p)}")
        if kvstore not in (None, "local", "device") or update_on_kvstore:
            raise MXNetError(
                f"kvstore={kvstore!r}, update_on_kvstore="
                f"{update_on_kvstore!r}: the port's Trainer runs on one "
                "device; the kvstore is not ported yet")
        self._params = list(params)
        self._names = names
        param_dict = dict(enumerate(self._params))
        optimizer_params = optimizer_params or {}
        if isinstance(optimizer, opt_mod.Optimizer):
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt_mod.create(optimizer,
                                             param_dict=param_dict,
                                             **optimizer_params)
        self._states = [None] * len(self._params)
        self._scale = self._optimizer.rescale_grad
        # the fused multi-tensor update (reference :61-66)
        self._fuse = os.environ.get("MXNET_FUSED_TRAINER", "1") != "0"
        self._fused_fn = {}         # (dtype, indices) -> _FusedBucket
        self._fused_traces = 0      # layouts built (the reference's traces)
        self._fused_dispatches = 0  # fused bucket updates run
        self._fused_calls = 0       # calls of the recurrence they made
        self._compiled_step = None  # CompiledTrainStep of compile_step()

    # -- properties ---------------------------------------------------------
    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    # -- whole-step compilation (reference :81-145) --------------------------
    def compile_step(self, net, loss_fn, mesh=None, loss_scaler=None,
                     shard_update=None, strict_batch=False,
                     shard_params=None, partition_rules=None,
                     multi_step=None, accumulate=None):
        """Build the compiled train step of ``net`` and ``loss_fn``: one
        CUDA graph a step, replayed (see
        :class:`~mxnet_tpu_torch.train_step.CompiledTrainStep`); also kept
        as ``self.step_fn``. Its semantics are the eager loop's
        ``loss_fn(net(x), y).mean(); backward(); step(1)``.

        ``multi_step=K`` takes inputs stacked ``[K, batch, ...]`` and runs
        K optimizer steps a call; ``accumulate=G`` sums the gradients of G
        stacked microbatches before each update. ``MXTPU_MULTI_STEP``
        overrides ``multi_step`` (``0`` disables it). ``mesh`` and the
        sharding options are not ported yet and raise."""
        from ..train_step import CompiledTrainStep

        self._compiled_step = CompiledTrainStep(
            self, net, loss_fn, mesh=mesh, loss_scaler=loss_scaler,
            shard_update=shard_update, strict_batch=strict_batch,
            shard_params=shard_params, partition_rules=partition_rules)
        env = os.environ.get("MXTPU_MULTI_STEP")
        if env is not None:
            env = env.strip()
            multi_step = int(env) if env else None
            if multi_step is not None and multi_step < 1:
                multi_step = None   # 0 disables any coded-in default
        if multi_step is not None or (accumulate or 1) > 1:
            self._compiled_step.compile_multi_step(
                multi_step, accumulate=accumulate or 1)
        return self._compiled_step

    @property
    def step_fn(self):
        """The compiled step built by ``compile_step``."""
        if self._compiled_step is None:
            raise MXNetError(
                "no compiled step: call trainer.compile_step(net, loss_fn) "
                "first")
        return self._compiled_step

    # -- the step -----------------------------------------------------------
    def allreduce_grads(self):
        """Sum gradients across workers: a no-op with the one worker the
        port has."""

    def step(self, batch_size, ignore_stale_grad=False):
        """Rescale gradients by 1/batch_size, allreduce, update.
        ``ignore_stale_grad`` is accepted for parity: the reference skips
        uninitialised parameters with it, and the port has none."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self.allreduce_grads()
        self._update(ignore_stale_grad)

    def update(self, batch_size, ignore_stale_grad=False):
        """Update without the allreduce (manual gradient management)."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _trainable(self, i):
        p = self._params[i]
        return getattr(p, "grad_req", "write") != "null" and p.requires_grad

    @torch.no_grad()
    def _update(self, ignore_stale_grad=False):
        opt = self._optimizer
        active = []
        for i, p in enumerate(self._params):
            if not self._trainable(i):
                continue
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            if self._states[i] is None:
                self._states[i] = opt.create_state_multi_precision(i, p)
            active.append(i)
        for i in self._fused_update(active):
            p = self._params[i]
            opt.update(i, p, p.grad, self._states[i])

    def _fused_update(self, active):
        """Fused multi-tensor update (reference :240-274): dense float
        parameters bucketed by dtype, one fused update a bucket. Returns
        the indices left to the per-parameter path (row-sparse gradients,
        which take the optimizer's lazy update there, non-float
        parameters)."""
        opt = self._optimizer
        spec = opt.fused_step
        if not self._fuse or spec is None or not active:
            return active
        buckets, rest = {}, []
        for i in active:
            w = self._params[i]
            if isinstance(w.grad, RowSparseNDArray) or \
                    not w.is_floating_point() or \
                    any(k not in self._states[i] for k in spec[1]):
                rest.append(i)
                continue
            buckets.setdefault(str(w.dtype), []).append(i)
        for dt in sorted(buckets):
            self._run_fused_bucket(spec, buckets[dt])
        return rest

    def _run_fused_bucket(self, spec, idxs):
        """One fused update of the bucket ``idxs`` (reference :285-390).
        The hypers go to the device as one table (a pinned copy, no host
        sync); t and lr are counted and read as the per-parameter path
        does."""
        opt = self._optimizer
        _, keys, _, elementwise = spec
        ps = [self._params[i] for i in idxs]
        ws = update_targets(ps, [self._states[i] for i in idxs])
        ss = [tuple(self._states[i][k] for k in keys) for i in idxs]
        key = (str(ws[0].dtype), tuple(idxs))
        layout = self._fused_fn.get(key)
        if layout is None:
            layout = self._fused_fn[key] = _fused_layout(
                ws, [self._states[i] for i in idxs], keys, elementwise)
            self._fused_traces += 1
        ts = [opt._update_count(i) for i in idxs]
        table = _hyper_table([[opt._get_lr(i) for i in idxs],
                             [opt._get_wd(i) for i in idxs], ts],
                            ws[0].device)
        self._fused_dispatches += 1
        self._fused_calls += layout.update(
            spec, ws, ss, [p.grad for p in ps], table[0].float(),
            table[1].float(), table[2], opt.rescale_grad)
        round_masters(ps, ws)

    # -- checkpoint ---------------------------------------------------------
    def states_payload(self):
        """The optimizer state as host numpy arrays in the reference's
        per-parameter layout: ``{"states": [None | {key: array}],
        "num_update": int, "index_count": {index: count}}``."""
        states = [None if st is None else
                  {k: v.detach().cpu().numpy() for k, v in st.items()}
                  for st in self._states]
        return {"states": states,
                "num_update": self._optimizer.num_update,
                "index_count": dict(self._optimizer._index_update_count)}

    @torch.no_grad()
    def load_states_payload(self, payload):
        """Restore a ``states_payload()`` snapshot of either package. A
        state whose tensors exist with the same keys and shapes is written
        in place (a captured compiled step keeps reading it); others are
        replaced, and a compiled step then captures anew."""
        from ..convert import trainer_states_from_mxnet_tpu

        payload = trainer_states_from_mxnet_tpu(payload, self._params,
                                                self._names)
        for i, new in enumerate(payload["states"]):
            old = self._states[i]
            if old is not None and new is not None and \
                    old.keys() == new.keys() and \
                    all(old[k].shape == new[k].shape and
                        old[k].dtype == new[k].dtype for k in old):
                for k in old:
                    old[k].copy_(new[k])
            else:
                self._states[i] = new
        self._optimizer.num_update = payload["num_update"]
        self._optimizer._index_update_count = dict(payload["index_count"])

    def save_states(self, fname):
        """Write the optimizer state (reference: trainer.py:434)."""
        with open(fname, "wb") as f:
            pickle.dump(self.states_payload(), f)

    def load_states(self, fname):
        """Read a state file written by ``save_states`` of either package:
        a pickle of numpy arrays, which needs no JAX to read. Unpickling
        can run code: load only files this program or the JAX package
        wrote."""
        with open(fname, "rb") as f:
            payload = pickle.load(f)
        self.load_states_payload(payload)


def _hyper_table(rows, device):
    """Rows of per-tensor hypers as one float64 ``(len(rows), n)`` tensor
    on ``device``, copied from pinned memory without a host sync."""
    table = torch.tensor(rows, dtype=torch.float64)
    if torch.device(device).type != "cuda":
        return table.to(device)
    return table.pin_memory().to(device, non_blocking=True)
