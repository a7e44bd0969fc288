"""Control-flow operators of the port: ``foreach``, ``while_loop``, ``cond``.

Counterpart of ``mxnet_tpu/numpy_extension/control_flow.py`` and the
registered ``_foreach`` / ``_while_loop`` / ``_cond``
(``mxnet_tpu/ops/npi_manip.py:186-215``). Each call is one operator, as in
the reference, whose gradients reach only the explicit operands (``data`` and the states, the
``loop_vars``, the ``inputs`` of ``cond``). An array the body captures by
closure takes part in the values but gets no gradient through the
operator; pass it as an operand instead.

Under ``autograd.record()`` with an operand that takes gradients the call
is one ``torch.autograd.Function``: its forward runs the body once,
recording, on detached copies of the explicit operands, and keeps that
graph; its backward asks it for the gradients of those copies only
(``torch.autograd.grad``). So a closure capture stays outside the tape,
where a Python loop on the tensors would give it a gradient, and the body
runs once a step.

Eagerly ``while_loop`` and ``cond`` read their predicates on the host.
While a CUDA graph captures (a hybridized block on the card) nothing may
be read back, so:

- ``foreach`` runs as written (its length is the data's);
- ``while_loop`` with ``max_iterations`` runs the reference's masked form:
  every one of the ``max_iterations`` steps runs the body, and a step after
  the condition first fails keeps the variables and outputs zeros (the
  values of the eager loop, for a pure body). Without ``max_iterations``
  it cannot end on data inside a capture and raises :class:`MXNetError`;
- ``cond`` computes both branches and selects with ``torch.where`` (the
  same values, for pure branches).

With step outputs ``while_loop`` returns them stacked to
``max_iterations`` rows, rows past the last step zeros, as the reference;
step outputs without ``max_iterations`` raise, as there.
"""
from __future__ import annotations

import torch

from .. import autograd as _ag
from ..base import MXNetError
from ..context import resolve_device
from ..ndarray.ndarray import NDArray
from ..ops.registry import register

__all__ = ["foreach", "while_loop", "cond"]


def _as_list(x):
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def _t(x):
    """The tensor of an NDArray, tensor or Python number."""
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x)


def _nds(ts):
    return [NDArray(t) for t in ts]


def _capturing(ts):
    return any(t.is_cuda for t in ts) and \
        torch.cuda.is_current_stream_capturing()


class _ControlFlow(torch.autograd.Function):
    """``run(*operands)`` -> tuple of tensors, as one node of the tape whose
    gradients reach the operands only (see the module docstring)."""

    @staticmethod
    def forward(ctx, run, *operands):
        leaves = [x.detach().requires_grad_(x.requires_grad and
                                            x.is_floating_point())
                  for x in operands]
        with _ag.record(train_mode=False):
            outs = run(*leaves)
        ctx.graph = leaves, outs
        # the node's outputs are its own tensors, off the inner graph
        outs = tuple(o.detach().clone() if any(o is x for x in leaves)
                     else o.detach() for o in outs)
        ctx.mark_non_differentiable(*[o for o in outs
                                      if not o.is_floating_point()])
        return outs

    @staticmethod
    def backward(ctx, *grads):
        leaves, outs = ctx.graph
        need = ctx.needs_input_grad[1:]
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        wanted = [x for x, n in zip(leaves, need) if n]
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], wanted, [g for _, g in pairs],
            allow_unused=True) if pairs else [None] * len(wanted))
        return (None, *[next(got) if n else None for n in need])


def _call(run, operands):
    """Run ``run`` over the operands' tensors: one tape node while
    recording with an operand that takes gradients, else paused."""
    ts = [_t(x) for x in operands]
    if _ag.is_recording() and any(t.requires_grad for t in ts):
        return list(_ControlFlow.apply(run, *ts))
    with _ag.pause():
        return list(run(*ts))


def foreach(body, data, init_states):
    """Run ``body(x_t, states) -> (out_t, new_states)`` over axis 0 of
    ``data`` (reference :38); returns (outputs stacked on axis 0, final
    states)."""
    data_list = _as_list(data)
    states0 = _as_list(init_states)
    n_data = len(data_list)
    n_out = []

    def run(*ts):
        datas, states = ts[:n_data], list(ts[n_data:])
        steps = []
        for i in range(datas[0].shape[0]):
            xs = _nds(d[i] for d in datas)
            out, new = body(xs if n_data > 1 else xs[0], _nds(states))
            steps.append([_t(o) for o in _as_list(out)])
            states = [_t(s) for s in _as_list(new)]
        n_out[:] = [len(steps[0]) if steps else 0]
        ys = [torch.stack([s[k] for s in steps]) for k in range(n_out[0])]
        return tuple(ys) + tuple(states)

    res = _nds(_call(run, data_list + states0))
    outs, states = res[:n_out[0]], res[n_out[0]:]
    return (outs[0] if len(outs) == 1 else outs), states


def while_loop(cond, func, loop_vars, max_iterations=None):
    """Run ``func(*vars) -> (step_output, new_vars)`` while
    ``cond(*vars)`` holds, at most ``max_iterations`` times (reference
    :73); returns (step outputs stacked to ``max_iterations`` rows, or
    ``[]``, and the final variables)."""
    lvars = _as_list(loop_vars)
    n_out = []

    def step(vals):
        out, new = func(*_nds(vals))
        out = [] if out is None else [_t(o) for o in _as_list(out)]
        return out, [_t(v) for v in _as_list(new)]

    def need_bound(outs):
        n_out[:] = [len(outs)]
        if outs and max_iterations is None:
            raise MXNetError("while_loop with step outputs requires "
                             "max_iterations (static shapes)")

    def masked(vals):
        active = torch.ones((), dtype=torch.bool, device=vals[0].device)
        rows = []
        for _ in range(max_iterations):
            c = _t(cond(*_nds(vals))).to(torch.bool).reshape(())
            out, new = step(vals)
            active = active & c
            rows.append([torch.where(active, o, torch.zeros_like(o))
                         for o in out])
            vals = [torch.where(active, v, old) for v, old in zip(new, vals)]
        return rows, vals

    def run(*vals):
        vals = list(vals)
        if _capturing(vals):
            if max_iterations is None:
                raise MXNetError(
                    "while_loop without max_iterations cannot run inside a "
                    "CUDA graph capture: its trip count depends on data "
                    "that the capture may not read back; give "
                    "max_iterations (the masked form) or call it outside "
                    "the hybridized block")
            rows, vals = masked(vals)
            need_bound(rows[0] if rows else [])
        else:
            rows = []
            while (max_iterations is None or len(rows) < max_iterations) \
                    and bool(_t(cond(*_nds(vals)))):
                out, vals = step(vals)
                need_bound(out)
                rows.append(out)
            if not rows:
                with _ag.pause():    # the shapes of the step outputs
                    out, _ = step(vals)
                need_bound(out)
                rows = [[torch.zeros_like(o) for o in out]] * \
                    (max_iterations if out else 0)
            elif n_out[0]:
                zeros = [torch.zeros_like(o) for o in rows[0]]
                rows = rows + [zeros] * (max_iterations - len(rows))
        ys = [torch.stack([r[k] for r in rows]) for k in range(n_out[0])]
        return tuple(ys) + tuple(vals)

    res = _nds(_call(run, lvars))
    outs, finals = res[:n_out[0]], res[n_out[0]:]
    if not outs:
        return [], finals
    return (outs[0] if len(outs) == 1 else outs), finals


def cond(pred, then_func, else_func, inputs=None):
    """``then_func(*inputs)`` if ``pred`` else ``else_func(*inputs)``
    (reference :145); without ``inputs`` the branches are thunks over their
    captures (which get no gradients)."""
    ins = _as_list(inputs) if inputs is not None else []
    dev = next((_t(x).device for x in ins
                if isinstance(x, (NDArray, torch.Tensor))), None)
    p = pred if isinstance(pred, (NDArray, torch.Tensor)) else \
        torch.as_tensor(bool(pred), device=dev or resolve_device(None))

    def branch(fn, args):
        out = fn(*_nds(args)) if ins else fn()
        return [_t(o) for o in _as_list(out)]

    def run(p, *args):
        if _capturing([p, *args]):
            take = p.to(torch.bool).reshape(())
            return tuple(torch.where(take, a, b) for a, b in
                         zip(branch(then_func, args),
                             branch(else_func, args)))
        return tuple(branch(then_func if bool(p) else else_func, args))

    res = _nds(_call(run, [p] + ins))
    return res[0] if len(res) == 1 else res


# -- the registered control-flow ops (reference npi_manip.py:186-215) ------
@register("_foreach")
def _foreach_op(body=None, num_states=0, **a):
    def f(data, *states):
        outs, st = foreach(body, NDArray(data), _nds(states))
        return tuple(o._data for o in _as_list(outs)) + \
            tuple(s._data for s in _as_list(st))

    return f


@register("_while_loop")
def _while_loop_op(cond=None, func=None, max_iterations=None, **a):
    def f(*loop_vars):
        outs, final = while_loop(cond, func, _nds(loop_vars),
                                 max_iterations=max_iterations)
        return tuple(o._data for o in _as_list(outs)) + \
            tuple(s._data for s in _as_list(final))

    return f


@register("_cond")
def _cond_op(then_func=None, else_func=None, **a):
    def f(pred, *inputs):
        out = cond(NDArray(pred), then_func, else_func, _nds(inputs))
        if isinstance(out, (list, tuple)):
            return tuple(o._data for o in out)
        return out._data

    return f
