"""Seeded random generators and the samplers of the port (``mx.random``,
``mx.np.random``).

Counterpart of ``mxnet_tpu/random.py``. The reference keeps one
process-global key, seeded by ``seed(n)`` and split on every draw. The port
keeps one ``torch.Generator`` per device, each seeded with the same ``n``
when it is made and again by every ``seed(n)``; every draw of the port
(dropout, the samplers here and the registered sampler ops of
:mod:`mxnet_tpu_torch.ops.random_ops`) passes the generator of its device
(:func:`generator`) explicitly, never torch's global one. ``host_rng``, a
numpy ``RandomState`` for host-side data pipelines, is seeded with them.
The two packages draw different numbers from one seed, so a test that
needs the same noise in both makes it with numpy; the samplers follow the
reference's distributions, supports, shapes and dtypes.

Scalar-parameter draws go through the registered sampler ops, as the
reference's ``_via_op`` routes them (``_npi_uniform``, ``_random_randint``,
...); tensor parameters draw here directly, as the reference's
``jax.random`` path does. A sampler without tensor operands draws on
``device``/``ctx``, else on the current context.

A CUDA graph whose capture moved a generator registers it
(``CUDAGraph.register_generator_state``; ``cached_op.GraphPool``), standing
in for the reference's fresh key a call (``mxnet_tpu/random.py:82-91``):
every replay of a captured step or hybridized block draws fresh numbers,
and ``seed(n)`` resets what the next replay draws.
"""
from __future__ import annotations

import math
import threading

import numpy as onp
import torch

__all__ = ["seed", "uniform", "normal", "randint", "randn", "rand",
           "geometric", "binomial",
           "choice", "shuffle", "permutation", "multinomial", "bernoulli",
           "gamma", "beta", "exponential", "poisson", "laplace", "gumbel",
           "logistic", "pareto", "power", "rayleigh", "weibull", "chisquare",
           "lognormal", "multivariate_normal", "categorical", "generator",
           "host_rng"]

_lock = threading.Lock()
_seed = 0
_gens = {}

# host-side generator for data pipelines, seeded with the device ones
# (reference :33)
host_rng = onp.random.RandomState(0)


def seed(seed_state: int):
    """Re-seed every device's generator and ``host_rng`` (reference:
    ``mx.random.seed``)."""
    global _seed
    with _lock:
        _seed = int(seed_state)
        for gen in _gens.values():
            gen.manual_seed(_seed)
        host_rng.seed(_seed & 0x7FFFFFFF)


def generator(device) -> torch.Generator:
    """The generator of ``device`` (a ``torch.device`` or its name), made
    on first use from the current seed."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _lock:
        gen = _gens.get(dev)
        if gen is None:
            gen = _gens[dev] = torch.Generator(device=dev)
            gen.manual_seed(_seed)
    return gen


# -- helpers ----------------------------------------------------------------
def _nd():
    from .ndarray.ndarray import NDArray

    return NDArray


def _shape(size):
    if size is None:
        return ()
    if isinstance(size, int):
        return (size,)
    return tuple(int(s) for s in size)


def _is_array(p):
    return hasattr(p, "shape")


def _f(dtype):
    """The float dtype of a draw (reference :263): float64 narrows to
    float32, as x64-off JAX."""
    return {"float16": torch.float16,
            "bfloat16": torch.bfloat16}.get(str(dtype), torch.float32)


def _device(ctx, *params):
    """``ctx`` as a device when given, else the first tensor parameter's
    device, else the current context's."""
    from .context import resolve_device

    if ctx is not None:
        return resolve_device(ctx)
    for p in params:
        if isinstance(p, _nd()):
            return p._data.device
        if isinstance(p, torch.Tensor):
            return p.device
    return resolve_device(None)


def _tensor(p, dev, dtype=torch.float32):
    if isinstance(p, _nd()):
        p = p._data
    return torch.as_tensor(onp.asarray(p) if isinstance(p, (list, tuple))
                           else p, device=dev).to(dtype)


def _wrap(data, out=None):
    from .base import narrow

    arr = _nd()(narrow(data))
    if out is not None:
        out._set_data(arr._data)
        return out
    return arr


def _via_op(op_name, ctx=None, out=None, **attrs):
    """Draw through the registered sampler op (``ops/random_ops.py``) on
    ``ctx`` (reference :75): inside a hybridized block's program the draw
    is one of its operations, and the generator registered with the graph
    makes every replay draw anew."""
    from .ops.registry import apply_op

    return apply_op(op_name, ctx=str(_device(ctx)), out=out, **attrs)


# -- samplers (reference :104-323) -------------------------------------------
def uniform(low=0.0, high=1.0, size=None, dtype="float32", ctx=None,
            device=None, out=None):
    if not (_is_array(low) or _is_array(high)):
        return _via_op("_npi_uniform", ctx=device or ctx, out=out,
                       low=low, high=high, size=_shape(size),
                       dtype=str(dtype))
    dev = _device(device or ctx, low, high)
    lo, hi = _tensor(low, dev), _tensor(high, dev)
    shape = _shape(size) or torch.broadcast_shapes(lo.shape, hi.shape)
    u = torch.rand(shape, generator=generator(dev), device=dev)
    return _wrap(torch.maximum(lo, u * (hi - lo) + lo).to(_f(dtype)), out)


def normal(loc=0.0, scale=1.0, size=None, dtype="float32", ctx=None,
           device=None, out=None):
    if not (_is_array(loc) or _is_array(scale)):
        return _via_op("_npi_normal", ctx=device or ctx, out=out,
                       loc=loc, scale=scale, size=_shape(size),
                       dtype=str(dtype))
    dev = _device(device or ctx, loc, scale)
    lo, sc = _tensor(loc, dev), _tensor(scale, dev)
    shape = _shape(size) or torch.broadcast_shapes(lo.shape, sc.shape)
    z = torch.randn(shape, generator=generator(dev), device=dev)
    return _wrap((z * sc + lo).to(_f(dtype)), out)


def lognormal(mean=0.0, sigma=1.0, size=None, dtype="float32", ctx=None,
              out=None):
    dev = _device(ctx, mean, sigma)
    z = torch.randn(_shape(size), generator=generator(dev), device=dev)
    data = torch.exp(z * _tensor(sigma, dev) + _tensor(mean, dev))
    return _wrap(data.to(_f(dtype)), out)


def randn(*size, dtype="float32", ctx=None):
    return normal(0.0, 1.0, size or None, dtype, ctx)


def rand(*size, dtype="float32", ctx=None):
    return uniform(0.0, 1.0, size or None, dtype, ctx)


def randint(low, high=None, size=None, dtype="int32", ctx=None, device=None,
            out=None):
    if high is None:
        low, high = 0, low
    dt = "int32" if str(dtype) in ("int64", "int32", "int") else str(dtype)
    return _via_op("_random_randint", ctx=device or ctx, out=out,
                   low=int(low), high=int(high), shape=_shape(size),
                   dtype=dt)


def bernoulli(prob=0.5, size=None, dtype="float32", ctx=None):
    if not _is_array(prob):
        return _via_op("_npi_bernoulli", ctx=ctx, prob=prob,
                       size=_shape(size), dtype=str(dtype))
    dev = _device(ctx, prob)
    p = _tensor(prob, dev)
    shape = _shape(size) or tuple(p.shape)
    hit = torch.rand(shape, generator=generator(dev), device=dev) < p
    dt = _f(dtype) if "float" in str(dtype) else _dtype(dtype)
    return _wrap(hit.to(dt))


def _dtype(dtype):
    from .base import canonical_dtype

    return canonical_dtype(dtype)


def choice(a, size=None, replace=True, p=None, ctx=None, out=None):
    """``size`` draws from ``a`` (an array: its rows) or from ``range(a)``
    (an int), through the ``_npi_choice`` op (reference :197)."""
    from .ops.registry import apply_op

    arr = a if _is_array(a) else None
    n = int(arr.shape[0]) if arr is not None else int(a)
    dev = _device(ctx, *([arr] if arr is not None else []))
    operands = [] if p is None else [_tensor(p, dev)]
    idx = apply_op("_npi_choice", *operands, a=n, size=_shape(size),
                   replace=bool(replace), ctx=str(dev))
    if arr is None:
        return _wrap(idx._data, out)
    return _wrap(_tensor(arr, dev, _tensor_dtype(arr))[idx._data.long()],
                 out)


def _tensor_dtype(x):
    return x._data.dtype if isinstance(x, _nd()) else \
        torch.as_tensor(onp.asarray(x)).dtype


def permutation(x, ctx=None):
    """A permutation of ``range(x)`` (an int) or of ``x``'s rows."""
    dev = _device(ctx, x)
    gen = generator(dev)
    if not _is_array(x):
        return _wrap(torch.randperm(int(x), generator=gen, device=dev)
                     .to(torch.int32))
    t = _tensor(x, dev, _tensor_dtype(x))
    return _wrap(t[torch.randperm(t.shape[0], generator=gen, device=dev)])


def shuffle(x):
    """Shuffle ``x`` along its first axis, in place (reference :211)."""
    from .ops.registry import apply_op

    x._set_data(apply_op("_shuffle", x)._data)
    return x


def multinomial(n=1, pvals=None, size=None, ctx=None):
    """Per-category counts of ``n`` draws from ``pvals``, shape ``size +
    (len(pvals),)``, int32 (reference :217), through
    ``_npi_multinomial``."""
    from .ops.registry import apply_op

    dev = _device(ctx, pvals)
    return apply_op("_npi_multinomial", _tensor(pvals, dev), n=int(n),
                    size=_shape(size))


def categorical(logits, size=None, ctx=None):
    """Category indices drawn from ``logits`` along the last axis, by the
    Gumbel-max rule (reference :226); ``size`` must end with the logits'
    batch shape."""
    from .ops.random_ops import _gumbel

    dev = _device(ctx, logits)
    lg = _tensor(logits, dev)
    shape = _shape(size) if size is not None else tuple(lg.shape[:-1])
    g = _gumbel(generator(dev), shape + (lg.shape[-1],), dev)
    return _wrap(torch.argmax(lg + g, dim=-1).to(torch.int32))


# scalar-parameter draws route through the registered sampler ops
# (reference :235); tensor parameters draw directly below
_OP_ROUTE = {
    "exponential": lambda p: ("_npi_exponential",
                              {"scale": p[0] if p else 1.0}),
    "gamma": lambda p: ("_npi_gamma",
                        {"shape": p[0] if p else 1.0,
                         "scale": p[1] if len(p) > 1 else 1.0}),
    "laplace": lambda p: ("_npi_laplace",
                          {"loc": p[0] if p else 0.0,
                           "scale": p[1] if len(p) > 1 else 1.0}),
    "gumbel": lambda p: ("_npi_gumbel",
                         {"loc": p[0] if p else 0.0,
                          "scale": p[1] if len(p) > 1 else 1.0}),
    "logistic": lambda p: ("_npi_logistic",
                           {"loc": p[0] if p else 0.0,
                            "scale": p[1] if len(p) > 1 else 1.0}),
    "rayleigh": lambda p: ("_npi_rayleigh", {"scale": p[0] if p else 1.0}),
    "weibull": lambda p: ("_npi_weibull", {"a": p[0] if p else 1.0}),
}


def _direct(name, params, shape, dev):
    """The draw of sampler ``name`` with tensor parameters ``params`` (the
    reference's ``jax.random`` path, :262-300): float32 values (int32 for
    ``poisson``)."""
    from .ops.random_ops import _gamma, _gumbel, _laplace, _logistic

    gen = generator(dev)
    ps = [_tensor(p, dev) for p in params]
    first = tuple(ps[0].shape) if ps else ()

    def u(sh):
        return torch.rand(sh, generator=gen, device=dev)

    def expo(sh):
        return torch.empty(sh, device=dev).exponential_(1.0, generator=gen)

    if name == "gamma":
        sh = shape or first
        data = _gamma(gen, ps[0], sh, dev)
        return data * ps[1] if len(ps) > 1 else data
    if name == "beta":
        sh = shape or tuple(torch.broadcast_shapes(ps[0].shape, ps[1].shape))
        x = _gamma(gen, ps[0], sh, dev)
        y = _gamma(gen, ps[1], sh, dev)
        return x / (x + y)
    if name == "exponential":
        data = expo(shape)
        return data * ps[0] if ps else data
    if name == "poisson":
        lam = ps[0] if ps else torch.tensor(1.0, device=dev)
        sh = shape or tuple(lam.shape)
        return torch.poisson(lam.expand(sh).contiguous(),
                             generator=gen).to(torch.int32)
    if name == "pareto":        # jax.random.pareto: support [1, inf)
        return torch.exp(expo(shape or first) / ps[0])
    if name == "chisquare":
        sh = shape or first
        return 2.0 * _gamma(gen, ps[0] / 2.0, sh, dev)
    if name == "rayleigh":
        data = torch.sqrt(-2.0 * torch.log(u(shape).clamp_min(1e-7)))
        return data * ps[0] if ps else data
    if name == "weibull":
        a = ps[0] if ps else torch.tensor(1.0, device=dev)
        return torch.pow(-torch.log(u(shape).clamp_min(1e-7)), 1.0 / a)
    draw = {"laplace": _laplace, "gumbel": _gumbel, "logistic": _logistic}
    data = draw[name](gen, shape, dev)
    if ps:
        scale = ps[1] if len(ps) > 1 else 1.0
        data = data * scale + ps[0]
    return data


def _simple(fn_name):
    def sampler(*params, size=None, dtype="float32", ctx=None, out=None,
                **kw):
        if fn_name in _OP_ROUTE and not any(_is_array(p) for p in params):
            op_name, attrs = _OP_ROUTE[fn_name](params)
            return _via_op(op_name, ctx=ctx, out=out, size=_shape(size),
                           dtype=str(dtype), **attrs)
        dev = _device(ctx, *params)
        data = _direct(fn_name, params, _shape(size), dev)
        if data.is_floating_point():
            data = data.to(_f(dtype))
        return _wrap(data, out)

    sampler.__name__ = fn_name
    return sampler


gamma = _simple("gamma")
beta = _simple("beta")
exponential = _simple("exponential")
poisson = _simple("poisson")
laplace = _simple("laplace")
gumbel = _simple("gumbel")
logistic = _simple("logistic")
pareto = _simple("pareto")
rayleigh = _simple("rayleigh")
weibull = _simple("weibull")
chisquare = _simple("chisquare")


def power(a, size=None, ctx=None):
    dev = _device(ctx, a)
    v = torch.rand(_shape(size), generator=generator(dev), device=dev)
    return _wrap(v ** (1.0 / _tensor(a, dev)))


def multivariate_normal(mean, cov, size=None, ctx=None):
    """Draws ``mean + L z`` with ``L`` the Cholesky factor of ``cov``
    (jax.random.multivariate_normal's default), shape ``size + (n,)``."""
    dev = _device(ctx, mean, cov)
    m, c = _tensor(mean, dev), _tensor(cov, dev)
    shape = _shape(size) or tuple(m.shape[:-1])
    z = torch.randn(shape + (m.shape[-1],), generator=generator(dev),
                    device=dev)
    low = torch.linalg.cholesky(c)
    return _wrap(m + z @ low.transpose(-1, -2))


def geometric(p=0.5, size=None, ctx=None):
    """Bernoulli(p) trials to the first success, support {1, 2, ...},
    int32 (reference :307)."""
    dev = _device(ctx, p)
    v = torch.rand(_shape(size), generator=generator(dev),
                   device=dev).clamp_min(1e-12)
    data = torch.ceil(torch.log(v) / math.log1p(-float(p))) \
        if not _is_array(p) else \
        torch.ceil(torch.log(v) / torch.log1p(-_tensor(p, dev)))
    return _wrap(torch.clamp_min(data.to(torch.int32), 1))


def binomial(n=1, p=0.5, size=None, ctx=None):
    """Successes in ``n`` Bernoulli(p) trials, float32 as the reference's
    (:315)."""
    dev = _device(ctx, n, p)
    cnt, pr = _tensor(n, dev), _tensor(p, dev)
    shape = _shape(size) or tuple(torch.broadcast_shapes(cnt.shape,
                                                         pr.shape))
    return _wrap(torch.binomial(cnt.expand(shape).contiguous(),
                                pr.expand(shape).contiguous(),
                                generator=generator(dev)))
