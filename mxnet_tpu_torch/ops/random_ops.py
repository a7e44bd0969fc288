"""Random-sampling operators of the port: registry ops with a generator operand.

Counterpart of ``mxnet_tpu/ops/random_ops.py``, under the reference's names:

- ``_random_*``: shape and attribute samplers (reference :43-77);
- ``_sample_*``: parameter tensors of shape ``(B,)`` with ``shape=(S,)``
  give ``(B, S)`` draws (:104-187); the reference's row-wise samplers are
  vectorised here, each parameter broadcast over its row's draws;
- ``_npi_*``: the numpy.random internals (:206-318), with
  ``_npi_multinomial``, ``_npi_choice`` and the ``_n`` variants;
- ``_shuffle`` (:223).

Every sampler is registered ``needs_rng=True``: :func:`~.registry.invoke`
passes the ``torch.Generator`` of the operands' device
(:func:`mxnet_tpu_torch.random.generator`) as the function's first
argument, and the function draws from it alone (``generator=``), never from
torch's global generator. A sampler without tensor operands draws on the
device its ``ctx`` attribute names (the current context when None). The
reference gives each call a fresh key, so a compiled program redraws on
every replay; the port gets the same effect by registering the generator
with every CUDA graph whose capture moved it (``cached_op.GraphPool``).

The two packages draw different numbers from one seed: the samplers follow
the reference's distributions, supports, shapes and dtypes (64-bit dtypes
narrowed to 32-bit, as x64-off JAX), not its values.
"""
from __future__ import annotations

import math

import torch

from ..base import canonical_dtype
from ..context import resolve_device
from .registry import register, register_alias

__all__ = ["categorical_counts"]

_TINY = 1e-7     # the reference's lower bound of U in log(U) (:291, :299)


def _dt(dtype, default=torch.float32):
    if dtype in (None, "None"):
        return default
    return canonical_dtype(dtype)


def _shp(shape):
    if shape is None:
        return ()
    return (int(shape),) if isinstance(shape, int) else \
        tuple(int(s) for s in shape)


def _dev(ctx):
    return resolve_device(ctx)


def _rand(gen, shape, dev, dtype=torch.float32, low=0.0, high=1.0):
    """U[low, high) of ``shape``, drawn in float32 and cast."""
    u = torch.rand(shape, generator=gen, device=dev, dtype=torch.float32)
    if (low, high) != (0.0, 1.0):
        u = u * (high - low) + low
    return u.to(dtype)


def _open_rand(gen, shape, dev, low=_TINY):
    """U[low, 1): the argument of a logarithm."""
    return torch.rand(shape, generator=gen, device=dev).clamp_min(low)


def _gamma(gen, alpha, shape, dev):
    """Gamma(alpha, 1) of ``shape`` (``alpha`` a number or a tensor that
    broadcasts to it)."""
    a = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
    return torch._standard_gamma(a.expand(shape).contiguous(), generator=gen)


def _poisson(gen, lam, shape, dev):
    lam = torch.as_tensor(lam, dtype=torch.float32, device=dev)
    return torch.poisson(lam.expand(shape).contiguous(), generator=gen)


def _neg_binomial(gen, k, p, shape, dev):
    """NB(k, p) as the Gamma-Poisson mixture (reference :84)."""
    return _poisson(gen, _gamma(gen, k, shape, dev) * (1.0 - p) / p, shape,
                    dev)


def _gen_neg_binomial(gen, mu, alpha, shape, dev):
    """The generalized negative binomial (reference :93)."""
    lam = _gamma(gen, 1.0 / alpha, shape, dev) * (mu * alpha)
    return _poisson(gen, lam, shape, dev)


# ---------------------------------------------------------------------------
# shape and attribute samplers (reference :43-77)
# ---------------------------------------------------------------------------
def _attr_sampler(draw):
    """A ``_random_*`` factory: ``draw(gen, shape, device, dtype, **attrs)``
    makes the values."""
    def make(shape=(), dtype="float32", ctx=None, **attrs):
        s, dt = _shp(shape), _dt(dtype)

        def f(gen):
            return draw(gen, s, _dev(ctx), dt, **attrs)

        return f

    return make


register("_random_uniform", _attr_sampler(
    lambda g, s, d, dt, low=0.0, high=1.0: _rand(g, s, d, dt, low, high)),
    needs_rng=True, differentiable=False)
register("_random_normal", _attr_sampler(
    lambda g, s, d, dt, loc=0.0, scale=1.0:
    (loc + scale * torch.randn(s, generator=g, device=d)).to(dt)),
    needs_rng=True, differentiable=False)
register("_random_gamma", _attr_sampler(
    lambda g, s, d, dt, alpha=1.0, beta=1.0:
    (beta * _gamma(g, alpha, s, d)).to(dt)),
    needs_rng=True, differentiable=False)
register("_random_exponential", _attr_sampler(
    lambda g, s, d, dt, lam=1.0:
    (torch.empty(s, device=d).exponential_(1.0, generator=g) / lam).to(dt)),
    needs_rng=True, differentiable=False)
register("_random_poisson", _attr_sampler(
    lambda g, s, d, dt, lam=1.0: _poisson(g, lam, s, d).to(dt)),
    needs_rng=True, differentiable=False)
register("_random_negative_binomial", _attr_sampler(
    lambda g, s, d, dt, k=1, p=1.0: _neg_binomial(g, k, p, s, d).to(dt)),
    needs_rng=True, differentiable=False)
register("_random_generalized_negative_binomial", _attr_sampler(
    lambda g, s, d, dt, mu=1.0, alpha=1.0:
    _gen_neg_binomial(g, mu, alpha, s, d).to(dt)),
    needs_rng=True, differentiable=False)


@register("_random_randint", needs_rng=True, differentiable=False)
def _random_randint(low=0, high=1, shape=(), dtype="int32", ctx=None, **a):
    s, dt = _shp(shape), _dt(dtype, torch.int32)

    def f(gen):
        return torch.randint(int(low), int(high), s, generator=gen,
                             device=_dev(ctx), dtype=dt)

    return f


# ---------------------------------------------------------------------------
# per-row parameter samplers (reference :104-187): params are tensor inputs
# ---------------------------------------------------------------------------
def _rowwise(draw, nparam):
    def make(shape=(), dtype="float32", **a):
        s, dt = _shp(shape), _dt(dtype)

        def f(gen, *params):
            if len(params) != nparam:
                raise ValueError(
                    f"sampler expects {nparam} parameter tensor(s), got "
                    f"{len(params)}")
            out_shape = tuple(params[0].shape) + s
            broad = [p.float().reshape(tuple(p.shape) + (1,) * len(s))
                     .expand(out_shape) for p in params]
            return draw(gen, broad, out_shape, params[0].device).to(dt)

        return f

    return make


register("_sample_uniform", _rowwise(
    lambda g, p, sh, d: _rand(g, sh, d) * (p[1] - p[0]) + p[0], 2),
    needs_rng=True, differentiable=False)
register("_sample_normal", _rowwise(
    lambda g, p, sh, d: p[0] + p[1] * torch.randn(sh, generator=g, device=d),
    2), needs_rng=True, differentiable=False)
register("_sample_gamma", _rowwise(
    lambda g, p, sh, d: p[1] * _gamma(g, p[0], sh, d), 2),
    needs_rng=True, differentiable=False)
register("_sample_exponential", _rowwise(
    lambda g, p, sh, d:
    torch.empty(sh, device=d).exponential_(1.0, generator=g) / p[0], 1),
    needs_rng=True, differentiable=False)
register("_sample_poisson", _rowwise(
    lambda g, p, sh, d: _poisson(g, p[0], sh, d), 1),
    needs_rng=True, differentiable=False)
register("_sample_negative_binomial", _rowwise(
    lambda g, p, sh, d: _neg_binomial(g, p[0], p[1], sh, d), 2),
    needs_rng=True, differentiable=False)
register("_sample_generalized_negative_binomial", _rowwise(
    lambda g, p, sh, d: _gen_neg_binomial(g, p[0], p[1], sh, d), 2),
    needs_rng=True, differentiable=False)


@register("_sample_multinomial", needs_rng=True, differentiable=False)
def _sample_multinomial(shape=(), get_prob=False, dtype="int32", **a):
    """Rows of ``data`` are probability vectors; ``shape`` category indices
    a row (reference :159); with ``get_prob`` also each draw's
    log-probability, the log of the clipped, unnormalised entry as in the
    reference."""
    s, dt = _shp(shape), _dt(dtype, torch.int32)

    def f(gen, probs):
        batch, ncat = tuple(probs.shape[:-1]), probs.shape[-1]
        n = math.prod(s)
        rows = probs.float().reshape(-1, ncat).clamp_min(1e-30)
        idx = torch.multinomial(rows, n, replacement=True, generator=gen)
        out = idx.reshape(batch + s)
        if not get_prob:
            return out.to(dt)
        lp = torch.log(rows).gather(1, idx).reshape(batch + s)
        return out.to(dt), lp

    return f


def categorical_counts(gen, pv, n, shape):
    """``n`` categorical draws from the 1-D probabilities ``pv`` counted per
    category: int32 counts of shape ``shape + (len(pv),)`` (reference
    :190); shared by ``_npi_multinomial`` and ``random.multinomial``."""
    ncat = pv.shape[-1]
    rows = math.prod(shape)
    p = pv.float().clamp_min(1e-30)
    draws = torch.multinomial(p, rows * n, replacement=True,
                              generator=gen).reshape(rows, n)
    counts = torch.zeros(rows, ncat, dtype=torch.int32, device=pv.device)
    counts.scatter_add_(1, draws, torch.ones_like(draws, dtype=torch.int32))
    return counts.reshape(tuple(shape) + (ncat,))


@register("_npi_multinomial", needs_rng=True, differentiable=False)
def _npi_multinomial(n=1, pvals=None, size=None, ctx=None, **a):
    """numpy.random.multinomial (reference :208): per-category counts of
    ``n`` draws, shape ``size + (num_categories,)``; the probabilities an
    attribute or a tensor operand."""
    s, n = _shp(size), int(n)
    if pvals is not None:
        host = torch.tensor(pvals, dtype=torch.float32)
        return lambda gen: categorical_counts(gen, host.to(_dev(ctx)), n, s)
    return lambda gen, pv: categorical_counts(gen, pv, n, s)


@register("_shuffle", needs_rng=True, differentiable=False)
def _shuffle(**a):
    """A permutation of ``x`` along its first axis (reference :223)."""
    def f(gen, x):
        perm = torch.randperm(x.shape[0], generator=gen, device=x.device)
        return x[perm]

    return f


register_alias("shuffle", "_shuffle")


# ---------------------------------------------------------------------------
# numpy.random internals (reference :233-318)
# ---------------------------------------------------------------------------
def _npi(draw):
    """An ``_npi_*`` factory over attributes: ``draw(gen, size, device,
    **attrs)`` gives float32 values, cast to ``dtype``."""
    def make(size=None, dtype="float32", ctx=None, **attrs):
        s, dt = _shp(size), _dt(dtype)

        def f(gen):
            return draw(gen, s, _dev(ctx), **attrs).to(dt)

        return f

    return make


def _laplace(g, s, d):
    """The standard Laplace by the reference's inverse CDF over (-1, 1)."""
    u = torch.rand(s, generator=g, device=d) * 2.0 - 1.0
    u = u.clamp_min(-1.0 + 2 ** -24)
    return torch.sign(u) * torch.log1p(-u.abs())


def _gumbel(g, s, d):
    return -torch.log(-torch.log(_open_rand(g, s, d, 1.1754944e-38)))


def _logistic(g, s, d):
    u = _open_rand(g, s, d, 1.1754944e-38)
    return torch.log(u) - torch.log1p(-u)


register("_npi_uniform", _npi(
    lambda g, s, d, low=0.0, high=1.0, **a: _rand(g, s, d, torch.float32,
                                                  low, high)),
    needs_rng=True, differentiable=False)
register("_npi_normal", _npi(
    lambda g, s, d, loc=0.0, scale=1.0, **a:
    loc + scale * torch.randn(s, generator=g, device=d)),
    needs_rng=True, differentiable=False)


@register("_npi_bernoulli", needs_rng=True, differentiable=False)
def _npi_bernoulli(prob=0.5, logit=None, size=None, dtype="float32",
                   is_logit=False, ctx=None, **a):
    s, dt = _shp(size), _dt(dtype)
    p = 1.0 / (1.0 + math.exp(-logit)) if is_logit else prob

    def f(gen):
        return (torch.rand(s, generator=gen, device=_dev(ctx)) < p).to(dt)

    return f


register("_npi_exponential", _npi(
    lambda g, s, d, scale=1.0, **a:
    scale * torch.empty(s, device=d).exponential_(1.0, generator=g)),
    needs_rng=True, differentiable=False)
register("_npi_gumbel", _npi(
    lambda g, s, d, loc=0.0, scale=1.0, **a: loc + scale * _gumbel(g, s, d)),
    needs_rng=True, differentiable=False)
register("_npi_laplace", _npi(
    lambda g, s, d, loc=0.0, scale=1.0, **a:
    loc + scale * _laplace(g, s, d)),
    needs_rng=True, differentiable=False)
register("_npi_logistic", _npi(
    lambda g, s, d, loc=0.0, scale=1.0, **a:
    loc + scale * _logistic(g, s, d)),
    needs_rng=True, differentiable=False)
# numpy's pareto is the Lomax: exp(E / a) - 1, support [0, inf)
register("_npi_pareto", _npi(
    lambda g, s, d, a=1.0, **kw:
    torch.exp(torch.empty(s, device=d).exponential_(1.0, generator=g) / a)
    - 1.0), needs_rng=True, differentiable=False)
register("_npi_rayleigh", _npi(
    lambda g, s, d, scale=1.0, **a:
    scale * torch.sqrt(-2.0 * torch.log(_open_rand(g, s, d)))),
    needs_rng=True, differentiable=False)
register("_npi_weibull", _npi(
    lambda g, s, d, a=1.0, **kw:
    torch.pow(-torch.log(_open_rand(g, s, d)), 1.0 / a)),
    needs_rng=True, differentiable=False)


@register("_npi_gamma", needs_rng=True, differentiable=False)
def _npi_gamma(shape=1.0, scale=1.0, size=None, ctx=None, dtype="float32",
               **a):
    s, dt = _shp(size), _dt(dtype)
    return lambda gen: (scale * _gamma(gen, shape, s, _dev(ctx))).to(dt)


@register("_npi_choice", needs_rng=True, differentiable=False)
def _npi_choice(a=1, size=None, replace=True, weights=None, ctx=None, **kw):
    """``size`` draws from ``range(a)`` (reference :300), with or without
    replacement, uniform or by the probabilities of a tensor operand."""
    s, a = _shp(size), int(a)
    n = math.prod(s)

    def f(gen, *p):
        dev = p[0].device if p else _dev(ctx)
        if not replace and n > a:
            raise ValueError(f"cannot take {n} samples from {a} without "
                             "replacement")
        if p:
            idx = torch.multinomial(p[0].float(), n, replacement=replace,
                                    generator=gen)
        elif replace:
            idx = torch.randint(0, a, (n,), generator=gen, device=dev)
        else:
            idx = torch.randperm(a, generator=gen, device=dev)[:n]
        return idx.to(torch.int32).reshape(s)

    return f


def _param_n(gen, tensor_params, attr_params, size, dev, dtype, draw):
    """``*_n`` variants (reference :311): parameters may arrive as
    tensors; the output shape is ``size`` + the parameters' broadcast
    shape."""
    p = list(tensor_params) + list(attr_params[len(tensor_params):])
    a0 = torch.as_tensor(p[0], dtype=torch.float32, device=dev)
    a1 = torch.as_tensor(p[1], dtype=torch.float32, device=dev)
    bshape = torch.broadcast_shapes(a0.shape, a1.shape)
    return draw(gen, a0, a1, tuple(size) + tuple(bshape), dev).to(dtype)


def _npi_n(draw, names):
    def make(size=None, dtype="float32", ctx=None, **attrs):
        s, dt = _shp(size), _dt(dtype)
        defaults = tuple(attrs.get(n, v) for n, v in names)

        def f(gen, *p):
            dev = p[0].device if p else _dev(ctx)
            return _param_n(gen, p, defaults, s, dev, dt, draw)

        return f

    return make


register("_npi_normal_n", _npi_n(
    lambda g, lo, sc, sh, d: lo + sc * torch.randn(sh, generator=g,
                                                   device=d),
    (("loc", 0.0), ("scale", 1.0))), needs_rng=True, differentiable=False)
register("_npi_uniform_n", _npi_n(
    lambda g, lo, hi, sh, d: _rand(g, sh, d) * (hi - lo) + lo,
    (("low", 0.0), ("high", 1.0))), needs_rng=True, differentiable=False)
