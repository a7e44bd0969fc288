"""PyTorch/CUDA port: ``mx.random`` / ``mx.np.random`` and the registered
sampler ops against the JAX package's, on the CPU.

The two packages draw different numbers from one seed (a JAX key against a
``torch.Generator``), so each sampler is held to the reference's
semantics, not its values:

- shape and dtype equal to the reference's for the same call (64-bit
  dtypes narrowed to 32-bit, as x64-off JAX), the reference's taken by
  JAX's abstract evaluation of the call (``jax.eval_shape``: the same
  program, traced and not compiled);
- its support (integers in range, values in the distribution's interval);
- mean and variance of n = 10^5 draws against the distribution's: the
  mean within 6 standard errors (sqrt(var / n)) and the variance within 5 %
  (a few standard errors of the sample variance at these kurtoses; 15 % for
  the Pareto, whose kurtosis is 74);
- ``seed(n)`` reproducible, and another seed different;
- a sampler inside a hybridized block draws anew on every call (on the
  card: on every replay of the captured graph, through the generator
  registered with it).

The JAX package is imported inside the tests, so ``pytest --noconftest
tests/test_torch_random.py -m cuda`` collects this file without JAX.
"""
import math

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.base import dtype_name
from mxnet_tpu_torch.gluon import HybridBlock
from mxnet_tpu_torch.ops.registry import apply_op

N = 100_000
SE = 6.0            # the mean within this many standard errors
VAR_TOL = 0.05      # the variance within this share
EULER = 0.5772156649015329


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _host(a):
    return onp.asarray(a.asnumpy(), dtype="float64")


def _ref(draw):
    """Shape and dtype of the reference's NDArray that ``draw()`` returns,
    by JAX's abstract evaluation (the same program, not compiled). The
    trace splits the reference's global key into a tracer, so the key is
    put back after it: a later draw in the same process would meet the
    escaped tracer."""
    import jax
    from mxnet_tpu import random as jrandom

    key = jrandom._key
    try:
        return jax.eval_shape(lambda: draw()._data)
    finally:
        jrandom._key = key


# name: (draw(pkg.random, size), mean, variance, support check)
SAMPLERS = {
    "uniform": (lambda r, s: r.uniform(2.0, 5.0, size=s), 3.5, 0.75,
                lambda v: (v >= 2).all() and (v < 5).all()),
    "normal": (lambda r, s: r.normal(1.0, 2.0, size=s), 1.0, 4.0, None),
    "randint": (lambda r, s: r.randint(0, 10, size=s), 4.5, 8.25,
                lambda v: set(onp.unique(v)) <= set(range(10))),
    "randn": (lambda r, s: r.randn(*s), 0.0, 1.0, None),
    "rand": (lambda r, s: r.rand(*s), 0.5, 1 / 12,
             lambda v: (v >= 0).all() and (v < 1).all()),
    "geometric": (lambda r, s: r.geometric(0.3, size=s), 1 / 0.3,
                  0.7 / 0.09, lambda v: (v >= 1).all()),
    "binomial": (lambda r, s: r.binomial(10, 0.3, size=s), 3.0, 2.1,
                 lambda v: set(onp.unique(v)) <= set(range(11))),
    "choice": (lambda r, s: r.choice(10, size=s), 4.5, 8.25,
               lambda v: set(onp.unique(v)) <= set(range(10))),
    "bernoulli": (lambda r, s: r.bernoulli(0.3, size=s), 0.3, 0.21,
                  lambda v: set(onp.unique(v)) <= {0.0, 1.0}),
    "gamma": (lambda r, s: r.gamma(2.0, 1.5, size=s), 3.0, 4.5,
              lambda v: (v > 0).all()),
    "beta": (lambda r, s: r.beta(2.0, 3.0, size=s), 0.4, 0.04,
             lambda v: (v > 0).all() and (v < 1).all()),
    "exponential": (lambda r, s: r.exponential(2.0, size=s), 2.0, 4.0,
                    lambda v: (v >= 0).all()),
    "poisson": (lambda r, s: r.poisson(3.0, size=s), 3.0, 3.0,
                lambda v: (v >= 0).all() and (v == onp.round(v)).all()),
    "laplace": (lambda r, s: r.laplace(1.0, 2.0, size=s), 1.0, 8.0, None),
    "gumbel": (lambda r, s: r.gumbel(1.0, 2.0, size=s), 1.0 + 2.0 * EULER,
               math.pi ** 2 * 4 / 6, None),
    "logistic": (lambda r, s: r.logistic(1.0, 2.0, size=s), 1.0,
                 4 * math.pi ** 2 / 3, None),
    # jax.random.pareto's support [1, inf), as the reference's
    "pareto": (lambda r, s: r.pareto(5.0, size=s), 1.25, 5 / 48,
               lambda v: (v >= 1).all()),
    "power": (lambda r, s: r.power(3.0, size=s), 0.75, 3 / 80,
              lambda v: (v >= 0).all() and (v <= 1).all()),
    "rayleigh": (lambda r, s: r.rayleigh(2.0, size=s),
                 2.0 * math.sqrt(math.pi / 2), (4 - math.pi) / 2 * 4,
                 lambda v: (v >= 0).all()),
    "weibull": (lambda r, s: r.weibull(2.0, size=s), math.gamma(1.5),
                1.0 - math.gamma(1.5) ** 2, lambda v: (v >= 0).all()),
    "chisquare": (lambda r, s: r.chisquare(3.0, size=s), 3.0, 6.0,
                  lambda v: (v > 0).all()),
    "lognormal": (lambda r, s: r.lognormal(0.0, 0.5, size=s),
                  math.exp(0.125), (math.exp(0.25) - 1) * math.exp(0.25),
                  lambda v: (v > 0).all()),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sampler_matches_the_reference(name):
    import mxnet_tpu as mx

    draw, mean, var, support = SAMPLERS[name]
    want = _ref(lambda: draw(mx.random, (2, 3)))
    got = draw(trandom, (2, 3))
    assert got.shape == want.shape
    assert dtype_name(got.dtype) == str(want.dtype)
    trandom.seed(7)
    v = _host(draw(trandom, (N,)))
    assert v.shape == (N,) and onp.isfinite(v).all()
    if support is not None:
        assert support(v), name
    tol = SE * math.sqrt(var / N)
    assert abs(v.mean() - mean) <= tol, (v.mean(), mean, tol)
    vt = 0.15 if name == "pareto" else VAR_TOL
    assert abs(v.var() - var) <= vt * var, (v.var(), var)


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_seed_reproduces_draws(name):
    draw = SAMPLERS[name][0]
    trandom.seed(3)
    a = _host(draw(trandom, (64,)))
    trandom.seed(3)
    b = _host(draw(trandom, (64,)))
    trandom.seed(4)
    c = _host(draw(trandom, (64,)))
    assert onp.array_equal(a, b)
    assert not onp.array_equal(a, c)


def test_tensor_parameters_broadcast_as_the_reference():
    import mxnet_tpu as mx

    for pkg, shape_of in ((mx, lambda f: _ref(f).shape),
                          (tmx, lambda f: f().shape)):
        lo, hi = pkg.np.zeros((3,)), pkg.np.ones((3,)) * 2
        assert shape_of(lambda: pkg.random.uniform(lo, hi)) == (3,)
        assert shape_of(lambda: pkg.random.normal(lo, hi, size=(4, 3))) \
            == (4, 3)
        assert shape_of(lambda: pkg.random.gamma(hi, size=(5, 3))) == (5, 3)
        assert shape_of(lambda: pkg.random.exponential(hi, size=(3,))) \
            == (3,)
    trandom.seed(0)
    lo = tmx.np.array([0.0, 10.0, 100.0])
    v = _host(trandom.uniform(lo, lo + 1, size=(N, 3)))
    assert (v >= _host(lo)).all() and (v < _host(lo) + 1).all()
    assert abs(v.mean(axis=0) - (_host(lo) + 0.5)).max() <= \
        SE * math.sqrt(1 / 12 / N)


def test_permutation_shuffle_and_choice_without_replacement():
    trandom.seed(1)
    p = trandom.permutation(10)
    assert dtype_name(p.dtype) == "int32"
    assert sorted(_host(p).tolist()) == list(range(10))
    x = tmx.np.arange(12).reshape(6, 2).astype("float32")
    before = _host(x)
    assert trandom.shuffle(x) is x
    after = _host(x)
    assert sorted(map(tuple, after)) == sorted(map(tuple, before))
    rows = _host(trandom.permutation(tmx.np.array(before)))
    assert sorted(map(tuple, rows)) == sorted(map(tuple, before))
    c = _host(trandom.choice(10, size=(10,), replace=False))
    assert sorted(c.tolist()) == list(range(10))
    arr = tmx.np.array([5.0, 7.0, 9.0])
    assert set(_host(trandom.choice(arr, size=(50,)))) <= {5.0, 7.0, 9.0}


def test_weighted_choice_multinomial_and_categorical():
    import mxnet_tpu as mx

    pv = [0.2, 0.3, 0.5]
    trandom.seed(2)
    c = _host(trandom.choice(3, size=(N,), p=pv))
    freq = onp.bincount(c.astype(int), minlength=3) / N
    assert abs(freq - pv).max() <= SE * math.sqrt(0.25 / N)
    want = _ref(lambda: mx.random.multinomial(20, pv, size=(4,)))
    got = trandom.multinomial(20, pv, size=(4,))
    assert got.shape == want.shape == (4, 3)
    assert dtype_name(got.dtype) == str(want.dtype) == "int32"
    counts = _host(trandom.multinomial(20, pv, size=(N // 20,)))
    assert (counts.sum(axis=1) == 20).all()
    assert abs(counts.mean(axis=0) - 20 * onp.array(pv)).max() <= \
        SE * math.sqrt(20 * 0.25 / (N // 20))
    logits = onp.log(onp.array([[0.1, 0.6, 0.3]], "float32"))
    want = _ref(lambda: mx.random.categorical(mx.np.array(logits)))
    got = trandom.categorical(tmx.np.array(logits))
    assert got.shape == want.shape and dtype_name(got.dtype) == "int32"
    draws = _host(trandom.categorical(tmx.np.array(logits), size=(N, 1)))
    freq = onp.bincount(draws.astype(int).ravel(), minlength=3) / N
    assert abs(freq - [0.1, 0.6, 0.3]).max() <= SE * math.sqrt(0.25 / N)


def test_multivariate_normal():
    import mxnet_tpu as mx

    mean = onp.array([1.0, -1.0], "float32")
    cov = onp.array([[2.0, 0.5], [0.5, 1.0]], "float32")
    want = _ref(lambda: mx.random.multivariate_normal(mean, cov, size=(4,)))
    got = trandom.multivariate_normal(mean, cov, size=(4,))
    assert got.shape == want.shape == (4, 2)
    trandom.seed(5)
    v = _host(trandom.multivariate_normal(mean, cov, size=(N,)))
    assert abs(v.mean(axis=0) - mean).max() <= SE * math.sqrt(2.0 / N)
    assert abs(onp.cov(v.T) - cov).max() <= VAR_TOL * 2.0


# -- the registered sampler ops ------------------------------------------------
# name: (inputs, attributes, mean, variance, support)
NPI = {
    "_npi_uniform": ((), dict(low=-1.0, high=3.0), 1.0, 16 / 12,
                     lambda v: (v >= -1).all() and (v < 3).all()),
    "_npi_normal": ((), dict(loc=2.0, scale=0.5), 2.0, 0.25, None),
    "_npi_bernoulli": ((), dict(prob=0.7), 0.7, 0.21,
                       lambda v: set(onp.unique(v)) <= {0.0, 1.0}),
    "_npi_exponential": ((), dict(scale=3.0), 3.0, 9.0,
                         lambda v: (v >= 0).all()),
    "_npi_gumbel": ((), dict(loc=0.0, scale=1.0), EULER, math.pi ** 2 / 6,
                    None),
    "_npi_laplace": ((), dict(loc=0.0, scale=1.0), 0.0, 2.0, None),
    "_npi_logistic": ((), dict(loc=0.0, scale=1.0), 0.0, math.pi ** 2 / 3,
                      None),
    # numpy's pareto: the Lomax, support [0, inf)
    "_npi_pareto": ((), dict(a=5.0), 0.25, 5 / 48, lambda v: (v >= 0).all()),
    "_npi_rayleigh": ((), dict(scale=1.0), math.sqrt(math.pi / 2),
                      (4 - math.pi) / 2, lambda v: (v >= 0).all()),
    "_npi_weibull": ((), dict(a=2.0), math.gamma(1.5),
                     1.0 - math.gamma(1.5) ** 2, lambda v: (v >= 0).all()),
    "_npi_gamma": ((), dict(shape=3.0, scale=2.0), 6.0, 12.0,
                   lambda v: (v > 0).all()),
    "_npi_choice": ((), dict(a=6), 2.5, 35 / 12,
                    lambda v: set(onp.unique(v)) <= set(range(6))),
    "_npi_normal_n": ((), dict(loc=-1.0, scale=2.0), -1.0, 4.0, None),
    "_npi_uniform_n": ((), dict(low=0.0, high=2.0), 1.0, 4 / 12,
                       lambda v: (v >= 0).all() and (v < 2).all()),
    "_random_uniform": ((), dict(low=1.0, high=2.0), 1.5, 1 / 12, None),
    "_random_normal": ((), dict(loc=0.0, scale=3.0), 0.0, 9.0, None),
    "_random_gamma": ((), dict(alpha=2.0, beta=0.5), 1.0, 0.5, None),
    "_random_exponential": ((), dict(lam=4.0), 0.25, 1 / 16, None),
    "_random_poisson": ((), dict(lam=5.0), 5.0, 5.0, None),
    # NB(k, p): mean k(1-p)/p, variance k(1-p)/p^2
    "_random_negative_binomial": ((), dict(k=3, p=0.4), 4.5, 11.25, None),
    # mu, and variance mu + alpha mu^2
    "_random_generalized_negative_binomial": ((), dict(mu=2.0, alpha=0.5),
                                              2.0, 4.0, None),
    "_random_randint": ((), dict(low=-3, high=3), -0.5, 35 / 12,
                        lambda v: set(onp.unique(v)) <= set(range(-3, 3))),
}


def _size_attr(name, n):
    return dict(shape=n) if name.startswith("_random") else dict(size=n)


@pytest.mark.parametrize("name", sorted(NPI))
def test_sampler_op_matches_the_reference(name):
    from mxnet_tpu.ops.registry import apply_op as ref_op

    ins, attrs, mean, var, support = NPI[name]
    want = _ref(lambda: ref_op(name, *ins, **attrs,
                               **_size_attr(name, (2, 3))))
    got = apply_op(name, *ins, **attrs, **_size_attr(name, (2, 3)))
    assert got.shape == want.shape
    assert dtype_name(got.dtype) == str(want.dtype)
    trandom.seed(8)
    v = _host(apply_op(name, *ins, **attrs, **_size_attr(name, (N,))))
    assert v.shape == (N,)
    if support is not None:
        assert support(v), name
    assert abs(v.mean() - mean) <= SE * math.sqrt(var / N), (v.mean(), mean)
    assert abs(v.var() - var) <= (0.15 if "pareto" in name else VAR_TOL) \
        * var, (v.var(), var)


def test_sampler_ops_with_tensor_parameters():
    from mxnet_tpu.ops.registry import apply_op as ref_op
    import mxnet_tpu as mx

    cases = [("_sample_uniform", 2, {}), ("_sample_normal", 2, {}),
             ("_sample_gamma", 2, {}), ("_sample_exponential", 1, {}),
             ("_sample_poisson", 1, {}),
             ("_sample_negative_binomial", 2, {}),
             ("_sample_generalized_negative_binomial", 2, {}),
             ("_npi_normal_n", 2, dict(size=(4,))),
             ("_npi_uniform_n", 2, dict(size=(4,)))]
    a = onp.array([1.0, 2.0, 3.0], "float32")
    b = onp.array([0.5, 0.5, 0.25], "float32")
    for name, n, extra in cases:
        kw = extra or dict(shape=(5,))
        want = _ref(lambda: ref_op(
            name, *[mx.np.array(p) for p in (a, b)[:n]], **kw))
        got = apply_op(name, *[tmx.np.array(p) for p in (a, b)[:n]], **kw)
        assert got.shape == want.shape, name
        assert dtype_name(got.dtype) == str(want.dtype), name
    trandom.seed(1)
    rows = _host(apply_op("_sample_normal", tmx.np.array(a),
                          tmx.np.array(b), shape=(N,)))
    assert abs(rows.mean(axis=1) - a).max() <= SE * 0.5 / math.sqrt(N)
    probs = onp.array([[0.2, 0.8], [0.9, 0.1]], "float32")
    want = _ref(lambda: ref_op("_sample_multinomial", mx.np.array(probs),
                               shape=(3,)))
    got = apply_op("_sample_multinomial", tmx.np.array(probs), shape=(3,))
    assert got.shape == want.shape == (2, 3)
    assert dtype_name(got.dtype) == str(want.dtype)
    draws = _host(apply_op("_sample_multinomial", tmx.np.array(probs),
                           shape=(N,)))
    assert abs(draws.mean(axis=1) - [0.8, 0.1]).max() <= \
        SE * 0.5 / math.sqrt(N)
    idx, lp = apply_op("_sample_multinomial", tmx.np.array(probs),
                       shape=(4,), get_prob=True)
    assert onp.allclose(_host(lp), onp.log(onp.take_along_axis(
        probs, _host(idx).astype(int), axis=1)))
    counts = apply_op("_npi_multinomial", tmx.np.array([0.5, 0.5]), n=6,
                      size=(3,))
    assert counts.shape == (3, 2) and (_host(counts).sum(axis=1) == 6).all()
    x = tmx.np.arange(8).astype("float32")
    sh = _host(apply_op("_shuffle", x))
    assert sorted(sh.tolist()) == list(range(8))
    assert apply_op("shuffle", x).shape == (8,)


# -- inside a hybridized block -------------------------------------------------
class _Noise(HybridBlock):
    def forward(self, x):
        return x + tmx.np.random.uniform(size=tuple(x.shape))._data + \
            tmx.np.random.normal(0.0, 1.0, size=tuple(x.shape))._data


def test_sampler_inside_a_hybridized_block_draws_each_call():
    net = _Noise()
    net.hybridize()
    x = torch.zeros(64)
    a, b = net(x), net(x)
    assert len(net._cached) == 1
    assert not torch.equal(a, b)
    trandom.seed(12)
    c = net(x)
    trandom.seed(12)
    assert torch.equal(c, net(x))


def test_samplers_draw_from_the_ports_generator_only():
    """The global torch generator is never consumed."""
    torch.manual_seed(0)
    before = torch.get_rng_state()
    for name in sorted(SAMPLERS):
        SAMPLERS[name][0](trandom, (8,))
    for name, (ins, attrs, *_r) in NPI.items():
        apply_op(name, *ins, **attrs, **_size_attr(name, (8,)))
    assert torch.equal(torch.get_rng_state(), before)


def test_host_rng_is_seeded_with_the_generators():
    trandom.seed(21)
    a = trandom.host_rng.rand(4)
    trandom.seed(21)
    assert onp.array_equal(a, trandom.host_rng.rand(4))


# -- on the card ---------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_sampler_inside_a_captured_graph_redraws_each_replay(cuda):
    with tmx.gpu():
        net = _Noise()
        net.hybridize()
        x = torch.zeros(4096, device=cuda)
        outs = [net(x) for _ in range(4)]
        cop = next(iter(net._cached.values()))[0]
        prog = next(iter(cop._programs.values()))
        torch.cuda.synchronize()
        assert cop._uses_rng and cop._captures == 1 and prog.replays == 4
        for i in range(4):
            for j in range(i):
                assert not torch.equal(outs[i], outs[j])
        trandom.seed(5)
        a = net(x)
        trandom.seed(5)
        assert torch.equal(a, net(x))
        v = apply_op("_npi_uniform", size=(N,), ctx="cuda")
        assert v._data.device.type == "cuda"
        assert abs(float(v._data.mean()) - 0.5) <= SE * math.sqrt(1 / 12 / N)
