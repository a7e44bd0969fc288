"""PyTorch/CUDA port: the light layers of ``gluon/nn/basic_layers.py``
against the JAX package's, with the same weights and inputs.

``Sequential``/``HybridSequential`` (with the reference's
``test_sequential_slicing``, ``tests/test_gluon.py:184``), ``Dropout``
(``test_dropout_train_eval`` :152: by its keep rate and its scaling inside
``record()`` and as the identity outside it, since the two packages' random
streams differ), ``Identity``, ``LeakyReLU``, ``PReLU`` (its ``alpha``
through a ``.params`` file), ``ELU``, ``SELU``, ``GELU`` (erf and tanh),
``Swish``/``SiLU``, ``Lambda``/``HybridLambda`` (a function and an
``mx.np`` name; the port's ``HybridLambda`` against the reference's
``Lambda``, since the reference's ``HybridLambda`` cannot be built) and
``Concatenate``/``HybridConcatenate``: outputs and the input's gradient,
eagerly and hybridized. Tolerance: 1e-6 of each tensor's
largest entry (the same elementwise fp32 formulas; ``exp``/``erf`` may
round differently by an ulp).
"""
import numpy as onp
import pytest

import mxnet_tpu_torch as tmx

TOL = 1e-6
X = onp.random.RandomState(3).randn(4, 3).astype("float32")


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


@pytest.fixture(params=["jax", "port"])
def pkg(request):
    if request.param == "jax":
        import mxnet_tpu

        return mxnet_tpu
    return tmx


def _layer(pkg, name):
    nn = pkg.gluon.nn
    return {
        "identity": lambda: nn.Identity(),
        "leaky": lambda: nn.LeakyReLU(0.1),
        "prelu": lambda: nn.PReLU(in_channels=3),
        "elu": lambda: nn.ELU(0.7),
        "selu": lambda: nn.SELU(),
        "gelu": lambda: nn.GELU(),
        "gelu_tanh": lambda: nn.GELU(approximation="tanh"),
        "swish": lambda: nn.Swish(1.5),
        "silu": lambda: nn.SiLU(),
        "lambda_fn": lambda: nn.Lambda(lambda x: pkg.np.exp(x) * 2.0),
        # the JAX package's HybridLambda cannot be built (its MRO sends
        # HybridBlock.__init__'s arguments to Lambda.__init__): the port's
        # is held to the reference's Lambda
        "lambda_name": lambda: (nn.HybridLambda if pkg is tmx
                                else nn.Lambda)("tanh"),
        "concat": lambda: _concat(pkg, nn.Concatenate),
        "hconcat": lambda: _concat(pkg, nn.HybridConcatenate),
        "sequential": lambda: _seq(pkg, nn.Sequential),
    }[name]()


def _concat(pkg, cls):
    net = cls(axis=-1)
    net.add(pkg.gluon.nn.Dense(2, in_units=3), pkg.gluon.nn.Identity(),
            pkg.gluon.nn.Activation("tanh"))
    return net


def _seq(pkg, cls):
    net = cls()
    net.add(pkg.gluon.nn.Dense(5, in_units=3), pkg.gluon.nn.GELU(),
            pkg.gluon.nn.Dense(2, in_units=5))
    return net


LAYERS = ("identity", "leaky", "prelu", "elu", "selu", "gelu", "gelu_tanh",
          "swish", "silu", "lambda_fn", "lambda_name", "concat", "hconcat",
          "sequential")


def _run(pkg, name, path, hybrid):
    net = _layer(pkg, name)
    if net.collect_params():
        net.load_parameters(path)
    if hybrid and hasattr(net, "hybridize"):
        net.hybridize()
    x = pkg.np.array(X)
    x.attach_grad()
    with pkg.autograd.record():
        y = net(x)
        s = (y * y).sum()
    s.backward()
    return onp.asarray(y.asnumpy()), onp.asarray(x.grad.asnumpy())


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Each layer's parameters, drawn once by the port and saved."""
    out = {}
    with tmx.cpu():
        for i, name in enumerate(LAYERS):
            net = _layer(tmx, name)
            net.initialize(seed=i)
            if name == "prelu":
                net.alpha.set_data(tmx.np.array([0.1, 0.2, 0.3]))
            out[name] = str(tmp_path_factory.mktemp("w") / f"{name}.params")
            net.save_parameters(out[name])
    return out


@pytest.mark.parametrize("hybrid", [False, True], ids=["eager", "hybrid"])
@pytest.mark.parametrize("name", LAYERS)
def test_layer_matches_jax(weights, name, hybrid):
    import mxnet_tpu as mx

    got = _run(tmx, name, weights[name], hybrid)
    want = _run(mx, name, weights[name], hybrid)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert abs(g - w).max() <= TOL * max(abs(w).max(), 1.0), name


def test_sequential_slicing(pkg):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(4), pkg.gluon.nn.Dense(3),
            pkg.gluon.nn.Dense(2))
    assert len(net) == 3
    sub = net[1:]
    assert len(sub) == 2
    assert type(sub) is type(net) and sub[0] is net[1]
    assert isinstance(net, pkg.gluon.nn.Sequential)


def test_dropout_train_eval(pkg):
    do = pkg.gluon.nn.Dropout(0.5)
    x = pkg.np.ones((100, 100))
    out_eval = do(x)
    assert onp.array_equal(out_eval.asnumpy(), x.asnumpy())   # identity
    with pkg.autograd.record():
        out_train = do(x).asnumpy()
    assert (out_train == 0).mean() > 0.3                      # ~half dropped
    kept = out_train[out_train != 0]
    assert onp.allclose(kept, 2.0)                            # 1 / keep


def test_dropout_keep_rate_hybridized():
    do = tmx.gluon.nn.Dropout(0.25)
    do.hybridize()
    x = tmx.np.ones((200, 200))
    with tmx.autograd.record():
        a = do(x).asnumpy()
        b = do(x).asnumpy()
    for out in (a, b):
        assert abs((out == 0).mean() - 0.25) < 0.02
        assert onp.allclose(out[out != 0], 1 / 0.75)
    assert not onp.array_equal(a, b)              # a fresh mask each call


def test_lambda_names_an_np_function(pkg):
    lam = pkg.gluon.nn.Lambda("square")
    assert onp.array_equal(lam(pkg.np.array(X)).asnumpy(), X * X)
