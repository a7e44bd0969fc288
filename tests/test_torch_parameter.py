"""PyTorch/CUDA port: ``gluon.Parameter``'s reference surface, held to the
JAX package's on the same cases.

The reference's own cases (``tests/test_gluon.py``:
``test_param_grad_after_backward`` :36, ``test_uninitialized_raises`` :217,
``test_zero_grad`` :223) and every accessor of
``mxnet_tpu/gluon/parameter.py:22-244`` run in both packages (``pkg``):
the reference's constructor, ``name``, ``shape`` (filling unknown
dimensions), ``initialize`` with ``force_reinit``, ``data()``,
``list_data``, ``grad()``, ``list_grad``, ``list_ctx``, ``set_data``,
``zero_grad``, ``reset_ctx``, ``cast``, ``var()``, ``__repr__``,
``gluon.Constant`` and ``DeferredInitializationError``. Values are compared
exactly: both packages fill from the same numbers here (ones, zeros, set
data), so no rounding enters.

Two differences stay, stated where they are tested: a layer of the port
whose parameters nothing initialized computes with their zeros (the port's
layers always have, and its tests use it); the reference's forward raises.
``data()`` of such a parameter raises in both. And on ``grad_req='null'``
the port's ``p.grad`` is None, as torch has it for a frozen parameter, so
``p.grad()`` is a ``TypeError`` there; ``list_grad()`` raises
``MXNetError`` in both packages.

Then the port's torch side of the same objects: ``p.data`` and ``p.grad``
as torch reads them (``.data =`` fills, ``p.grad`` a tensor or None, the
same gradient object on every read), ``nn.Module._apply`` moving the
gradients ``initialize()`` attached, ``torch.optim`` over a block with a
frozen parameter, a ``copy.deepcopy``, a ``Trainer`` and a compiled step
over reference-style parameters.
"""
import copy

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon import Trainer


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


def _a(x):
    return onp.asarray(x.asnumpy())


# -- the reference's own cases -------------------------------------------------
def test_param_grad_after_backward(pkg):
    layer = pkg.gluon.nn.Dense(3)
    layer.initialize()
    x = pkg.np.ones((2, 4))
    with pkg.autograd.record():
        loss = layer(x).sum()
    loss.backward()
    assert layer.weight.grad().shape == (3, 4)
    assert float(abs(layer.bias.grad()).sum()) > 0


def test_uninitialized_raises(pkg):
    net = pkg.gluon.nn.Dense(2, in_units=3)
    with pytest.raises(pkg.base.MXNetError):
        net.weight.data()
    if pkg is tmx:
        # the port's layer computes with the zeros it was made with
        assert not net(pkg.np.ones((1, 3))).asnumpy().any()
    else:
        with pytest.raises(pkg.base.MXNetError):
            net(pkg.np.ones((1, 3)))


def test_zero_grad(pkg):
    net = pkg.gluon.nn.Dense(2, in_units=3)
    net.initialize()
    with pkg.autograd.record():
        net(pkg.np.ones((1, 3))).sum().backward()
    assert float(abs(net.weight.grad()).sum()) > 0
    net.zero_grad()
    assert float(abs(net.weight.grad()).sum()) == 0


# -- every accessor, in both packages ------------------------------------------
def test_reference_constructor_and_initialize(pkg):
    p = pkg.gluon.Parameter("w", shape=(2, 3), lr_mult=2.0, wd_mult=0.5,
                            init="ones")
    assert p.name == "w" and tuple(p.shape) == (2, 3)
    assert (p.lr_mult, p.wd_mult, p.grad_req) == (2.0, 0.5, "write")
    with pytest.raises(pkg.base.MXNetError, match="initialize"):
        p.data()
    p.initialize()
    assert _a(p.data()).tolist() == [[1.0] * 3] * 2
    assert not _a(p.grad()).any()             # a zero gradient, before any
    p.initialize(init="zeros")                # backward; initialized: kept
    assert _a(p.data()).tolist() == [[1.0] * 3] * 2
    p.initialize(init="zeros", force_reinit=True)
    assert not _a(p.data()).any()
    q = pkg.gluon.Parameter("q", shape=(2,), differentiable=False)
    assert q.grad_req == "null"


def test_default_init_and_own_init(pkg):
    own = pkg.gluon.Parameter("a", shape=(2,), init="ones")
    own.initialize(default_init="zeros")
    assert _a(own.data()).tolist() == [1.0, 1.0]
    plain = pkg.gluon.Parameter("b", shape=(2,))
    plain.initialize(default_init="ones")
    assert _a(plain.data()).tolist() == [1.0, 1.0]
    given = pkg.gluon.Parameter("c", shape=(2,), init="ones")
    given.initialize(init="zeros")
    assert _a(given.data()).tolist() == [0.0, 0.0]


def test_shape_fills_unknown_dimensions(pkg):
    p = pkg.gluon.Parameter("w", shape=(3, 0), allow_deferred_init=True)
    p.shape = (3, 4)
    assert tuple(p.shape) == (3, 4)
    with pytest.raises(pkg.base.MXNetError):
        p.shape = (5, 4)


def test_deferred_initialization_error(pkg):
    err = pkg.gluon.DeferredInitializationError
    assert issubclass(err, pkg.base.MXNetError)
    strict = pkg.gluon.Parameter("w", shape=(3, 0))
    with pytest.raises(err):
        strict.initialize()
    lazy = pkg.gluon.Parameter("v", shape=(3, 0), allow_deferred_init=True)
    lazy.initialize(init="ones")
    with pytest.raises(err):
        lazy.data()


def test_set_data_list_and_ctx(pkg):
    p = pkg.gluon.Parameter("w", shape=(2, 2))
    p.set_data(pkg.np.array([[1.0, 2.0], [3.0, 4.0]]))
    assert _a(p.data()).tolist() == [[1.0, 2.0], [3.0, 4.0]]
    assert [_a(d).tolist() for d in p.list_data()] == [[[1.0, 2.0],
                                                        [3.0, 4.0]]]
    assert [_a(g).tolist() for g in p.list_grad()] == [[[0.0, 0.0],
                                                        [0.0, 0.0]]]
    assert [str(c) for c in p.list_ctx()] == ["cpu(0)"]
    with pytest.raises(pkg.base.MXNetError, match="shape"):
        p.set_data(pkg.np.ones((3, 3)))
    p.reset_ctx(pkg.cpu())
    assert str(p.list_ctx()[0]) == "cpu(0)"
    p.set_data(pkg.np.zeros((2, 2)))            # initialized: a write
    assert not _a(p.data()).any()


def test_grad_null_raises_and_cast(pkg):
    p = pkg.gluon.Parameter("w", shape=(2,), init="ones")
    p.initialize()
    p.cast("float16")
    assert str(p.data().dtype) == "float16"
    assert str(p.grad().dtype) == "float16"
    p.grad_req = "null"
    with pytest.raises(pkg.base.MXNetError, match="null"):
        p.list_grad()
    if pkg is tmx:
        assert p.grad is None          # torch's frozen parameter
    else:
        with pytest.raises(pkg.base.MXNetError, match="null"):
            p.grad()


def test_var_and_repr(pkg):
    p = pkg.gluon.Parameter("fc_weight", shape=(4, 3))
    assert p.var().name == "fc_weight"
    assert repr(p) == "Parameter fc_weight (shape=(4, 3), dtype=float32)"


def test_constant(pkg):
    c = pkg.gluon.Constant(pkg.np.array([1.0, 2.0]), name="const_a")
    assert c.name == "const_a" and c.grad_req == "null"
    c.initialize()
    assert _a(c.data()).tolist() == [1.0, 2.0]
    with pytest.raises(pkg.base.MXNetError):
        c.list_grad()


def test_data_in_a_body_differentiates_into_the_parameter(pkg):
    """The reference GPT's tied head reads ``weight.data()``."""
    class Head(pkg.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.emb = pkg.gluon.nn.Embedding(5, 3)

        def forward(self, x):
            return pkg.np.matmul(x, self.emb.weight.data().T)

    net = Head()
    net.initialize(init="ones")
    x = pkg.np.array([[1.0, 2.0, 3.0]])
    with pkg.autograd.record():
        y = net(x).sum()
    y.backward()
    assert _a(net.emb.weight.grad()).tolist() == [[1.0, 2.0, 3.0]] * 5


# -- the port's torch side of the same objects ---------------------------------
def test_data_and_grad_as_torch_reads_them():
    p = tmx.gluon.Parameter(torch.arange(4.0))
    assert isinstance(p.data, torch.Tensor) and p.grad is None
    assert type(p.data + 1) is torch.Tensor     # ops give plain tensors
    p.data = torch.ones(4)                      # torch's setter
    assert p.data().asnumpy().tolist() == [1.0] * 4
    assert p.data()._data is p                  # the parameter itself
    (p * 3).sum().backward()
    assert isinstance(p.grad, torch.Tensor) and p.grad is p.grad
    assert torch.equal(p.grad, torch.full((4,), 3.0))
    assert p.grad().asnumpy().tolist() == [3.0] * 4
    p.grad()[:] = 0.0                           # writes the gradient
    assert not p.grad.any()
    p.grad = None
    assert p.grad is None
    p.data()[:] = 2.0                           # writes the parameter
    assert torch.equal(p.detach(), torch.full((4,), 2.0))


def test_module_apply_moves_the_attached_gradients():
    """``initialize()`` attaches zero gradients; ``net.double()`` (torch's
    ``_apply``, as ``.to()``/``.cuda()``) must move them with the data."""
    net = tmx.gluon.nn.Dense(3, in_units=4)
    net.initialize(seed=0)
    net.double()
    for p in net.collect_params().values():
        assert p.dtype == torch.float64 and p.grad.dtype == torch.float64
    with tmx.autograd.record():
        y = net(torch.ones(2, 4, dtype=torch.float64)).sum()
    tmx.autograd.backward(y)
    for p in net.collect_params().values():
        assert p.grad.dtype == p.dtype and p.grad.device == p.device
        assert p.grad.any()
    assert torch.equal(net.bias.grad, torch.full((3,), 2.0,
                                                  dtype=torch.float64))


def test_torch_optim_skips_a_frozen_parameter():
    net = tmx.gluon.nn.Dense(3, in_units=4)
    net.initialize(seed=0)
    net.bias.grad_req = "null"
    assert net.bias.grad is None
    bias = net.bias.detach().clone()
    opt = torch.optim.SGD(net.parameters(), lr=0.1, weight_decay=0.1)
    with tmx.autograd.record():
        y = net(torch.ones(2, 4)).sum()
    tmx.autograd.backward(y)
    opt.step()
    assert torch.equal(net.bias.detach(), bias)
    assert net.bias.grad is None
    torch.nn.utils.clip_grad_norm_(net.parameters(), 1.0)


def test_deepcopy_keeps_the_reference_attributes():
    p = tmx.gluon.Parameter("w", shape=(2,), lr_mult=3.0, grad_req="add",
                            init="ones")
    p.initialize()
    q = copy.deepcopy(p)
    assert type(q) is type(p) and q is not p
    assert (q.name, q.lr_mult, q.grad_req) == ("w", 3.0, "add")
    assert q.data().asnumpy().tolist() == [1.0, 1.0]
    assert q.data_ptr() != p.data_ptr()


def test_trainer_and_compiled_step_over_reference_parameters():
    class Affine(tmx.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.w = tmx.gluon.Parameter("w", shape=(3, 2))
            self.b = tmx.gluon.Parameter("b", shape=(2,), init="zeros")

        def forward(self, x):
            return tmx.np.matmul(x, self.w.data()) + self.b.data()

    def loss_fn(out, y):
        return ((out - y) ** 2).sum(axis=-1)

    x = torch.from_numpy(onp.random.RandomState(0).randn(4, 3)
                         .astype("float32"))
    y = torch.ones(4, 2)
    nets = []
    for compiled in (False, True):
        net = Affine()
        net.initialize(seed=3)
        tr = Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
        step = tr.compile_step(net, loss_fn) if compiled else None
        for _ in range(3):
            if compiled:
                step(x, y)
            else:
                with tmx.autograd.record():
                    loss = loss_fn(net(x), y).mean()
                tmx.autograd.backward(loss)
                tr.step(1)
        nets.append(net)
    for a, b in zip(nets[0].collect_params().values(),
                    nets[1].collect_params().values()):
        torch.testing.assert_close(a.detach(), b.detach(), rtol=1e-6,
                                   atol=1e-7)
    assert not nets[0].b.detach().eq(0).all()     # the steps moved them
