"""PyTorch/CUDA port: the reference's alias table in the registry, the
legacy names of ``mx.nd``/``mx.sym``/the Symbol JSON, and the constructor
keywords the reference takes and ignores (``prefix``, ``params``,
``sparse_grad``, ``stype``, ``grad_stype``), against the JAX package on the
CPU.

Every alias of ``mxnet_tpu/ops/aliases.py`` whose target the port has is
registered and is the target's own ``Op``; the port's registry holds no
name the reference's lacks. Legacy calls and the constructs are held to the
reference's outputs on one seeded input each, within ``RTOL`` (1e-6 of the
largest entry: one fp32 formula on both sides).
"""
import json

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch import np as tnp
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.ops import aliases as taliases
from mxnet_tpu_torch.ops import registry as treg

RTOL = 1e-6
WARP_NAMES = ["BilinearSampler", "GridGenerator", "SpatialTransformer",
              "Correlation", "_contrib_DeformableConvolution",
              "_contrib_ModulatedDeformableConvolution",
              "_contrib_PSROIPooling", "_contrib_DeformablePSROIPooling"]


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _rel(got, want):
    got = onp.asarray(got, dtype="float64")
    want = onp.asarray(want, dtype="float64")
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(abs(got - want).max(initial=0.0) /
                 max(abs(want).max(initial=0.0), 1e-30))


# -- the alias table ----------------------------------------------------------
def test_alias_table_is_the_references():
    """The same tables, entry for entry; every alias whose target the port
    has is registered as that target's ``Op`` (the reference's registry
    maps it to its own target too); the others are not registered."""
    from mxnet_tpu.ops import aliases as jaliases
    from mxnet_tpu.ops import registry as jreg

    assert taliases.ALIASES == jaliases.ALIASES
    have = {a: t for a, t in taliases.ALIASES.items() if t in treg._OPS}
    assert "RNN" in have and "Cast" in have and "BlockGrad" in have
    for alias, target in have.items():
        assert treg.get_op(alias) is treg.get_op(target), alias
        assert jreg.get_op(alias) is jreg.get_op(target), alias
    waiting = set(taliases.ALIASES) - set(have)
    assert not waiting & set(treg._OPS)
    assert len(have) + len(waiting) == len(taliases.ALIASES)
    taliases._register_all()            # a second call adds nothing
    assert all(treg.get_op(a) is treg.get_op(t) for a, t in have.items())


def test_port_registry_names_are_the_references():
    """No name of the port's registry is missing from the reference's (the
    tests' own scratch aliases aside)."""
    from mxnet_tpu.ops import registry as jreg

    port = {n for n in treg.list_ops() if not n.startswith("_test_")}
    assert port <= set(jreg.list_ops()), sorted(port - set(jreg.list_ops()))


def test_legacy_names_are_the_references():
    """``symbol._LEGACY_NAMES`` is the reference's thirteen."""
    from mxnet_tpu.symbol import _LEGACY_NAMES as jlegacy

    assert tsym._LEGACY_NAMES == jlegacy and len(jlegacy) == 13


@pytest.mark.parametrize("name", ["RNN", "Cast", "BlockGrad"])
def test_legacy_call_matches_reference(name):
    """``mx.nd.<name>`` on one input against the reference's: ``RNN`` (an
    LSTM, three outputs), ``Cast`` to float16 and ``BlockGrad``; and the
    same through ``mx.sym``."""
    import mxnet_tpu as mx

    rng = onp.random.RandomState(len(name))
    if name == "RNN":
        H = 3
        ins = [rng.randn(4, 2, 5), 0.5 * rng.randn(1, 2, H),
               0.5 * rng.randn(1, 2, H), rng.randn(4 * H, 5),
               rng.randn(4 * H, H), rng.randn(4 * H), rng.randn(4 * H)]
        attrs = dict(mode="lstm", num_layers=1, hidden_size=H,
                     bidirectional=False, dropout=0.0)
    elif name == "Cast":
        ins, attrs = [rng.randn(3, 4)], dict(dtype="float16")
    else:
        ins, attrs = [rng.randn(3, 4)], {}
    ins = [a.astype("float32") for a in ins]
    want = getattr(mx.nd, name)(*[mx.np.array(a) for a in ins], **attrs)
    got = getattr(tnd, name)(*[tnp.array(a) for a in ins], **attrs)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert str(g.dtype) == str(w.dtype)
        assert _rel(g.asnumpy(), w.asnumpy()) <= RTOL
    names = [f"a{i}" for i in range(len(ins))]
    s = getattr(tsym, name)(*[tsym.var(n) for n in names], **attrs)
    sym_out = s.eval(**{n: tnp.array(a) for n, a in zip(names, ins)})
    for g, w in zip(sym_out, got):
        onp.testing.assert_array_equal(g.asnumpy(), w.asnumpy())


def test_warp_names_resolve_through_the_registry():
    """The eight warp and deformable names, no longer in ``_LEGACY_NAMES``,
    reach ``mx.nd``, ``mx.sym`` and the Symbol JSON loader through the
    registry's aliases."""
    for name in WARP_NAMES:
        assert name not in tsym._LEGACY_NAMES
        op = treg.get_op(name)
        assert op is treg.get_op(taliases.ALIASES[name])
        assert callable(getattr(tnd, name)) and callable(getattr(tsym, name))
        graph = {"nodes": [{"op": "null", "name": "x", "inputs": []},
                           {"op": name, "name": "n", "attrs": {},
                            "inputs": [[0, 0]]}],
                 "heads": [[1, 0]], "mxnet_tpu_version": 1}
        assert tsym.fromjson(json.dumps(graph))._entries[0][0].op is op
    rng = onp.random.RandomState(0)
    a, b = (rng.randn(1, 4, 6, 6).astype("float32") for _ in range(2))
    got = tnd.Correlation(tnp.array(a), tnp.array(b), kernel_size=1,
                          max_displacement=1, stride1=1, stride2=1,
                          pad_size=1)
    want = tmx.npx.correlation(tnp.array(a), tnp.array(b), kernel_size=1,
                               max_displacement=1, stride1=1, stride2=1,
                               pad_size=1)
    onp.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


# -- C8: the constructor keywords ---------------------------------------------
def _forward_both(make, x, tmp_path):
    """``make(pkg)`` built in both packages, the reference's weights moved
    to the port by a ``.params`` file; their forwards on ``x``."""
    import mxnet_tpu as mx

    mx.random.seed(1)
    jb = make(mx.gluon)
    jb.initialize(mx.initializer.Uniform(0.5))
    want = jb(mx.np.array(x)).asnumpy()
    jb.save_parameters(str(tmp_path / "c8.params"))
    tb = make(tgluon)
    tb.load_parameters(str(tmp_path / "c8.params"))
    got = tb(tnp.array(x)).asnumpy()
    assert _rel(got, want) <= RTOL
    return tb


def test_dense_takes_prefix_and_params(tmp_path):
    """``nn.Dense(4, prefix="d_")`` and ``nn.Dense(4, params=None)``."""
    x = onp.random.RandomState(1).randn(2, 5).astype("float32")
    for kw in ({"prefix": "d_"}, {"params": None}):
        _forward_both(lambda g, kw=kw: g.nn.Dense(4, in_units=5, **kw), x,
                      tmp_path)


def test_conv2d_takes_prefix(tmp_path):
    """``nn.Conv2D(4, 3, prefix="c_")``."""
    x = onp.random.RandomState(2).randn(1, 2, 5, 5).astype("float32")
    _forward_both(lambda g: g.nn.Conv2D(4, 3, in_channels=2, prefix="c_"),
                  x, tmp_path)


@pytest.mark.parametrize("sparse_grad", [False, True])
def test_embedding_takes_sparse_grad(tmp_path, sparse_grad):
    """``nn.Embedding(10, 4, sparse_grad=...)``: accepted and ignored (a
    dense gradient)."""
    x = onp.array([[1, 3, 9], [0, 0, 2]], "int32")
    tb = _forward_both(lambda g: g.nn.Embedding(10, 4,
                                                sparse_grad=sparse_grad),
                       x, tmp_path)
    with tmx.autograd.record():
        loss = tb(tnp.array(x)).sum()
    loss.backward()
    assert tb.weight.grad.shape == (10, 4)


def test_parameter_takes_stype_and_grad_stype():
    """``gluon.Parameter(..., stype="row_sparse", grad_stype="row_sparse")``
    is accepted and behaves as a dense parameter, as the reference's."""
    import mxnet_tpu as mx

    for gl, np_ in ((mx.gluon, mx.np), (tgluon, tnp)):
        p = gl.Parameter("w", shape=(3, 2), stype="row_sparse",
                         grad_stype="row_sparse")
        p.initialize(init=mx.initializer.Constant(0.5) if gl is mx.gluon
                     else tmx.initializer.Constant(0.5))
        onp.testing.assert_array_equal(p.data().asnumpy(),
                                       onp.full((3, 2), 0.5, "float32"))


def test_blocks_take_prefix_and_params(tmp_path):
    """A user's ``Block`` and ``HybridBlock`` passing ``prefix`` and
    ``params`` to their bases, as reference-style code does; layers inside
    forward ``**kwargs`` too."""
    x = onp.random.RandomState(3).randn(2, 4).astype("float32")

    def make(g):
        class Net(g.HybridBlock):
            def __init__(self, **kwargs):
                super().__init__(prefix="net_", params=None, **kwargs)
                self.body = g.nn.HybridSequential()
                self.body.add(g.nn.Dense(3, in_units=4, prefix="fc_"),
                              g.nn.LayerNorm(in_channels=3, prefix="ln_"),
                              g.nn.Activation("relu", prefix="act_"))

            def forward(self, x):
                return self.body(x)

        return Net()

    _forward_both(make, x, tmp_path)

    class Plain(tgluon.Block):
        def __init__(self):
            super().__init__(prefix="p_", params=None)
            self.fc = tnn.Dense(2, in_units=4)

        def forward(self, x):
            return self.fc(x)

    net = Plain()
    net.initialize()
    assert net(tnp.array(x)).shape == (2, 2)
    assert torch.is_tensor(net(torch.tensor(x)))
