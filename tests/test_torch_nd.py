"""PyTorch/CUDA port: the legacy ``mx.nd`` namespace
(``mxnet_tpu_torch/nd.py``), against the JAX package's ``mxnet_tpu/nd.py``
on the CPU.

Checked:

- every name ``mxnet_tpu/nd.py`` binds resolves in the port's ``mx.nd``
  (the names are read from the reference's source, so the check needs no
  JAX), and ``mx.nd`` is the port's legacy module, with ``NDArray``,
  ``array``, ``from_torch`` and ``sparse`` beside it;
- the bound functions on the same seeded inputs: values within 1e-6 of
  each largest entry (integer results exactly);
- ``save`` / ``load`` of an array, a list and a dict, written by either
  package and read by the other, bitwise, under any file name;
- ``__getattr__``: registered ops by name and by legacy name.

The JAX package is imported inside the tests that use it, so
``pytest --noconftest tests/test_torch_nd.py -m cuda`` collects this file
on a machine without JAX.
"""
import ast
import os

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd as tnd

RTOL = 1e-6
REF_ND = os.path.join(os.path.dirname(__file__), "..", "mxnet_tpu", "nd.py")


def _reference_names():
    """The public names the reference's nd.py binds at module level."""
    with open(REF_ND) as fh:
        tree = ast.parse(fh.read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
    return sorted(n for n in names if not n.startswith("_"))


NAMES = _reference_names()


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


@pytest.mark.parametrize("name", NAMES)
def test_every_reference_name_resolves(name):
    assert getattr(tnd, name, None) is not None, name


def test_namespace_is_the_legacy_module():
    assert tmx.nd is tnd
    assert tnd.NDArray is tmx.NDArray and tnd.array is tmx.array
    assert tnd.sparse.CSRNDArray.__name__ == "CSRNDArray"
    assert isinstance(tnd.ones((2, 3)), tmx.NDArray)
    assert len(NAMES) > 80


def _x(rng, *shape):
    return rng.randn(*shape).astype("float32")


def _pos(rng, *shape):
    return (onp.abs(rng.randn(*shape)) + 0.5).astype("float32")


# (name, inputs from a RandomState, keyword arguments); the inputs become
# arrays of each package
CALLS = [
    ("add", lambda r: [_x(r, 3, 4), _x(r, 3, 4)], {}),
    ("divide", lambda r: [_x(r, 3, 4), _pos(r, 4)], {}),
    ("power", lambda r: [_pos(r, 3), _x(r, 3)], {}),
    ("maximum", lambda r: [_x(r, 3, 4), _x(r, 3, 4)], {}),
    ("exp", lambda r: [_x(r, 5)], {}),
    ("log", lambda r: [_pos(r, 5)], {}),
    ("sqrt", lambda r: [_pos(r, 5)], {}),
    ("abs", lambda r: [_x(r, 5)], {}),
    ("sign", lambda r: [_x(r, 5)], {}),
    ("tanh", lambda r: [_x(r, 5)], {}),
    ("sigmoid", lambda r: [_x(r, 5)], {}),
    ("relu", lambda r: [_x(r, 5)], {}),
    ("dot", lambda r: [_x(r, 3, 4), _x(r, 4, 2)], {}),
    ("batch_dot", lambda r: [_x(r, 2, 3, 4), _x(r, 2, 5, 4)],
     {"transpose_b": True}),
    ("sum", lambda r: [_x(r, 3, 4)], {"axis": 1}),
    ("mean", lambda r: [_x(r, 3, 4)], {}),
    ("max", lambda r: [_x(r, 3, 4)], {"axis": 0}),
    ("argmax", lambda r: [_x(r, 3, 4)], {"axis": 1}),
    ("clip", lambda r: [_x(r, 6)], {"a_min": -0.5, "a_max": 0.5}),
    ("stack", lambda r: [[_x(r, 2), _x(r, 2)]], {"axis": 1}),
    ("concat", lambda r: [_x(r, 2, 3), _x(r, 2, 1)], {"dim": 1}),
    ("concat", lambda r: [[_x(r, 2, 3), _x(r, 1, 3)]], {"dim": 0}),
    ("take", lambda r: [_x(r, 5, 2), onp.array([4, 0, 2], "int32")], {}),
    ("one_hot", lambda r: [onp.array([1, 0, 3], "int32")], {"depth": 4}),
    ("pick", lambda r: [_x(r, 3, 4), onp.array([1, 0, 3], "int32")], {}),
    ("topk", lambda r: [_x(r, 3, 6)], {"k": 2}),
    ("sort", lambda r: [_x(r, 3, 6)], {}),
    ("argsort", lambda r: [_x(r, 6)], {}),
    ("expand_dims", lambda r: [_x(r, 3)], {"axis": 0}),
    ("transpose", lambda r: [_x(r, 2, 3)], {}),
    ("tile", lambda r: [_x(r, 2)], {"reps": (2, 2)}),
    ("flip", lambda r: [_x(r, 3, 2)], {"axis": 0}),
    ("norm", lambda r: [_x(r, 3, 4)], {}),
    ("softmax", lambda r: [_x(r, 3, 4)], {}),
    ("log_softmax", lambda r: [_x(r, 3, 4)], {"axis": 0}),
    ("flatten", lambda r: [_x(r, 2, 3, 4)], {}),
    ("slice_axis", lambda r: [_x(r, 4, 5)], {"axis": 1, "begin": 1,
                                             "end": 4}),
    ("broadcast_add", lambda r: [_x(r, 3, 1), _x(r, 1, 4)], {}),
    ("broadcast_plus", lambda r: [_x(r, 3, 1), _x(r, 4)], {}),
    ("broadcast_sub", lambda r: [_x(r, 3, 4), _x(r, 4)], {}),
    ("broadcast_mul", lambda r: [_x(r, 3, 1), _x(r, 3, 4)], {}),
    ("broadcast_div", lambda r: [_x(r, 3, 4), _pos(r, 3, 1)], {}),
    ("broadcast_maximum", lambda r: [_x(r, 3, 4), _x(r, 4)], {}),
    ("broadcast_minimum", lambda r: [_x(r, 3, 4), _x(r, 4)], {}),
    ("elemwise_add", lambda r: [_x(r, 3), _x(r, 3)], {}),
    ("elemwise_sub", lambda r: [_x(r, 3), _x(r, 3)], {}),
    ("elemwise_mul", lambda r: [_x(r, 3), _x(r, 3)], {}),
    ("SequenceMask", lambda r: [_x(r, 4, 2, 3), onp.array([1, 3], "float32")],
     {}),
    ("SequenceLast", lambda r: [_x(r, 4, 2, 3), onp.array([1, 3], "float32")],
     {}),
    ("SequenceReverse",
     lambda r: [_x(r, 4, 2, 3), onp.array([1, 3], "float32")], {}),
    ("Activation", lambda r: [_x(r, 5)], {"act_type": "softrelu"}),
    ("FullyConnected", lambda r: [_x(r, 3, 4), _x(r, 2, 4), _x(r, 2)],
     {"num_hidden": 2}),
    ("Convolution", lambda r: [_x(r, 1, 2, 5, 5), _x(r, 3, 2, 3, 3)],
     {"kernel": (3, 3), "num_filter": 3, "no_bias": True}),
    ("Pooling", lambda r: [_x(r, 1, 2, 4, 4)], {"kernel": (2, 2),
                                                "stride": (2, 2)}),
    ("Embedding", lambda r: [onp.array([2, 0], "int32"), _x(r, 4, 3)],
     {"input_dim": 4, "output_dim": 3}),
    ("LeakyReLU", lambda r: [_x(r, 5)], {"slope": 0.1}),
    ("zeros_like", lambda r: [_x(r, 2, 3)], {}),
    ("where", lambda r: [_x(r, 4) > 0, _x(r, 4), _x(r, 4)], {}),
    ("split", lambda r: [_x(r, 4, 2)], {"indices_or_sections": 2}),
    ("reshape", lambda r: [_x(r, 4, 3)], {"newshape": (2, 6)}),
]


def _call(nd, np_, name, inputs, kw):
    def conv(a):
        if isinstance(a, list):
            return [np_.array(v) for v in a]
        return np_.array(a)

    res = getattr(nd, name)(*[conv(a) for a in inputs], **kw)
    res = res if isinstance(res, (list, tuple)) else [res]
    return [r.asnumpy() for r in res]


@pytest.mark.parametrize("i", range(len(CALLS)),
                         ids=[f"{c[0]}{i}" for i, c in enumerate(CALLS)])
def test_bound_function_matches_reference(i):
    from mxnet_tpu import nd as jnd
    from mxnet_tpu import np as jnp_

    from mxnet_tpu_torch import np as tnp

    name, make, kw = CALLS[i]
    inputs = make(onp.random.RandomState(i))
    want = _call(jnd, jnp_, name, inputs, kw)
    got = _call(tnd, tnp, name, inputs, kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if onp.issubdtype(w.dtype, onp.integer):
            onp.testing.assert_array_equal(g, w)
        else:
            assert _rel(g, w) <= RTOL, name


def test_creation_and_legacy_getattr():
    from mxnet_tpu import nd as jnd

    for name, args in (("ones", ((2, 3),)), ("zeros", ((4,),)),
                       ("full", ((2, 2), 7.0)), ("arange", (5,)),
                       ("eye", (3,))):
        g, w = getattr(tnd, name)(*args), getattr(jnd, name)(*args)
        onp.testing.assert_array_equal(g.asnumpy(), w.asnumpy())
        assert g.dtype == w.dtype, name
    x = onp.random.RandomState(1).randn(2, 3).astype("float32")
    for name in ("Flatten", "erf", "relu"):       # through __getattr__
        onp.testing.assert_allclose(
            getattr(tnd, name)(tnd.array(x)).asnumpy(),
            getattr(jnd, name)(jnd.array(x)).asnumpy(), rtol=1e-6)
    with pytest.raises(AttributeError):
        tnd.no_such_op
    tnd.waitall()


@pytest.mark.parametrize("kind", ["single", "list", "dict"])
def test_save_load_across_packages(tmp_path, kind):
    """Each package reads the other's file; the name need not end in .npz
    (``.params``)."""
    from mxnet_tpu import nd as jnd

    rng = onp.random.RandomState(2)
    vals = [rng.randn(2, 3).astype("float32"),
            onp.arange(4, dtype="int32")]

    def make(nd):
        arrs = [nd.array(v, dtype=v.dtype) for v in vals]
        return {"single": arrs[0], "list": arrs,
                "dict": {"w": arrs[0], "idx": arrs[1]}}[kind]

    def flat(x):
        if isinstance(x, dict):
            return [x[k].asnumpy() for k in sorted(x)]
        if isinstance(x, list):
            return [v.asnumpy() for v in x]
        return [x.asnumpy()]

    for writer, reader in ((tnd, jnd), (jnd, tnd)):
        path = str(tmp_path / f"{writer.__name__}.params")
        writer.save(path, make(writer))
        got = reader.load(path)
        assert type(got).__name__ == type(make(reader)).__name__
        for g, w in zip(flat(got), flat(make(reader))):
            onp.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_save_load_on_card(cuda, tmp_path):
    """Arrays on the card saved and loaded back onto the card, bitwise."""
    with tmx.gpu():
        a = tnd.array(onp.random.RandomState(3).randn(64, 32)
                      .astype("float32"))
        path = str(tmp_path / "a.params")
        tnd.save(path, {"a": a, "b": tnd.ones((3,))})
        back = tnd.load(path)
    assert back["a"]._data.device.type == "cuda"
    assert torch.equal(back["a"]._data, a._data)
    assert float(tnd.concat(back["b"], back["b"], dim=0).sum()) == 6.0
