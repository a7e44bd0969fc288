"""PyTorch/CUDA port: ``mx.np`` against the JAX package's, on the CPU.

Each case feeds the same numpy inputs (``RandomState(0)``) through the
reference's ``mxnet_tpu.np`` function and the port's of the same name and
compares value and dtype: the port must give the reference's x64-off dtypes
(int32 for integer data and ``arange``, float32 for float data), not
torch's int64/float64. Cases are grouped by family. Tolerances, each with
its reason:

- elementwise and shape ops: rtol 1e-5, atol 1e-6 (the same fp32 formula;
  transcendental functions may differ by a few ulps between XLA and torch);
- reductions, cumulative sums, statistics and interpolation: rtol 1e-5,
  atol 1e-5 (sums in another order);
- linear algebra: rtol 1e-4, atol 1e-4 (other factorisation routines);
  factors defined only up to sign (``qr``, ``svd``, ``eigh``) are compared
  through their products or invariants;
- integer, boolean and index results: exact.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import np as tnp
from mxnet_tpu_torch.base import dtype_name


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _ref():
    from mxnet_tpu import np as jnp_

    return jnp_


R = onp.random.RandomState(0)
X = R.randn(3, 4).astype("float32")
Y = R.randn(3, 4).astype("float32")
P = R.uniform(0.5, 2.0, (3, 4)).astype("float32")
U = R.uniform(-0.9, 0.9, (3, 4)).astype("float32")
I = R.randint(-5, 6, (3, 4)).astype("int32")
IP = R.randint(1, 6, (3, 4)).astype("int32")
B = R.rand(3, 4) > 0.5
C = R.rand(3, 4) > 0.5
V = R.randn(5).astype("float32")
M = R.randn(4, 5).astype("float32")
T3 = R.randn(2, 3, 4).astype("float32")
SPD = (lambda a: a @ a.T + 4 * onp.eye(4, dtype="float32"))(
    R.randn(4, 4).astype("float32"))
SQ = R.randn(4, 4).astype("float32") + 3 * onp.eye(4, dtype="float32")
NANS = onp.array([[1.0, onp.nan, 3.0], [onp.nan, onp.nan, 2.0]], "float32")

EW = dict(rtol=1e-5, atol=1e-6)
RED = dict(rtol=1e-5, atol=1e-5)
LIN = dict(rtol=1e-4, atol=1e-4)


def _conv(mod, a):
    if isinstance(a, onp.ndarray):
        return mod.array(a)
    if isinstance(a, list) and a and isinstance(a[0], onp.ndarray):
        return [mod.array(v) for v in a]
    return a


def _host(x):
    if isinstance(x, (tuple, list)):
        return type(x)(_host(v) for v in x)
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    return x


def _dtype(x):
    return dtype_name(x.dtype) if hasattr(x, "dtype") else type(x).__name__


def _check(want, got, tol):
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want)
        for w, g in zip(want, got):
            _check(w, g, tol)
        return
    if hasattr(want, "shape"):
        assert _dtype(got) == _dtype(want), (_dtype(got), _dtype(want))
        w, g = _host(want), _host(got)
        assert tuple(g.shape) == tuple(w.shape), (g.shape, w.shape)
        if w.dtype.kind in "fc":
            onp.testing.assert_allclose(g, w, equal_nan=True, **tol)
        else:
            onp.testing.assert_array_equal(g, w)
    else:
        assert got == pytest.approx(want, rel=tol["rtol"], abs=tol["atol"])


def _both(name, args, kwargs=None, tol=EW):
    kwargs = kwargs or {}
    ref = _ref()
    want = getattr(ref, name)(*[_conv(ref, a) for a in args], **kwargs)
    got = getattr(tnp, name)(*[_conv(tnp, a) for a in args], **kwargs)
    _check(want, got, tol)


# -- elementwise unary ---------------------------------------------------------
UNARY = [
    ("abs", X), ("absolute", X), ("negative", X), ("sign", X), ("exp", X),
    ("expm1", X), ("log", P), ("log2", P), ("log10", P), ("log1p", P),
    ("sqrt", P), ("cbrt", X), ("square", X), ("reciprocal", P), ("sin", X),
    ("cos", X), ("tan", U), ("arcsin", U), ("arccos", U), ("arctan", X),
    ("sinh", X), ("cosh", X), ("tanh", X), ("arcsinh", X),
    ("arccosh", P + 1), ("arctanh", U), ("floor", X * 3), ("ceil", X * 3),
    ("trunc", X * 3), ("rint", X * 3), ("fix", X * 3), ("isnan", NANS),
    ("isinf", onp.array([onp.inf, -onp.inf, 1.0], "float32")),
    ("isfinite", NANS),
    ("isposinf", onp.array([onp.inf, -onp.inf, 1.0], "float32")),
    ("isneginf", onp.array([onp.inf, -onp.inf, 1.0], "float32")),
    ("degrees", X), ("radians", X), ("erf", X), ("erfinv", U),
    ("gamma", P), ("gammaln", P), ("signbit", X), ("positive", X),
    ("deg2rad", X), ("rad2deg", X), ("exp2", X), ("i0", X), ("sinc", X),
    ("atleast_1d", onp.float32(2.0) * onp.ones((), "float32")),
    ("atleast_2d", V), ("atleast_3d", V), ("conj", X), ("real", X),
    ("imag", X), ("angle", X),
    # integer and boolean inputs: the reference's result dtypes
    ("abs", I), ("negative", I), ("sign", I), ("square", I), ("invert", I),
    ("floor", I), ("reciprocal", IP), ("sqrt", IP), ("exp", I),
    ("logical_not", B), ("invert", B),
]


@pytest.mark.parametrize("name,x", UNARY,
                         ids=[f"{n}-{x.dtype}-{i}"
                              for i, (n, x) in enumerate(UNARY)])
def test_unary(name, x):
    with onp.errstate(all="ignore"):
        _both(name, [x])


# -- elementwise binary --------------------------------------------------------
BINARY = [
    ("add", X, Y), ("subtract", X, Y), ("multiply", X, Y),
    ("true_divide", X, P), ("divide", X, P), ("floor_divide", X, P),
    ("mod", X, P), ("fmod", X, P), ("remainder", X, P), ("power", P, X),
    ("maximum", X, Y), ("minimum", X, Y), ("fmax", NANS, NANS[::-1]),
    ("fmin", NANS, NANS[::-1]), ("hypot", X, Y), ("arctan2", X, Y),
    ("logaddexp", X, Y), ("equal", I, IP), ("not_equal", I, IP),
    ("less", X, Y), ("less_equal", I, IP), ("greater", X, Y),
    ("greater_equal", I, IP), ("copysign", X, Y), ("nextafter", X, Y),
    ("heaviside", X, Y), ("float_power", P, X),
    ("add", I, IP), ("subtract", I, IP), ("multiply", I, IP),
    ("floor_divide", I, IP), ("mod", I, IP), ("true_divide", I, IP),
    ("bitwise_and", I, IP), ("bitwise_or", I, IP), ("bitwise_xor", I, IP),
    ("left_shift", IP, IP), ("right_shift", I * 8, IP), ("gcd", I, IP),
    ("lcm", I, IP), ("maximum", I, IP), ("add", X, I),
    ("logical_and", B, C), ("logical_or", B, C), ("logical_xor", B, C),
    # a Python scalar beside an array takes the array's dtype (weak type)
    ("add", X, 2), ("add", I, 2), ("multiply", I, 0.5), ("add", 2, X),
    ("subtract", 1, I), ("power", X, 2), ("true_divide", I, 2),
    ("greater", I, 0.5), ("maximum", X, 0.0), ("add", B, 1),
]


@pytest.mark.parametrize("name,a,b", BINARY,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(BINARY)])
def test_binary(name, a, b):
    _both(name, [a, b])


PRODUCTS = [
    ("matmul", [X, M], {}), ("dot", [V, V], {}), ("dot", [X, M], {}),
    ("dot", [T3, M], {}), ("dot", [X, 2.0], {}), ("inner", [X, Y], {}),
    ("outer", [V, V], {}), ("vdot", [X, Y], {}), ("kron", [X[:2, :2], Y],
                                                  {}),
    ("cross", [X[:, :3], Y[:, :3]], {}), ("tensordot", [X, M], {"axes": 1}),
    ("tensordot", [T3, X], {"axes": ([1, 2], [0, 1])}),
    ("einsum", ["ij,jk->ik", X, M], {}), ("einsum", ["bij->bji", T3], {}),
]


@pytest.mark.parametrize("name,args,kw", PRODUCTS,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(PRODUCTS)])
def test_products(name, args, kw):
    _both(name, args, kw, RED)


# -- reductions ----------------------------------------------------------------
REDUCTIONS = [
    ("sum", X, {}), ("sum", X, {"axis": 0}), ("sum", T3, {"axis": (0, 2)}),
    ("sum", X, {"axis": 1, "keepdims": True}), ("sum", I, {}),
    ("sum", B, {}), ("sum", I, {"dtype": "float32"}), ("mean", X, {}),
    ("mean", I, {"axis": 0}), ("mean", T3, {"axis": [1, 2]}),
    ("prod", P, {"axis": 1}), ("prod", T3, {"axis": (0, 2)}),
    ("std", X, {}), ("std", X, {"axis": 0, "ddof": 1}), ("var", X, {}),
    ("var", T3, {"axis": 1, "keepdims": True}), ("max", X, {}),
    ("max", X, {"axis": 1}), ("min", T3, {"axis": (0, 1)}),
    ("amax", I, {"axis": 0, "keepdims": True}), ("amin", X, {}),
    ("argmax", X, {}), ("argmax", X, {"axis": 1}), ("argmin", I,
                                                   {"axis": 0}),
    ("all", B, {}), ("all", B, {"axis": 0}), ("any", B, {"axis": 1}),
    ("cumsum", X, {}), ("cumsum", I, {"axis": 1}), ("cumprod", P,
                                                    {"axis": 0}),
    ("logsumexp", X, {"axis": 1}), ("nansum", NANS, {}),
    ("nanmean", NANS, {"axis": 1}), ("nanmax", NANS, {"axis": 0}),
    ("nanmin", NANS, {}), ("median", X, {}), ("median", X, {"axis": 0}),
    ("median", I, {"axis": 1}), ("average", X, {"axis": 1}),
    ("trace", X, {}), ("trace", T3, {"offset": 1, "axis1": 1, "axis2": 2}),
    ("count_nonzero", I, {}), ("count_nonzero", I, {"axis": 0}),
]


@pytest.mark.parametrize("name,x,kw", REDUCTIONS,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(REDUCTIONS)])
def test_reductions(name, x, kw):
    _both(name, [x], kw, RED)


def test_average_with_weights():
    ref = _ref()
    want = ref.average(ref.array(X), weights=ref.array(onp.abs(V[:4])),
                       axis=1)
    got = tnp.average(tnp.array(X), weights=tnp.array(onp.abs(V[:4])),
                      axis=1)
    _check(want, got, RED)


# -- shape and indexing --------------------------------------------------------
SHAPE = [
    ("reshape", [T3, (4, 6)], {}), ("reshape", [T3, (-1, 2)], {}),
    ("transpose", [T3], {}), ("transpose", [T3, (1, 0, 2)], {}),
    ("swapaxes", [T3, 0, 2], {}), ("moveaxis", [T3, 0, -1], {}),
    ("squeeze", [X[:, :1]], {}), ("squeeze", [T3[:1], 0], {}),
    ("expand_dims", [X, 1], {}), ("expand_dims", [X, (0, 3)], {}),
    ("broadcast_to", [V, (3, 5)], {}), ("tile", [X, (2, 1)], {}),
    ("tile", [V, 2], {}), ("repeat", [X, 2], {}), ("repeat", [X, 2, 1], {}),
    ("flip", [T3], {}), ("flip", [T3, 1], {}), ("flipud", [X], {}),
    ("fliplr", [X], {}), ("roll", [X, 1], {}), ("roll", [X, 2, 1], {}),
    ("rot90", [X], {}), ("ravel", [T3], {}),
    ("concatenate", [[X, Y]], {}), ("concatenate", [[X, Y]], {"axis": 1}),
    ("stack", [[X, Y]], {"axis": 1}), ("vstack", [[X, Y]], {}),
    ("hstack", [[X, Y]], {}), ("hstack", [[V, V]], {}),
    ("dstack", [[X, Y]], {}), ("column_stack", [[V, V]], {}),
    ("split", [T3, 2], {}), ("split", [X, [1, 3], 1], {}),
    ("array_split", [V, 3], {}), ("vsplit", [X[:2], 2], {}),
    ("hsplit", [X, 2], {}),
    ("pad", [X, 1], {}), ("pad", [X, ((1, 0), (0, 2))],
                          {"constant_values": 7.0}),
    ("pad", [X, 2], {"mode": "edge"}), ("pad", [X, 2], {"mode": "reflect"}),
    ("pad", [X, ((1, 2), (3, 1))], {"mode": "wrap"}),
    ("pad", [X, 2], {"mode": "symmetric"}),
    ("clip", [X, -0.5, 0.5], {}), ("clip", [X], {"a_min": 0.0}),
    ("round", [X * 10], {}), ("round", [X, 2], {}), ("around", [X * 3], {}),
    ("diag", [V], {}), ("diag", [X], {}), ("diag", [X, 1], {}),
    ("diagonal", [T3, 0, 1, 2], {}), ("tril", [X], {}), ("triu", [X, 1], {}),
    ("where", [B, X, Y], {}), ("where", [B, X, 0.0], {}),
    ("sort", [X], {}), ("sort", [X, 0], {}), ("sort", [I, None], {}),
    ("argsort", [I], {}), ("argsort", [X, 0], {}),
    ("searchsorted", [onp.sort(V), X], {}),
    ("searchsorted", [onp.sort(V), X], {"side": "right"}),
    ("take", [X, onp.array([0, 2, 5, -1, -9], "int32")], {}),
    ("take", [X, onp.array([[0, 3], [4, -1]], "int32"), 1], {}),
    ("take", [X, onp.array([0, 5, -1, -5], "int32"), 1], {"mode": "wrap"}),
    ("take", [X, onp.array([0, 4, -1, -5], "int32"), 1], {"mode": "fill"}),
    ("take_along_axis", [X, onp.argsort(X, 1).astype("int32"), 1], {}),
    ("take_along_axis", [X, onp.array([[0], [-1], [4]], "int32"), 1], {}),
    ("take_along_axis", [I, onp.array([[0, 1, 2, -4]], "int32"), 0], {}),
    ("gather_nd", [X, onp.array([[0, 2], [1, 3]], "int32")], {}),
    ("one_hot", [onp.array([0, 2, -1, 5], "int32"), 3], {}),
    ("one_hot", [onp.array([[1, 0]], "int32"), 4],
     {"on_value": 2.0, "off_value": -1.0}),
    ("meshgrid", [V[:3], V], {}), ("meshgrid", [V[:3], V],
                                   {"indexing": "ij"}),
    ("diff", [X], {}), ("diff", [X, 2, 0], {}), ("ediff1d", [X], {}),
    ("interp", [X, onp.sort(V), V * 2], {}), ("topk", [X], {"k": 2}),
    ("topk", [X], {"k": 2, "ret_typ": "value", "axis": 0}),
    ("topk", [X], {"k": 3, "ret_typ": "both", "is_ascend": True}),
    ("unique", [I], {}), ("unique", [I], {"return_counts": True}),
    ("nonzero", [I], {}), ("flatnonzero", [I], {}),
    ("flatnonzero", [I], {"size": 16}), ("append", [X, Y], {}),
    ("append", [X, Y, 0], {}), ("delete", [V, 1], {}),
    ("insert", [V, 1, 9.0], {}), ("trim_zeros", [onp.array(
        [0, 0, 1, 2, 0], "int32")], {}),
    ("broadcast_arrays", [V[None], X[:, :1]], {}),
    ("copy", [X], {}), ("astype", [X, "int32"], {}),
    ("astype", [I, "float64"], {}), ("astype", [X, "bfloat16"], {}),
    ("ascontiguousarray", [X], {}),
]


@pytest.mark.parametrize("name,args,kw", SHAPE,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(SHAPE)])
def test_shape_and_indexing(name, args, kw):
    if name in ("broadcast_arrays", "where"):
        args = [a for a in args]
    if name == "broadcast_arrays":
        ref = _ref()
        want = ref.broadcast_arrays(*[ref.array(a) for a in args])
        got = tnp.broadcast_arrays(*[tnp.array(a) for a in args])
        _check(list(want), list(got), EW)
        return
    _both(name, args, kw, EW)


def test_index_update_and_add_functional():
    ref = _ref()
    key = (onp.array([0, 2, 0], "int32"), slice(1, 3))
    for name in ("index_update", "index_add"):
        want = getattr(ref, name)(ref.array(X), key, ref.array(Y[:3, :2]))
        got = getattr(tnp, name)(tnp.array(X), key, tnp.array(Y[:3, :2]))
        if name == "index_update":   # a repeated index: any writer may win
            w, g = want.asnumpy(), got.asnumpy()
            onp.testing.assert_array_equal(g[1], w[1])
            assert {tuple(g[0, 1:3])} <= {tuple(Y[0, :2]), tuple(Y[2, :2])}
        else:
            _check(want, got, EW)


# -- creation ------------------------------------------------------------------
CREATION = [
    ("zeros", [(2, 3)], {}), ("zeros", [4], {"dtype": "int32"}),
    ("ones", [(2, 3)], {"dtype": "float16"}), ("full", [(2, 2), 3], {}),
    ("full", [(2, 2), 2.5], {}), ("full", [3, True], {}),
    ("full", [(2,), 7], {"dtype": "float32"}), ("empty", [(2, 2)], {}),
    ("zeros_like", [I], {}), ("ones_like", [X], {}),
    ("full_like", [I, 4], {}), ("full_like", [X, 0.5], {"dtype": "int32"}),
    ("empty_like", [X], {}), ("arange", [5], {}), ("arange", [2, 11, 3], {}),
    ("arange", [0.5, 3], {}), ("arange", [0, 1, 0.25], {}),
    ("arange", [5], {"dtype": "float32"}), ("linspace", [0, 1, 5], {}),
    ("linspace", [0, 1, 5], {"endpoint": False}),
    ("linspace", [-1.0, 2.0, 7], {"retstep": True}),
    ("logspace", [0, 2, 5], {}), ("eye", [3], {}), ("eye", [3, 4, 1], {}),
    ("identity", [3], {"dtype": "int32"}), ("tri", [3, 4, -1], {}),
    ("indices", [(2, 3)], {}),
    ("array", [[1, 2, 3]], {}), ("array", [[1.5, 2.0]], {}),
    ("array", [onp.arange(3, dtype="int64")], {}),
    ("array", [onp.arange(3, dtype="float64")], {}),
    ("array", [[True, False]], {}), ("array", [[1, 2]], {"dtype": "float32"}),
    ("array", [onp.array([1, 2], "uint64")], {}),
    ("array", [onp.array([1, 2], "uint8")], {}),
    ("asarray", [[1.0, 2.0]], {}), ("asarray", [[1, 2]], {"dtype": "int8"}),
]


@pytest.mark.parametrize("name,args,kw", CREATION,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(CREATION)])
def test_creation(name, args, kw):
    if name in ("array", "asarray"):
        ref = _ref()
        _check(getattr(ref, name)(*args, **kw),
               getattr(tnp, name)(*args, **kw), EW)
        return
    _both(name, args, kw, EW)


def test_creation_places_on_ctx_and_device():
    a = tnp.zeros((2,), ctx=tmx.cpu())
    b = tnp.arange(3, device="cpu")
    c = tnp.ones((1,), ctx=torch.device("cpu"))
    for arr in (a, b, c):
        assert arr.ctx == tmx.cpu() and arr._data.device.type == "cpu"
    assert tnp.array([1.0], ctx=tmx.cpu()).ctx.device_type == "cpu"


# -- statistics, linear algebra and the rest -----------------------------------
MISC = [
    ("nan_to_num", [NANS], {}), ("nan_to_num", [NANS], {"nan": -1.0}),
    ("divmod", [X, P], {}), ("digitize", [X, onp.sort(V)], {}),
    ("digitize", [X, onp.sort(V)], {"right": True}), ("corrcoef", [M], {}),
    ("cov", [M], {}), ("quantile", [X, 0.3], {}),
    ("quantile", [X, [0.25, 0.75]], {"axis": 0}),
    ("quantile", [X, 0.5], {"axis": 1, "keepdims": True}),
    ("percentile", [X, 40], {}),
    ("percentile", [X, 50], {"interpolation": "nearest"}),
    ("histogram", [X], {"bins": 4}), ("histogram", [X], {"bins": 3,
                                                          "range": (-1, 1)}),
    ("isclose", [X, X + 1e-7], {}), ("isclose", [X, Y], {}),
]


@pytest.mark.parametrize("name,args,kw", MISC,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(MISC)])
def test_statistics_and_misc(name, args, kw):
    _both(name, args, kw, RED)


def test_scalar_predicates():
    ref = _ref()
    for name, args in (("allclose", [X, X]), ("allclose", [X, Y]),
                       ("array_equal", [I, I]), ("array_equal", [I, IP]),
                       ("shape", [T3]), ("size", [T3]), ("ndim", [T3])):
        assert getattr(tnp, name)(*[tnp.array(a) for a in args]) == \
            getattr(ref, name)(*[ref.array(a) for a in args]), name
    assert tnp.size(tnp.array(T3), 1) == 3
    assert str(tnp.result_type(tnp.array(I), tnp.array(X))) == \
        str(ref.result_type(ref.array(I), ref.array(X)))
    assert tnp.isscalar(3.0) and not tnp.isscalar(tnp.array(X))


LINALG = [
    ("norm", [X], {}), ("norm", [X], {"axis": 1}), ("norm", [X], {"ord": 1}),
    ("norm", [V], {"ord": onp.inf}), ("inv", [SQ], {}), ("pinv", [M], {}),
    ("det", [SQ], {}), ("slogdet", [SQ], {}), ("cholesky", [SPD], {}),
    ("eigvalsh", [SPD], {}), ("solve", [SQ, X.T], {}),
    ("lstsq", [M.T, V], {}), ("matrix_power", [SQ, 3], {}),
    ("matrix_rank", [M], {}), ("multi_dot", [[X, M, M.T]], {}),
    ("tensorinv", [SQ.reshape(2, 2, 2, 2)], {"ind": 2}),
    ("tensorsolve", [SQ.reshape(2, 2, 4), V[:4].reshape(2, 2)], {}),
]


@pytest.mark.parametrize("name,args,kw", LINALG,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(LINALG)])
def test_linalg(name, args, kw):
    ref = _ref()
    conv = (lambda m, a: [m.array(v) for v in a]
            if isinstance(a, list) else _conv(m, a))
    want = getattr(ref.linalg, name)(*[conv(ref, a) for a in args], **kw)
    got = getattr(tnp.linalg, name)(*[conv(tnp, a) for a in args], **kw)
    _check(want, got, LIN)


def test_linalg_factorisations_up_to_sign():
    a = tnp.array(M)
    q, r = tnp.linalg.qr(a)
    onp.testing.assert_allclose((q @ r).asnumpy(), M, **LIN)
    u, s, vh = tnp.linalg.svd(a, full_matrices=False)
    onp.testing.assert_allclose(((u * s) @ vh).asnumpy(), M, **LIN)
    ref = _ref()
    onp.testing.assert_allclose(
        s.asnumpy(), ref.linalg.svd(ref.array(M), compute_uv=False)
        .asnumpy(), **LIN)
    w, v = tnp.linalg.eigh(tnp.array(SPD))
    onp.testing.assert_allclose(
        (v @ tnp.diag(w) @ v.T).asnumpy(), SPD, **LIN)
    assert dtype_name(q.dtype) == dtype_name(s.dtype) == "float32"


# -- not ported: named errors --------------------------------------------------
_STRAGGLERS = {
    "diagflat": (lambda m: m.diagflat(m.array(X[0]), 1),
                 lambda: onp.diagflat(X[0], 1)),
    "fill_diagonal": (lambda m: _filled(m), lambda: _filled(onp)),
    "rollaxis": (lambda m: m.rollaxis(m.array(X[None]), 2),
                 lambda: onp.rollaxis(X[None], 2)),
    "polyval": (lambda m: m.polyval(m.array(X[0]), m.array(X[1])),
                lambda: onp.polyval(X[0], X[1])),
    "blackman": (lambda m: m.blackman(7), lambda: onp.blackman(7)),
    "hamming": (lambda m: m.hamming(6), lambda: onp.hamming(6)),
    "hanning": (lambda m: m.hanning(5), lambda: onp.hanning(5)),
    "tril_indices": (lambda m: m.tril_indices(4, 1),
                     lambda: onp.tril_indices(4, 1)),
}


def _filled(m):
    a = m.array(M) if m is not onp else M.copy()
    m.fill_diagonal(a, 5.0)
    return a


@pytest.mark.parametrize("name", ["diagflat", "fill_diagonal", "rollaxis",
                                  "polyval", "blackman", "hamming",
                                  "hanning", "tril_indices"])
def test_ops_outside_the_slice_raise_naming_the_roadmap_item(name):
    """These functions were left for ROADMAP A9; they run now, over the
    ops of ops/extra.py, and agree with numpy (float32, 1e-6)."""
    port, ref = _STRAGGLERS[name]
    got, want = port(tnp), ref()
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        onp.testing.assert_allclose(g.asnumpy(), w, rtol=1e-6, atol=1e-6)


def test_np_random_is_not_ported():
    """``mx.np.random`` was not ported until the samplers came; now it is
    the port's ``random`` module, as the reference's is its own
    (``tests/test_torch_random.py`` holds the samplers)."""
    import mxnet_tpu_torch.random as trandom

    assert tnp.random is trandom
    got = tnp.random.randint(0, 7, size=(3, 4), ctx="cpu")
    assert isinstance(got, tnp.ndarray) and got.shape == (3, 4)
    assert dtype_name(got.dtype) == "int32"


# -- the numpy dispatch protocol and save / load -------------------------------
def test_numpy_functions_dispatch_to_mx_np():
    a = tnp.array(X)
    out = onp.concatenate([a, a])
    assert isinstance(out, tnp.ndarray) and out.shape == (6, 4)
    assert isinstance(onp.exp(a), tnp.ndarray)
    onp.testing.assert_allclose(onp.exp(a).asnumpy(), onp.exp(X), **EW)
    assert isinstance(onp.percentile(a, 50), tnp.ndarray)
    assert isinstance(onp.fliplr(a), onp.ndarray)   # host fallback


def test_save_load_crosses_packages(tmp_path):
    ref = _ref()
    tnp.save(str(tmp_path / "p.npy"), tnp.array(I))
    got = ref.load(str(tmp_path / "p.npy"))
    _check(ref.array(I), got, EW)
    ref.savez(str(tmp_path / "r.npz"), a=ref.array(X),
              b=ref.array(X).astype("bfloat16"), c=ref.array(I))
    back = tnp.load(str(tmp_path / "r.npz"))
    assert sorted(back) == ["a", "b", "c"]
    _check(ref.array(X), back["a"], EW)
    assert dtype_name(back["b"].dtype) == "float32"   # bf16 saved as fp32
    _check(ref.array(I), back["c"], EW)
    tnp.savez_compressed(str(tmp_path / "t.npz"),
                         tnp.array(X).astype("bfloat16"))
    raw = onp.load(str(tmp_path / "t.npz"))["arr_0"]
    assert raw.dtype == onp.float32
    onp.testing.assert_array_equal(
        raw, ref.array(X).astype("bfloat16").astype("float32").asnumpy())
    onp.save(str(tmp_path / "w.npy"), onp.arange(3, dtype="int64"))
    assert dtype_name(tnp.load(str(tmp_path / "w.npy")).dtype) == "int32"
