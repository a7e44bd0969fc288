"""PyTorch/CUDA port: the norms, ``ReflectionPad2D`` and the initializers
against the JAX package's, with the same numpy inputs and weights.

Checked, each with its tolerance:

- the ``group_norm``, ``instance_norm`` and ``rms_norm`` ops through
  ``mx.npx``: output and the gradients of x, gamma and beta within 1e-5 of
  each tensor's largest entry (fp32 sums in another order); ``rms_norm`` on
  bf16 input bitwise equal (its ``rsqrt`` cast to bf16 before the
  product); ``smooth_l1`` bitwise; under AMP the norms follow their inputs
  in both packages;
- the layers ``GroupNorm``, ``InstanceNorm``, ``RMSNorm``,
  ``SyncBatchNorm``, ``BatchNormReLU`` and ``ReflectionPad2D`` (int,
  4-tuple and 8-tuple padding): the same parameter names, deferred
  ``in_channels``, the port's ``.params`` file loaded by the reference,
  output and input gradient eager and hybridized within 1e-5;
  ``ReflectionPad2D`` and the norms exported by the port and imported by
  both packages within 1e-5; the reference's ``test_layernorm_groupnorm``;
- ``Orthogonal`` by its property (rows or columns orthonormal times
  ``scale`` within 1e-5: the draws differ between packages);
  ``Bilinear``, ``LSTMBias``, ``Load`` (a dict and a ``.params`` file),
  ``Mixed`` and ``InitDesc`` bitwise against the reference; every
  registered name creatable.

The JAX package is imported inside the tests that use it, so
``pytest --noconftest tests/test_torch_norms.py -m cuda`` collects this
file on a machine without JAX.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import initializer as tinit

RTOL = 1e-5
X = onp.random.RandomState(0).randn(2, 6, 4, 5).astype("float32")


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _rel(got, want):
    got = onp.asarray(got, dtype="float64")
    want = onp.asarray(want, dtype="float64")
    return float(abs(got - want).max() / max(abs(want).max(), 1e-30))


def _jax():
    import mxnet_tpu

    return mxnet_tpu


def _op_inputs(op):
    rs = onp.random.RandomState(1)
    g = (1 + 0.1 * rs.randn(X.shape[-1] if op == "rms_norm" else 6)) \
        .astype("float32")
    b = (0.1 * rs.randn(6)).astype("float32")
    return [X, g] if op == "rms_norm" else [X, g, b]


_OP_KW = {"group_norm": dict(num_groups=3, eps=1e-5),
          "instance_norm": dict(eps=1e-4), "rms_norm": dict(eps=1e-6)}


def _op_run(pkg, op, inputs):
    """Output and the gradients of every input of ``op`` under a weighted
    sum."""
    arrs = [pkg.np.array(a) for a in inputs]
    for a in arrs:
        a.attach_grad()
    w = pkg.np.array(onp.random.RandomState(2).randn(*X.shape)
                     .astype("float32"))
    with pkg.autograd.record():
        y = getattr(pkg.npx, op)(*arrs, **_OP_KW[op])
        (y * w).sum().backward()
    return [y.asnumpy()] + [a.grad.asnumpy() for a in arrs]


@pytest.mark.parametrize("op", sorted(_OP_KW))
def test_norm_ops_match_the_reference(op):
    inputs = _op_inputs(op)
    want = _op_run(_jax(), op, inputs)
    got = _op_run(tmx, op, inputs)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape
        assert _rel(g, w) <= RTOL, (op, i)


def test_rms_norm_bf16_rounds_as_the_reference():
    mx = _jax()
    g = onp.random.RandomState(3).randn(5).astype("float32")
    want = mx.npx.rms_norm(mx.np.array(X).astype("bfloat16"),
                           mx.np.array(g).astype("bfloat16"))
    got = tmx.npx.rms_norm(tmx.np.array(X).astype("bfloat16"),
                           tmx.np.array(g).astype("bfloat16"))
    assert got._data.dtype == torch.bfloat16
    onp.testing.assert_array_equal(onp.asarray(got.asnumpy(), "float32"),
                                   onp.asarray(want.asnumpy(), "float32"))


def test_smooth_l1_matches_the_reference():
    mx = _jax()
    for scalar in (1.0, 2.5):
        onp.testing.assert_array_equal(
            tmx.npx.smooth_l1(tmx.np.array(X), scalar=scalar).asnumpy(),
            mx.npx.smooth_l1(mx.np.array(X), scalar=scalar).asnumpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_follow_their_inputs_under_amp(dtype):
    """The norms are in AMP's fp32 list: never cast down; each follows the
    promotion of its operands (bf16 x with float32 gamma gives float32), in
    both packages alike."""
    mx = _jax()
    seen = []
    for pkg in (mx, tmx):
        pkg.amp.init("bfloat16")
        try:
            x = pkg.np.array(X).astype(dtype)
            g = pkg.np.array(onp.ones(6, "float32"))
            out = [pkg.npx.group_norm(x, g, g, num_groups=2),
                   pkg.npx.instance_norm(x, g, g),
                   pkg.npx.rms_norm(x, pkg.np.array(onp.ones(5, "float32")))]
        finally:
            pkg.amp.disable()
        seen.append([tmx.base.dtype_name(o.dtype) if pkg is tmx else
                     str(o.dtype) for o in out])
    assert seen[0] == seen[1] == ["float32"] * 3


# -- layers ------------------------------------------------------------------------
_LAYERS = {
    "group_norm": lambda nn: nn.GroupNorm(num_groups=3),
    "instance_norm": lambda nn: nn.InstanceNorm(epsilon=1e-4),
    "rms_norm": lambda nn: nn.RMSNorm(),
    "sync_batch_norm": lambda nn: nn.SyncBatchNorm(),
    "batch_norm_relu": lambda nn: nn.BatchNormReLU(),
    "pad_int": lambda nn: nn.ReflectionPad2D(2),
    "pad_4": lambda nn: nn.ReflectionPad2D((1, 3, 2, 0)),
    "pad_8": lambda nn: nn.ReflectionPad2D((0, 0, 0, 0, 3, 1, 0, 2)),
}


def _layer_weights(net):
    rs = onp.random.RandomState(4)
    return {n: (1 + 0.1 * rs.randn(*p.shape) if "gamma" in n or "var" in n
                else 0.1 * rs.randn(*p.shape)).astype("float32")
            for n, p in net.collect_params().items()}


def _layer_run(pkg, net, hybridize):
    if hybridize:
        net.hybridize()
    x = pkg.np.array(X)
    x.attach_grad()
    w = None
    with pkg.autograd.record():
        y = net(x)
        w = pkg.np.array(onp.random.RandomState(5).randn(*y.shape)
                         .astype("float32"))
        (y * w).sum().backward()
    return y.asnumpy(), x.grad.asnumpy()


@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("name", sorted(_LAYERS))
def test_layers_match_the_reference(name, hybridize, tmp_path):
    mx = _jax()
    tnet = _LAYERS[name](tmx.gluon.nn)
    tnet.initialize()
    tnet(tmx.np.array(X))               # deferred in_channels settle here
    jnet = _LAYERS[name](mx.gluon.nn)
    jnet.initialize()
    jnet(mx.np.array(X))
    assert sorted(tnet.collect_params()) == sorted(jnet.collect_params())
    if tnet.collect_params():
        tnet.load_dict(_layer_weights(tnet))
        path = str(tmp_path / "layer.params")
        tnet.save_parameters(path)
        jnet.load_parameters(path)
    want = _layer_run(mx, jnet, hybridize)
    got = _layer_run(tmx, tnet, hybridize)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g, w) <= RTOL


def test_norm_layers_take_in_channels_and_freeze_with_center_scale():
    nn = tmx.gluon.nn
    for layer in (nn.GroupNorm(2, in_channels=6, center=False),
                  nn.InstanceNorm(in_channels=6, scale=False),
                  nn.RMSNorm(in_channels=5)):
        assert all(not p.is_deferred for p in layer.collect_params().values())
        layer.initialize()
        assert tuple(layer(tmx.np.array(X)).shape) == X.shape
    assert nn.GroupNorm(2, center=False).beta.grad_req == "null"
    assert nn.InstanceNorm(scale=False).gamma.grad_req == "null"
    with pytest.raises(MXNetError, match="ReflectionPad2D"):
        nn.ReflectionPad2D((1, 2, 3))


def test_layernorm_groupnorm():
    """The reference's case (tests/test_gluon.py:140)."""
    x = tmx.np.random.uniform(size=(2, 6, 4))
    ln = tmx.gluon.nn.LayerNorm()
    ln.initialize()
    out = ln(x).asnumpy()
    assert onp.allclose(out.mean(-1), 0, atol=1e-5)
    assert onp.allclose(out.std(-1), 1, atol=1e-2)
    gn = tmx.gluon.nn.GroupNorm(num_groups=3)
    gn.initialize()
    assert gn(x).shape == x.shape


def test_pad_and_norms_export_to_both_packages(tmp_path):
    mx = _jax()
    nn = tmx.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.ReflectionPad2D(2), nn.GroupNorm(2, in_channels=6),
            nn.InstanceNorm(in_channels=6))
    net.initialize()
    net.load_dict(_layer_weights(net))
    net.hybridize()
    want = net(tmx.np.array(X)).asnumpy()
    sym_file, param_file = net.export(str(tmp_path / "pad"))
    back = tmx.gluon.SymbolBlock.imports(sym_file, "data0", param_file)
    assert _rel(back(tmx.np.array(X)).asnumpy(), want) <= RTOL
    jback = mx.gluon.SymbolBlock.imports(sym_file, "data0", param_file)
    assert _rel(jback(mx.np.array(X)).asnumpy(), want) <= RTOL


# -- initializers --------------------------------------------------------------------
@pytest.mark.parametrize("shape,scale", [((6, 10), 1.414), ((12, 4), 2.0),
                                         ((4, 2, 3, 3), 1.0)])
def test_orthogonal_is_orthogonal_times_scale(shape, scale):
    t = torch.empty(shape)
    tinit.Orthogonal(scale=scale)("w", t, torch.Generator().manual_seed(0))
    m = t.reshape(shape[0], -1).double()
    gram = m @ m.T if m.shape[0] <= m.shape[1] else m.T @ m
    eye = torch.eye(gram.shape[0], dtype=torch.float64)
    assert float((gram / scale ** 2 - eye).abs().max()) <= RTOL
    other = torch.empty(shape)
    tinit.Orthogonal(scale=scale)("w", other,
                                  torch.Generator().manual_seed(1))
    assert not torch.equal(t, other)


def _jax_fill(init, name, shape):
    from mxnet_tpu.ndarray.ndarray import NDArray

    arr = NDArray(onp.zeros(shape, "float32"))
    init(name, arr)
    return arr.asnumpy()


def _port_fill(init, name, shape):
    t = torch.zeros(shape)
    init(name, t, torch.Generator().manual_seed(0))
    return t.numpy()


_LOADED = {"dense0_weight": onp.arange(6, dtype="float32").reshape(2, 3),
           "arg:dense0_bias": onp.array([7.0, 8.0], "float32")}


def _inits(pkg, tmp_path):
    I = pkg.initializer
    path = str(tmp_path / "init.params.npz")
    onp.savez(path, **_LOADED)
    loaded = {k: pkg.np.array(v) for k, v in _LOADED.items()}
    return {
        "bilinear": (I.Bilinear(), "upsampling_weight", (2, 1, 4, 4)),
        "lstm_bias_weight_name": (I.LSTMBias(forget_bias=2.0), "lstm_i2h",
                                  (12,)),
        "lstm_bias_bias_name": (I.LSTMBias(), "lstm_i2h_bias", (8,)),
        "load_dict": (I.Load(loaded), "dense0_weight", (2, 3)),
        "load_dict_prefix": (I.Load(loaded), "dense0_bias", (2,)),
        "load_default": (I.Load(loaded, default_init=I.Constant(3.0)),
                         "other_weight", (2, 2)),
        "load_file": (I.Load(path), "dense0_weight", (2, 3)),
        "mixed": (I.Mixed(["conv.*", ".*"], [I.Constant(1.5), I.One()]),
                  "conv0_weight", (2, 2)),
        "mixed_fallback": (I.Mixed(["conv.*", ".*"],
                                   [I.Constant(1.5), I.Constant(-2.0)]),
                           "dense_weight", (3,)),
        "init_desc_attr": (I.Uniform(), I.InitDesc("w", attrs={
            "__init__": "ones"}), (2, 2)),
        "init_desc_global": (I.Uniform(), I.InitDesc(
            "w", global_init=I.Constant(0.25)), (2, 2)),
    }


_INIT_CASES = ["bilinear", "lstm_bias_weight_name", "lstm_bias_bias_name",
               "load_dict", "load_dict_prefix", "load_default", "load_file",
               "mixed", "mixed_fallback", "init_desc_attr",
               "init_desc_global"]


@pytest.mark.parametrize("case", _INIT_CASES)
def test_initializers_match_the_reference(case, tmp_path):
    mx = _jax()
    ti, name, shape = _inits(tmx, tmp_path)[case]
    ji, jname, _ = _inits(mx, tmp_path)[case]
    if isinstance(name, tinit.InitDesc):
        jname = mx.initializer.InitDesc(str(name), name.attrs,
                                        ji if name.global_init is None else
                                        mx.initializer.Constant(0.25))
    onp.testing.assert_array_equal(_port_fill(ti, name, shape),
                                   _jax_fill(ji, jname, shape))


def test_load_and_mixed_raise_as_the_reference():
    with pytest.raises(MXNetError, match="target shape"):
        _port_fill(tinit.Load(_LOADED), "dense0_weight", (3, 2))
    with pytest.raises(MXNetError, match="no default"):
        _port_fill(tinit.Load(_LOADED), "missing", (1,))
    with pytest.raises(MXNetError, match="fallback"):
        _port_fill(tinit.Mixed(["conv.*"], [tinit.One()]), "dense", (1,))


@pytest.mark.parametrize("name", ["orthogonal", "bilinear", "lstmbias",
                                  "mixed", "load"])
def test_new_initializers_create_by_name(name):
    kw = {"mixed": dict(patterns=[".*"], initializers=[tinit.One()]),
          "load": dict(param={})}.get(name, {})
    assert type(tinit.create(name, **kw)).__name__.lower() == name


# -- on the card ---------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_norms_and_pad_on_card_match_the_cpu(cuda, dtype):
    """Forward and the input's gradient under a seeded upstream gradient
    (a plain sum of squares has a zero gradient through a norm, leaving
    rounding noise to compare), the same gamma and beta on both: the card
    against the CPU, fp32 within 1e-5 and bf16 within 2^-5 of each tensor's
    largest entry (a group's bf16 mean or variance rounded the other way
    moves its outputs by a bf16 step, and the backward's two sums add two
    more; bf16 against fp32 on the CPU is up to 8.4e-3 here)."""
    tol = RTOL if dtype == torch.float32 else 2 ** -5
    nn = tmx.gluon.nn
    up = onp.random.RandomState(7).randn(2, 6, 8, 9).astype("float32")
    for make in (lambda: nn.GroupNorm(3, in_channels=6),
                 lambda: nn.InstanceNorm(in_channels=6),
                 lambda: nn.RMSNorm(in_channels=5),
                 lambda: nn.ReflectionPad2D(2)):
        outs = []
        for ctx, dev in ((tmx.cpu(), "cpu"), (tmx.gpu(), cuda)):
            with ctx:
                net = make()
                net.initialize()
                net.load_dict(_layer_weights(net))
                x = torch.tensor(X, device=dev, dtype=dtype,
                                 requires_grad=True)
                y = net(x)
                g = torch.tensor(up[tuple(slice(0, n) for n in y.shape)],
                                 device=dev, dtype=y.dtype)
                (y * g).sum().backward()
            outs.append((y.detach().float().cpu(), x.grad.float().cpu()))
        for a, b in zip(*outs):
            assert _rel(b, a) <= tol
