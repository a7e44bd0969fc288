"""PyTorch/CUDA port: convolution, pooling and BatchNorm through ``mx.npx``
against the JAX package, on the CPU; ``Xavier``/``MSRAPrelu`` and the
initializers' fill by name.

The same numpy inputs (``RandomState``) go through each ``npx`` op of both
packages under ``autograd.record()``; values, dtypes and the gradients of a
seeded head gradient are compared. The grid covers what ResNet uses and
what the reference's ops accept besides: 1-D, 2-D and 3-D convolutions
with stride, padding, dilation, groups, with and without bias, channels
first and last; max and average pooling, global, ``ceil_mode``,
``count_include_pad`` and padding above half the kernel (which torch's
pooling refuses); ``adaptive_avg_pool2d`` with its error on sizes that do
not divide; ``batch_norm`` in train and predict modes with ``fix_gamma``,
``use_global_stats``, ``axis=-1`` and one value per channel, all three
outputs. Tolerances, each with its reason:

- fp32 values rtol 1e-4, atol 1e-5, gradients the same (the same formulas
  in fp32, sums in another order: torch's convolution and pooling against
  XLA's);
- bf16 under AMP: two bf16 steps (2 x 2^-7) of the largest entry (the
  reference rounds the convolution and its bias add apart, torch's
  convolution adds the bias before its one rounding; sums in another
  order);
- initializers: the random streams of the two packages differ, so draws
  are held by shape and moments (max |w| within the bound, std within 5 %
  of the formula's at 294 912 draws), the fill by name exactly.

A ``cuda``-marked case runs every op of the grid on the card against the
same op on the CPU (TF32 off, the same tolerances).
"""
import math

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch import np as tnp
from mxnet_tpu_torch import npx as tnpx
from mxnet_tpu_torch.base import dtype_name

VAL = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _ref():
    import mxnet_tpu as mx

    return mx


def _run(mx, op, arrays, kwargs, wrt, head, train=True):
    xs = [mx.np.array(a) if isinstance(a, onp.ndarray) else a
          for a in arrays]
    for i in wrt:
        xs[i].attach_grad()
    with mx.autograd.record(train_mode=train):
        ys = getattr(mx.npx, op)(*xs, **kwargs)
        y = ys[0] if isinstance(ys, tuple) else ys
    if wrt:
        y.backward(mx.np.array(head))
    return ys, [xs[i].grad for i in wrt]


def _close(want, got, tol):
    assert dtype_name(got.dtype) == dtype_name(want.dtype), \
        (got.dtype, want.dtype)
    w, g = want.asnumpy(), got.asnumpy()
    assert g.shape == w.shape
    onp.testing.assert_allclose(g, w, equal_nan=True, **tol)


def _both(op, arrays, kwargs, wrt=(0,), train=True, seed=0):
    ys, _ = _run(tmx, op, arrays, kwargs, (), None, train)
    y = ys[0] if isinstance(ys, tuple) else ys
    head = onp.random.RandomState(seed).randn(*y.shape).astype("float32")
    yj, gj = _run(_ref(), op, arrays, kwargs, wrt, head, train)
    yt, gt = _run(tmx, op, arrays, kwargs, wrt, head, train)
    for w, g in zip(yj if isinstance(yj, tuple) else (yj,),
                    yt if isinstance(yt, tuple) else (yt,)):
        _close(w, g, VAL)
    for w, g in zip(gj, gt):
        _close(w, g, GRAD)
    return yt


R = onp.random.RandomState(4)


def _r(*shape):
    return R.randn(*shape).astype("float32")


X1 = _r(2, 4, 11)              # NCW
X2 = _r(2, 4, 9, 10)           # NCHW
X3 = _r(1, 2, 5, 6, 7)         # NCDHW
W1 = _r(6, 4, 3)
W1G = _r(6, 2, 3)
W2 = _r(6, 4, 3, 3)
W2G = _r(6, 2, 3, 2)
W3 = _r(3, 2, 2, 3, 2)
B6 = _r(6)
B3 = _r(3)
NHWC = onp.ascontiguousarray(X2.transpose(0, 2, 3, 1))
NWC = onp.ascontiguousarray(X1.transpose(0, 2, 1))
NDHWC = onp.ascontiguousarray(X3.transpose(0, 2, 3, 4, 1))

CONV = [
    ("1d-stride-pad", [X1, W1, B6], dict(kernel=(3,), stride=(2,),
                                         pad=(1,), num_filter=6)),
    ("1d-groups-nwc", [NWC, W1G], dict(kernel=(3,), dilate=(2,),
                                       num_filter=6, num_group=2,
                                       layout="NWC")),
    ("2d-bias", [X2, W2, B6], dict(kernel=(3, 3), stride=(1, 1),
                                   pad=(1, 1), num_filter=6)),
    ("2d-stride-dilate", [X2, W2], dict(kernel=(3, 3), stride=(2, 1),
                                        dilate=(1, 2), pad=(1, 0),
                                        num_filter=6)),
    ("2d-groups", [X2, W2G, B6], dict(kernel=(3, 2), stride=(2, 2),
                                      num_filter=6, num_group=2)),
    ("2d-nhwc", [NHWC, W2, B6], dict(kernel=(3, 3), stride=(2, 2),
                                     pad=(1, 1), num_filter=6,
                                     layout="NHWC")),
    ("3d", [X3, W3, B3], dict(kernel=(2, 3, 2), stride=(1, 2, 2),
                              pad=(1, 0, 1), num_filter=3)),
    ("3d-ndhwc", [NDHWC, W3], dict(kernel=(2, 3, 2), dilate=(2, 1, 1),
                                   num_filter=3, layout="NDHWC")),
]


@pytest.mark.parametrize("case", CONV, ids=[c[0] for c in CONV])
def test_convolution_matches_reference(case):
    _, arrays, kw = case
    _both("convolution", arrays, kw, wrt=tuple(range(len(arrays))))


P7 = _r(2, 3, 7, 7)
P5 = _r(1, 2, 5, 6)

POOL = [
    ("max-3-2-1", P7, dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1))),
    ("avg-3-2-1", P7, dict(kernel=(3, 3), pool_type="avg", stride=(2, 2),
                           pad=(1, 1))),
    ("avg-3-2-1-exclude-pad", P7, dict(kernel=(3, 3), pool_type="avg",
                                       stride=(2, 2), pad=(1, 1),
                                       count_include_pad=False)),
    ("max-ceil", P5, dict(kernel=(2, 2), stride=(2, 2), ceil_mode=True)),
    ("avg-ceil-2-2-0", P5, dict(kernel=(2, 2), pool_type="avg",
                                stride=(2, 2), ceil_mode=True)),
    ("avg-ceil-3-2-1-exclude-pad", P7, dict(
        kernel=(3, 3), pool_type="avg", stride=(2, 2), pad=(1, 1),
        ceil_mode=True, count_include_pad=False)),
    ("avg-ceil-3-2-0", P7, dict(kernel=(3, 3), pool_type="avg",
                                stride=(2, 2), ceil_mode=True)),
    # the last window starts in the right padding: torch drops it, the
    # reference keeps it (max -inf never wins inside it; an average of
    # padding counts the symmetric pad only)
    ("avg-ceil-window-in-pad", P5, dict(kernel=(2, 2), pool_type="avg",
                                        stride=(2, 2), pad=(1, 1),
                                        ceil_mode=True)),
    ("max-ceil-window-in-pad", P5, dict(kernel=(2, 2), stride=(2, 2),
                                        pad=(1, 1), ceil_mode=True)),
    # padding above half the kernel (torch's pooling refuses it)
    ("max-pad-over-half", P5, dict(kernel=(2, 2), stride=(1, 1),
                                   pad=(2, 2))),
    ("avg-pad-over-half", P5, dict(kernel=(2, 3), pool_type="avg",
                                   stride=(1, 2), pad=(2, 2))),
    ("avg-pad-over-half-exclude-pad", P5, dict(
        kernel=(3, 2), pool_type="avg", stride=(2, 1), pad=(2, 1),
        count_include_pad=False)),
    ("global-max", P7, dict(global_pool=True)),
    ("global-avg", P7, dict(global_pool=True, pool_type="avg")),
    ("max-1d", X1, dict(kernel=(3,), stride=(2,), pad=(1,))),
    ("avg-3d", X3, dict(kernel=(2, 2, 2), pool_type="avg",
                        stride=(1, 2, 2), pad=(1, 1, 0), ceil_mode=True)),
    ("max-nhwc", NHWC, dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                            layout="NHWC")),
    ("avg-nwc-global", NWC, dict(global_pool=True, pool_type="avg",
                                 layout="NWC")),
]


@pytest.mark.parametrize("case", POOL, ids=[c[0] for c in POOL])
def test_pooling_matches_reference(case):
    _, x, kw = case
    _both("pooling", [x], kw)


def test_pooling_padding_above_half_the_kernel_gives_the_border():
    """kernel 2, stride 1, pad 2 max pooling of (1, 2, 6, 6): a (9, 9) map
    whose border rows and columns see padding only and hold -inf."""
    x = tnp.array(_r(1, 2, 6, 6))
    y = tnpx.pooling(x, kernel=(2, 2), stride=(1, 1), pad=(2, 2)).asnumpy()
    assert y.shape == (1, 2, 9, 9)
    assert onp.isneginf(y[:, :, 0]).all() and onp.isneginf(y[:, :, -1]).all()
    assert onp.isfinite(y[:, :, 1:-1, 1:-1]).all()


def test_pooling_avg_window_of_padding_only_excluded_is_nan():
    """Without ``count_include_pad`` an average over padding alone divides
    zero by zero, as the reference's divisor does."""
    kw = dict(kernel=(2, 2), pool_type="avg", stride=(2, 2), pad=(1, 1),
              ceil_mode=True, count_include_pad=False)
    want = _ref().npx.pooling(_ref().np.array(P5), **kw).asnumpy()
    got = tnpx.pooling(tnp.array(P5), **kw).asnumpy()
    assert onp.isnan(want).any()
    onp.testing.assert_allclose(got, want, equal_nan=True, **VAL)


@pytest.mark.parametrize("size", [1, (1, 1), 2, (3, 2)])
def test_adaptive_avg_pool2d_matches_reference(size):
    _both("adaptive_avg_pool2d", [_r(2, 3, 6, 4)], dict(output_size=size))


def test_adaptive_avg_pool2d_raises_on_sizes_that_do_not_divide():
    x = _r(1, 2, 5, 4)
    with pytest.raises(_ref().base.MXNetError):
        _ref().npx.adaptive_avg_pool2d(_ref().np.array(x), output_size=2)
    with pytest.raises(MXNetError, match="divisible"):
        tnpx.adaptive_avg_pool2d(tnp.array(x), output_size=2)


XB = _r(4, 3, 5, 2) * 2 + 0.5
G3 = R.uniform(0.5, 1.5, 3).astype("float32")
BE3 = _r(3)
RM3 = _r(3) * 0.1
RV3 = R.uniform(0.5, 2.0, 3).astype("float32")
XL = _r(6, 4) * 3 - 1          # channels on the last axis
G4, BE4 = R.uniform(0.5, 1.5, 4).astype("float32"), _r(4)
RM4, RV4 = _r(4) * 0.1, R.uniform(0.5, 2.0, 4).astype("float32")

BN = [
    ("train", [XB, G3, BE3, RM3, RV3], {}, True),
    ("train-fix-gamma", [XB, G3, BE3, RM3, RV3], {"fix_gamma": True}, True),
    ("train-global-stats", [XB, G3, BE3, RM3, RV3],
     {"use_global_stats": True}, True),
    ("train-momentum-eps", [XB, G3, BE3, RM3, RV3],
     {"momentum": 0.7, "eps": 1e-3}, True),
    ("predict", [XB, G3, BE3, RM3, RV3], {}, False),
    ("train-axis-last", [XL, G4, BE4, RM4, RV4], {"axis": -1}, True),
    ("predict-axis-last", [XL, G4, BE4, RM4, RV4], {"axis": -1}, False),
    ("train-one-value-per-channel", [_r(1, 3), G3, BE3, RM3, RV3], {}, True),
]


@pytest.mark.parametrize("case", BN, ids=[c[0] for c in BN])
def test_batch_norm_matches_reference(case):
    """All three outputs, and the gradients of x, gamma and beta."""
    _, arrays, kw, train = case
    _both("batch_norm", arrays, kw, wrt=(0, 1, 2), train=train)


def test_batch_norm_running_variance_is_biased_with_mxnet_momentum():
    """new = m * old + (1 - m) * batch, the batch's variance biased (over
    N, not N - 1), and no gradient reaches the stats; one value per channel
    gives variance 0 (where ``F.batch_norm`` in training mode raises)."""
    x = _r(2, 3, 7, 7)
    m = 0.9
    with tmx.autograd.record():
        _, mean, var = tnpx.batch_norm(
            tnp.array(x), tnp.array(G3), tnp.array(BE3), tnp.array(RM3),
            tnp.array(RV3), momentum=m)
    red = (0, 2, 3)
    onp.testing.assert_allclose(
        var.asnumpy(), m * RV3 + (1 - m) * x.var(axis=red), rtol=1e-5)
    onp.testing.assert_allclose(
        mean.asnumpy(), m * RM3 + (1 - m) * x.mean(axis=red), rtol=1e-5,
        atol=1e-7)
    assert not var._data.requires_grad and not mean._data.requires_grad
    with tmx.autograd.record():
        _, _, var1 = tnpx.batch_norm(
            tnp.array(_r(1, 3)), tnp.array(G3), tnp.array(BE3),
            tnp.array(RM3), tnp.array(RV3), momentum=m)
    onp.testing.assert_allclose(var1.asnumpy(), m * RV3, rtol=1e-6)


def test_amp_casts_convolution_and_leaves_batch_norm_to_its_inputs():
    """Under AMP the convolution's fp32 operands (bias too) are cast to
    bf16 and it returns bf16; ``batch_norm`` (FP32_FUNCS) takes its five
    inputs as they come and returns bf16 ``out`` with fp32 stats, as the
    reference's registry does."""
    mx = _ref()
    kw = dict(kernel=(3, 3), pad=(1, 1), num_filter=6)
    stats = (_r(6) + 1, _r(6), _r(6) * 0.1, _r(6) ** 2 + 0.5)
    outs = []
    for pkg, amp in ((mx, mx.amp), (tmx, tmx.amp)):
        amp.init("bfloat16")
        try:
            with pkg.autograd.record():
                y = pkg.npx.convolution(pkg.np.array(X2), pkg.np.array(W2),
                                        pkg.np.array(B6), **kw)
                z = pkg.npx.batch_norm(y, *(pkg.np.array(a) for a in stats))
        finally:
            amp.disable()
        outs.append((y, *z))
    for want, got in zip(*outs):
        assert dtype_name(got.dtype) == dtype_name(want.dtype)
        w_, g_ = (v.asnumpy().astype("float32") for v in (want, got))
        assert float(onp.abs(g_ - w_).max()) <= \
            2.0 ** -6 * float(onp.abs(w_).max())
    assert [dtype_name(t.dtype) for t in outs[1]] == \
        ["bfloat16", "bfloat16", "float32", "float32"]


# -- initializers --------------------------------------------------------------
@pytest.mark.parametrize("name, kwargs", [
    ("xavier", {}),
    ("xavier", {"rnd_type": "gaussian", "factor_type": "in",
                "magnitude": 2}),
    ("xavier", {"factor_type": "out"}),
    ("msraprelu", {}),
    ("msraprelu", {"factor_type": "in", "slope": 0.0}),
])
def test_xavier_and_msraprelu_match_the_reference_formulas(name, kwargs):
    """A conv weight (128, 64, 6, 6): fans over the kernel dims; the
    port's draws and the reference's have the same bound or std."""
    mx = _ref()
    shape = (128, 64, 6, 6)
    ref = mx.initializer.create(name, **kwargs)
    arr = mx.np.zeros(shape)
    ref("features.0.weight", arr)
    want = arr.asnumpy()
    init = tinit.create(name, **kwargs)
    got = torch.empty(shape)
    init.init_array("features.0.weight", got, torch.Generator().manual_seed(0))
    got = got.numpy()
    hw = 36.0
    fan_in, fan_out = 64 * hw, 128 * hw
    factor = {"avg": (fan_in + fan_out) / 2, "in": fan_in,
              "out": fan_out}[init.factor_type]
    scale = math.sqrt(init.magnitude / factor)
    if init.rnd_type == "uniform":
        std = scale / math.sqrt(3)
        assert onp.abs(got).max() <= scale and onp.abs(want).max() <= scale
    else:
        std = scale
    for draws in (got, want):
        assert abs(draws.std() / std - 1) < 0.05
        assert abs(draws.mean()) < 0.05 * std


def test_xavier_rejects_a_vector_as_the_reference_does():
    with pytest.raises(MXNetError, match="ndim>=2"):
        tinit.Xavier().init_array("w", torch.empty(5), torch.Generator())


@pytest.mark.parametrize("name", [
    "features.1.bias", "ln.beta", "bn.running_mean", "x.moving_mean",
    "bn.GAMMA", "bn.running_var", "y.moving_var", "features.0.weight"])
def test_fill_by_name_matches_the_reference(name):
    """Zeros for ``bias``/``beta``/``*_mean``, ones for ``gamma``/``*_var``
    (any case), whatever the initializer; other names get its draw."""
    mx = _ref()
    shape = (4, 3)
    arr = mx.np.zeros(shape)
    mx.initializer.Uniform(0.5)(name, arr)
    got = torch.empty(shape)
    tinit.Uniform(0.5).init_array(name, got, torch.Generator().manual_seed(1))
    want = arr.asnumpy()
    if name.endswith("weight"):
        assert 0 < onp.abs(got.numpy()).max() <= 0.5
        assert 0 < onp.abs(want).max() <= 0.5
    else:
        onp.testing.assert_array_equal(got.numpy(), want)


def test_create_knows_the_reference_names():
    assert isinstance(tinit.create("Xavier"), tinit.Xavier)
    assert isinstance(tinit.create("msraprelu"), tinit.MSRAPrelu)
    assert tinit.create("xavier", magnitude=2).magnitude == 2.0
    assert isinstance(tinit.create("zero"), tinit.Zero)
    assert isinstance(tinit.create("ones"), tinit.One)
    assert isinstance(tinit.create("orthogonal"), tinit.Orthogonal)
    with pytest.raises(MXNetError, match="unknown initializer"):
        tinit.create("no_such_initializer")


def test_gpt_initialisation_is_unchanged_by_the_fill_by_name():
    """Every GPT parameter has its own initializer (biases and betas
    zeros, gammas ones, weights Normal(0.02)) or the default: the same seed
    gives the same weights as each initializer's own draw, in
    ``collect_params`` order, without the name rule."""
    from mxnet_tpu_torch.gluon.model_zoo import gpt_tiny

    net = gpt_tiny(vocab_size=50, num_layers=2, device="cpu")
    net.initialize(seed=5)
    gen = torch.Generator().manual_seed(5)
    default = tinit.Uniform(0.07)
    for name, p in net.collect_params().items():
        host = torch.empty(p.shape)
        (p.mx_init or default)._init_weight(name, host, gen)
        assert torch.equal(p.detach(), host), name


# -- on the card ---------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_ops_on_the_card_match_the_cpu(cuda):
    """Every convolution, pooling and BatchNorm case of the grid on the
    card (cuDNN, TF32 off) against the CPU: values and gradients."""
    cases = [("convolution", a, kw, tuple(range(len(a))), True)
             for _, a, kw in CONV] + \
        [("pooling", [x], kw, (0,), True) for _, x, kw in POOL] + \
        [("batch_norm", a, kw, (0, 1, 2), t) for _, a, kw, t in BN]
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for op, arrays, kw, wrt, train in cases:
            ys, _ = _run(tmx, op, arrays, kw, (), None, train)
            y = ys[0] if isinstance(ys, tuple) else ys
            head = onp.random.RandomState(0).randn(*y.shape) \
                .astype("float32")
            yc, gc = _run(tmx, op, arrays, kw, wrt, head, train)
            with tmx.gpu():
                yg, gg = _run(tmx, op, arrays, kw, wrt, head, train)
            for w, g in zip(yc if isinstance(yc, tuple) else (yc,),
                            yg if isinstance(yg, tuple) else (yg,)):
                assert g._data.is_cuda
                _close(w, g, VAL)
            for w, g in zip(gc, gg):
                _close(w, g, GRAD)
    finally:
        torch.backends.cudnn.allow_tf32 = old
