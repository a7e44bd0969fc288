"""PyTorch/CUDA port: ResNet v1/v2 against the JAX package, on the CPU.

Tiny ResNets — ``ResNetV1(BottleneckV1, [1, 1, 1, 1], [8, 16, 32, 64,
128], classes=10)`` and ``ResNetV2(BasicBlockV2, [1, 1, 1, 1], [8, 8, 16,
32, 64], classes=10)`` — at (2, 3, 32, 32) run with the reference's saved
weights (numpy draws set into the JAX model after its first forward, saved
with ``save_parameters`` and loaded by the port's ``load_parameters``).
The reference's results are computed once a module (module-scoped
fixtures). Checked: parameter names and shapes after the first forward
(deferred shapes), ``resnet50_v1()``'s 299 names without a forward,
logits in predict and train modes, the loss, every gradient, the new
running statistics, one ``Trainer`` step of SGD with momentum and ``wd``,
the compiled step against the eager one (three steps, and
``accumulate=2``), a ``Trainer`` built before the first forward, AMP and
``cast("bfloat16")``. Tolerances, each with its reason:

- predict mode, fp32: rtol 1e-5 of each tensor's largest entry (the
  running statistics normalise: well conditioned);
- train mode, fp32, the thumbnail V1 (no stem downsampling: the last
  BatchNorm normalises 32 values a channel): 1e-4 of each tensor's
  largest entry;
- train mode, fp32, the two nets above: 1e-1 of each tensor's largest
  entry. At 32 x 32 their last stage's maps are 1 x 1, so its BatchNorm
  normalises two values a channel and amplifies the last bits of its input
  by up to 1/sqrt(var + eps): the two packages' convolutions round in
  another order, and both packages' gradients lie 2e-3 to 5e-2 from a
  float64 answer (measured: the port 3.1e-2 from the reference at worst);
- a gradient that is rounding noise around a true zero (a convolution
  bias before BatchNorm in training: below 1e-5 of the net's largest
  gradient in the reference) is held within twice that bound;
- statistics: 1e-5 absolute (means and variances of O(1) maps); 1e-4
  for the two nets above, whose last stage's inputs carry the amplified
  rounding (measured 1.02e-5);
- the compiled step against the eager one: 1e-6 of each largest entry
  (the same arithmetic in the same order); on the card (``cuda``) against
  the CPU, three steps of the thumbnail V1: 1e-3 (cuDNN against oneDNN,
  one step's 1e-5-level differences carried through two updates);
- AMP: bf16 logits within 2 % of the largest, on the thumbnail variant
  (no stem downsampling, so the last BatchNorm sees 32 values a channel:
  at two values a channel bf16 rounding decides the result in either
  package); under AMP a gradient through BatchNorm in bf16 lies 30-160 %
  from the fp32 one in both packages at this size, so gradients are held
  by dtype and finiteness only;
- ``cast("bfloat16")`` predict: 2 bf16 steps (2 x 2^-7) of the largest
  logit.
"""
import math

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError, amp as tamp, autograd as tag
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.base import dtype_name
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision

PREDICT_RTOL = 1e-5
TRAIN_RTOL = 1e-1
THUMB_RTOL = 1e-4
NOISE = 1e-5
STAT_ATOL = 1e-5
STAT_ATOL_SMALL_MAPS = 1e-4
COMPILED_RTOL = 1e-6
CARD_RTOL = 1e-3
AMP_RTOL = 2e-2
BF16_RTOL = 2 * 2.0 ** -7
LR, MOMENTUM, WD = 0.01, 0.9, 1e-4

SHAPE = (2, 3, 32, 32)
TINY = {
    1: ("ResNetV1", "BottleneckV1", [1, 1, 1, 1], [8, 16, 32, 64, 128]),
    2: ("ResNetV2", "BasicBlockV2", [1, 1, 1, 1], [8, 8, 16, 32, 64]),
}


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _ref():
    import mxnet_tpu as mx

    return mx


def _weights(shapes, seed):
    """Weights from ``RandomState(seed)`` of O(1) activations: conv and
    dense weights N(0, 1/fan_in), gammas near 1, betas, biases and running
    means near 0, running variances in [1, 1.2]."""
    rs = onp.random.RandomState(seed)
    out = {}
    for name, shape in shapes.items():
        if name.endswith("running_var"):
            a = 1 + 0.2 * rs.rand(*shape)
        elif name.endswith("gamma"):
            a = 1 + 0.1 * rs.randn(*shape)
        elif name.endswith(("beta", "bias", "running_mean")):
            a = 0.1 * rs.randn(*shape)
        else:
            a = rs.randn(*shape) / onp.sqrt(onp.prod(shape[1:]))
        out[name] = a.astype("float32")
    return out


def _tiny(pkg, version, thumbnail=False):
    net_cls, block, layers, channels = TINY[version]
    res = pkg.gluon.model_zoo.vision.resnet
    return getattr(res, net_cls)(getattr(res, block), layers, channels,
                                 classes=10, thumbnail=thumbnail)


def _inputs(seed=0, n=1):
    rs = onp.random.RandomState(seed)
    xs = [rs.randn(*SHAPE).astype("float32") for _ in range(n)]
    ys = [rs.randint(0, 10, (SHAPE[0],)).astype("float32") for _ in range(n)]
    return xs, ys


def _ref_net(version, tmp_path_factory, thumbnail=False):
    """The reference's tiny net after its first forward, with numpy
    weights set and saved; returns (net, {name: array}, params path)."""
    mx = _ref()
    net = _tiny(mx, version, thumbnail)
    net.initialize()
    with mx.autograd.pause():
        net(mx.np.array(_inputs()[0][0]))
    weights = _weights({n: p.shape for n, p in net.collect_params().items()},
                       seed=10 + version)
    for n, p in net.collect_params().items():
        p.set_data(mx.np.array(weights[n]))
    path = str(tmp_path_factory.mktemp(f"resnet_v{version}") / "w.params")
    net.save_parameters(path)
    return net, weights, path


def _reference_run(version, tmp_path_factory, thumbnail=False):
    """Everything the tests compare, from the JAX package."""
    mx = _ref()
    net, weights, path = _ref_net(version, tmp_path_factory, thumbnail)
    (x,), (y,) = _inputs()
    out = {"weights": weights, "path": path,
           "shapes": {n: tuple(p.shape)
                      for n, p in net.collect_params().items()}}
    out["predict"] = net(mx.np.array(x)).asnumpy()
    trainer = mx.gluon.Trainer(net.collect_params(), mx.optimizer.SGD(
        learning_rate=LR, momentum=MOMENTUM, wd=WD))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        logits = net(mx.np.array(x))
        loss = loss_fn(logits, mx.np.array(y))
    loss.backward()
    params = net.collect_params()
    out["train"] = logits.asnumpy()
    out["loss"] = loss.asnumpy()
    out["grads"] = {n: p.grad().asnumpy() for n, p in params.items()
                    if p.grad_req != "null"}
    out["stats"] = {n: p.data().asnumpy() for n, p in params.items()
                    if n.endswith(("running_mean", "running_var"))}
    trainer.step(SHAPE[0])
    out["stepped"] = {n: p.data().asnumpy() for n, p in params.items()}
    return out


@pytest.fixture(scope="module")
def ref_v1(tmp_path_factory):
    return _reference_run(1, tmp_path_factory)


@pytest.fixture(scope="module")
def ref_v2(tmp_path_factory):
    return _reference_run(2, tmp_path_factory)


@pytest.fixture(scope="module")
def ref_thumb(tmp_path_factory):
    """The thumbnail V1 (no stem downsampling): fp32 as the others, then
    one train-mode step under ``amp.init("bfloat16")`` from the same
    weights (logits, loss, the gradients' dtypes, the statistics)."""
    out = _reference_run(1, tmp_path_factory, thumbnail=True)
    mx = _ref()
    net = _tiny(mx, 1, thumbnail=True)
    net.load_parameters(out["path"])
    (x,), (y,) = _inputs()
    mx.amp.init("bfloat16")
    try:
        with mx.autograd.record():
            logits = net(mx.np.array(x))
            loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(
                logits, mx.np.array(y))
        loss.backward()
    finally:
        mx.amp.disable()
    params = net.collect_params()
    out["amp"] = {
        "logits": logits, "loss": loss,
        "grad_dtypes": {n: str(p.grad().dtype) for n, p in params.items()
                        if p.grad_req != "null"},
        "stats": {n: p.data().asnumpy() for n, p in params.items()
                  if n.endswith(("running_mean", "running_var"))}}
    return out


# (fixture, version, thumbnail, train-mode tolerance)
CONFIGS = {"v1": ("ref_v1", 1, False, TRAIN_RTOL),
           "v2": ("ref_v2", 2, False, TRAIN_RTOL),
           "v1-thumbnail": ("ref_thumb", 1, True, THUMB_RTOL)}


@pytest.fixture(params=list(CONFIGS))
def ref(request):
    fixture, version, thumbnail, tol = CONFIGS[request.param]
    return (version, thumbnail, tol), request.getfixturevalue(fixture)


def _port_net(cfg, ref_out):
    net = _tiny(tmx, cfg[0], cfg[1])
    net.load_parameters(ref_out["path"])
    return net


def _train_step(net, x, y):
    with tag.record():
        logits = net(torch.from_numpy(x))
        loss = tgluon.loss.SoftmaxCrossEntropyLoss()(logits,
                                                     torch.from_numpy(y))
    tag.backward(loss)
    return logits, loss


def _rel(got, want, scale=None):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    scale = float(onp.abs(want).max()) if scale is None else scale
    return float(onp.abs(got - want).max()) / max(scale, 1e-30)


def _stat_atol(cfg):
    return STAT_ATOL if cfg[1] else STAT_ATOL_SMALL_MAPS


def _top(grads):
    return max(float(onp.abs(g).max()) for g in grads.values())


def _is_noise(grad, top):
    """A gradient that is rounding noise around a true zero: below
    ``NOISE`` of the net's largest gradient ``top`` (a convolution bias
    before BatchNorm in training)."""
    return float(onp.abs(grad).max()) <= NOISE * top


def _check_grad(got, want, top, tol, name, noise):
    """``got`` within ``tol`` of ``want``'s largest entry; for a ``noise``
    gradient (or its update, with ``top`` scaled alike) within twice the
    noise bound of it."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    if noise:
        assert float(onp.abs(got - want).max()) <= 2 * NOISE * top, name
    else:
        assert _rel(got, want) <= tol, name


# -- names, deferred shapes, loading --------------------------------------------
def test_resnet50_v1_names_equal_the_reference_without_a_forward():
    want = list(_ref().gluon.model_zoo.vision.resnet50_v1()
                .collect_params())
    net = tvision.resnet50_v1()
    got = list(net.collect_params())
    assert got == want and len(got) == 299
    assert got[:2] == ["features.0.weight", "features.1.gamma"]
    assert got[-1] == "output.bias"
    params = net.collect_params()
    assert tuple(params["features.4.0.body.1.gamma"].shape) == (0,)
    assert params["features.4.0.body.1.gamma"].is_deferred
    assert tuple(params["features.0.weight"].shape) == (64, 0, 7, 7)
    assert not params["output.weight"].is_deferred


def test_shapes_after_the_first_forward_equal_the_reference(ref):
    cfg, out = ref
    net = _tiny(tmx, *cfg[:2])
    assert any(p.is_deferred for p in net.parameters())
    net.initialize(seed=0)
    with torch.no_grad():
        net(torch.zeros(SHAPE))
    got = {n: tuple(p.shape) for n, p in net.collect_params().items()}
    assert got == out["shapes"]
    assert list(got) == list(out["shapes"])


def test_deferred_parameters_keep_their_objects_and_initializers():
    """``initialize`` records; the first forward fills the same objects in
    place, by the fill by name (gammas and running variances ones, betas,
    biases and running means zeros) and Xavier for the convolutions."""
    net = _tiny(tmx, 1)
    before = dict(net.collect_params())
    net.initialize(seed=3)
    conv = before["features.4.0.body.0.weight"]
    assert conv.is_deferred and conv._deferred_init is not None
    with torch.no_grad():
        net(torch.zeros(SHAPE))
    after = net.collect_params()
    assert all(after[n] is p for n, p in before.items())
    for n, p in after.items():
        if n.endswith(("gamma", "running_var")):
            assert torch.equal(p, torch.ones_like(p)), n
        elif n.endswith(("beta", "bias", "running_mean")) and \
                n != "output.bias":
            assert not p.any(), n
    w = after["features.4.0.body.0.weight"]          # (4, 8, 1, 1)
    bound = math.sqrt(3.0 / ((8 + 4) / 2))
    assert 0 < float(w.detach().abs().max()) <= bound
    assert conv._deferred_init is None
    again = _tiny(tmx, 1)
    again.initialize(seed=3)
    with torch.no_grad():
        again(torch.zeros(SHAPE))
    assert torch.equal(again.collect_params()["features.4.0.body.0.weight"],
                       w)


def test_a_placeholder_never_initialised_gets_zeros():
    net = _tiny(tmx, 1)
    with torch.no_grad():
        net(torch.zeros(SHAPE))
    assert not net.collect_params()["features.0.weight"].any()


def test_load_parameters_fills_placeholders_from_the_file(ref_v1):
    net = _tiny(tmx, 1)
    before = dict(net.collect_params())
    net.load_parameters(ref_v1["path"])
    params = net.collect_params()
    assert all(params[n] is p for n, p in before.items())
    for n, w in ref_v1["weights"].items():
        onp.testing.assert_array_equal(params[n].detach().numpy(), w)


def test_load_checks_names_and_known_extents(ref_v1, tmp_path):
    arrays = dict(ref_v1["weights"])
    arrays.pop("output.bias")
    with pytest.raises(MXNetError, match="missing"):
        _tiny(tmx, 1).load_dict(arrays)
    arrays = dict(ref_v1["weights"])
    w = arrays["features.0.weight"]                  # (8, 3, 7, 7)
    arrays["features.0.weight"] = onp.zeros((9,) + w.shape[1:], "float32")
    with pytest.raises(MXNetError, match="features.0.weight"):
        _tiny(tmx, 1).load_dict(arrays)


def test_save_parameters_leaves_placeholders_out(tmp_path):
    net = _tiny(tmx, 1)
    path = str(tmp_path / "p.params")
    net.save_parameters(path)
    with onp.load(path) as z:
        saved = set(z.files)
    assert "output.weight" in saved and "features.0.weight" not in saved
    assert saved == {n for n, p in net.collect_params().items()
                     if not p.is_deferred}


def test_get_model_and_the_zoo_names():
    net = tvision.get_model("ResNet18_v2", classes=7)
    assert isinstance(net, tvision.ResNetV2)
    assert tuple(net.collect_params()["output.weight"].shape) == (7, 512)
    # the other families are ported now (A9's vision part)
    assert isinstance(tvision.get_model("vgg16"), tvision.VGG)
    with pytest.raises(MXNetError, match="not in zoo"):
        tvision.get_model("resnet7_v1")
    with pytest.raises(MXNetError, match="pretrained"):
        tvision.resnet50_v1(pretrained=True)
    # the transposed convolutions are ported now (A4's remainder): the
    # weight's input channels wait for the first forward
    up = tgluon.nn.Conv2DTranspose(4, 3, strides=2)
    up.initialize(seed=0)
    assert tuple(up(torch.randn(1, 2, 5, 5)).shape) == (1, 4, 11, 11)
    assert tuple(up.weight.shape) == (2, 4, 3, 3)


def test_dense_activation_and_deferred_in_units():
    d = tgluon.nn.Dense(3, activation="relu", in_units=0)
    d.initialize(seed=0)
    y = d(torch.randn(4, 2, 5))
    assert tuple(d.weight.shape) == (3, 10) and (y >= 0).all()
    ln = tgluon.nn.LayerNorm()
    ln(torch.randn(2, 6))
    assert tuple(ln.gamma.shape) == (6,)


# -- the tiny nets against the reference ------------------------------------------
def test_predict_logits_match(ref):
    cfg, out = ref
    net = _port_net(cfg, out)
    (x,), _ = _inputs()
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert _rel(got, out["predict"]) <= PREDICT_RTOL


def test_train_logits_loss_gradients_and_stats_match(ref):
    cfg, out = ref
    tol = cfg[2]
    net = _port_net(cfg, out)
    (x,), (y,) = _inputs()
    logits, loss = _train_step(net, x, y)
    assert _rel(logits, out["train"]) <= tol
    assert _rel(loss, out["loss"]) <= tol
    params = net.collect_params()
    top = _top(out["grads"])
    assert set(out["grads"]) == {n for n, p in params.items()
                                 if p.grad_req != "null"}
    for n, g in out["grads"].items():
        _check_grad(params[n].grad, g, top, tol, n, _is_noise(g, top))
    for n, s in out["stats"].items():
        onp.testing.assert_allclose(params[n].detach().numpy(), s, rtol=0,
                                    atol=_stat_atol(cfg), err_msg=n)


def test_one_sgd_step_matches(ref):
    """SGD with momentum and ``wd`` through the ``Trainer``: the updates
    (new minus old weights) of every trainable, the statistics as the
    forward left them."""
    cfg, out = ref
    net = _port_net(cfg, out)
    (x,), (y,) = _inputs()
    trainer = tgluon.Trainer(net.collect_params(), topt.SGD(
        learning_rate=LR, momentum=MOMENTUM, wd=WD))
    _train_step(net, x, y)
    trainer.step(SHAPE[0])
    params = net.collect_params()
    top = _top(out["grads"])
    for n, want in out["stepped"].items():
        old = out["weights"][n]
        got = params[n].detach().numpy()
        if n in out["grads"]:   # the update is -lr (g + wd w)
            _check_grad(got - old, want - old, LR * top, cfg[2], n,
                        _is_noise(out["grads"][n], top))
        else:
            onp.testing.assert_allclose(got, want, rtol=0,
                                        atol=_stat_atol(cfg), err_msg=n)


def _twins(cfg, out):
    nets = [_port_net(cfg, out) for _ in range(2)]
    trainers = [tgluon.Trainer(n.collect_params(), topt.SGD(
        learning_rate=LR, momentum=MOMENTUM, wd=WD)) for n in nets]
    return nets, trainers


def _assert_nets_equal(a, b, rtol):
    pa, pb = a.collect_params(), b.collect_params()
    for n in pa:
        assert _rel(pa[n], pb[n].detach().numpy()) <= rtol, n


def test_compiled_step_matches_the_eager_step(ref_v1):
    """Three compiled steps (the CPU runs the captured body eagerly)
    against three eager ones: losses, weights, momenta and the running
    statistics, which advance once a step."""
    (nets, trainers), loss_fn = _twins((1, False), ref_v1), \
        tgluon.loss.SoftmaxCrossEntropyLoss()
    xs, ys = _inputs(seed=5, n=3)
    step = trainers[1].compile_step(nets[1], loss_fn)
    for x, y in zip(xs, ys):
        with tag.record():
            loss = loss_fn(nets[0](torch.from_numpy(x)),
                           torch.from_numpy(y)).mean()
        tag.backward(loss)
        trainers[0].step(1)
        got = step(torch.from_numpy(x), torch.from_numpy(y))
        assert _rel(got, loss.detach().numpy()) <= COMPILED_RTOL
    _assert_nets_equal(nets[1], nets[0], COMPILED_RTOL)
    for sa, sb in zip(trainers[0]._states, trainers[1]._states):
        if sa is not None:
            assert _rel(sb["mom"], sa["mom"].numpy()) <= COMPILED_RTOL
    assert step._traces == 1


def test_compiled_step_with_accumulate_advances_stats_per_microbatch(ref_v2):
    """``accumulate=2``: the gradients of two microbatches averaged before
    one update, and BatchNorm's statistics advanced twice, microbatch by
    microbatch, as the eager loop over the same microbatches."""
    (nets, trainers), loss_fn = _twins((2, False), ref_v2), \
        tgluon.loss.SoftmaxCrossEntropyLoss()
    xs, ys = _inputs(seed=6, n=2)
    with tag.record():
        loss = sum(loss_fn(nets[0](torch.from_numpy(x)),
                           torch.from_numpy(y)).mean()
                   for x, y in zip(xs, ys)) / 2
    tag.backward(loss)
    trainers[0].step(1)
    step = trainers[1].compile_step(nets[1], loss_fn, accumulate=2)
    got = step(torch.from_numpy(onp.stack(xs)), torch.from_numpy(
        onp.stack(ys)))
    assert _rel(got, loss.detach().numpy()) <= COMPILED_RTOL
    _assert_nets_equal(nets[1], nets[0], COMPILED_RTOL)


def test_trainer_and_compiled_step_built_before_the_first_forward():
    """As the reference's ``bench.py``: ``initialize()``, a ``Trainer`` and
    ``compile_step`` before any forward. The step fills the placeholders
    by one forward under ``autograd.pause()`` (no statistic moves) and
    then steps; an eager ``Trainer`` built early steps too."""
    loss_fn = tgluon.loss.SoftmaxCrossEntropyLoss()
    (x,), (y,) = _inputs(seed=7)
    nets = [_tiny(tmx, 1) for _ in range(2)]
    for n in nets:
        n.initialize(seed=4)
    trainers = [tgluon.Trainer(n.collect_params(), topt.SGD(
        learning_rate=LR, momentum=MOMENTUM)) for n in nets]
    step = trainers[1].compile_step(nets[1], loss_fn)
    got = step(torch.from_numpy(x), torch.from_numpy(y))
    with tag.record():
        loss = loss_fn(nets[0](torch.from_numpy(x)),
                       torch.from_numpy(y)).mean()
    tag.backward(loss)
    trainers[0].step(1)
    assert not any(p.is_deferred for p in nets[1].parameters())
    assert _rel(got, loss.detach().numpy()) <= COMPILED_RTOL
    _assert_nets_equal(nets[1], nets[0], COMPILED_RTOL)


# -- mixed precision -----------------------------------------------------------
def test_amp_train_step_matches_the_reference(ref_thumb):
    """Convolutions and the output layer in bf16, BatchNorm on the bf16
    maps it gets (fp32 statistics), fp32 gradients of fp32 weights."""
    ref_amp = ref_thumb["amp"]
    net = _port_net((1, True), ref_thumb)
    (x,), (y,) = _inputs()
    with tamp.autocast("bfloat16"):
        logits, loss = _train_step(net, x, y)
    for got, want in ((logits, ref_amp["logits"]), (loss, ref_amp["loss"])):
        assert dtype_name(got.dtype) == str(want.dtype) == "bfloat16"
        assert _rel(got, want.asnumpy().astype("float32")) <= AMP_RTOL
    params = net.collect_params()
    for n, dt in ref_amp["grad_dtypes"].items():
        assert dtype_name(params[n].grad.dtype) == dt == "float32", n
        assert torch.isfinite(params[n].grad).all(), n
    for n, s in ref_amp["stats"].items():
        assert params[n].dtype == torch.float32
        onp.testing.assert_allclose(params[n].detach().numpy(), s, rtol=0,
                                    atol=AMP_RTOL * float(onp.abs(s).max()),
                                    err_msg=n)


def test_cast_bfloat16_predict_matches_the_reference(ref_v1):
    """``net.cast("bfloat16")`` before any forward (as ``bench.py``'s
    inference): every parameter, the running statistics too, in bf16."""
    mx = _ref()
    jnet = _tiny(mx, 1)
    jnet.load_parameters(ref_v1["path"])
    jnet.cast("bfloat16")
    (x,), _ = _inputs()
    want = jnet(mx.np.array(x).astype("bfloat16"))
    net = _tiny(tmx, 1)
    net.cast("bfloat16")
    net.load_parameters(ref_v1["path"])
    assert all(p.dtype == torch.bfloat16 for p in net.parameters())
    with torch.no_grad():
        got = net(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    assert _rel(got, want.asnumpy().astype("float32")) <= BF16_RTOL


def test_convert_hybrid_block_keeps_the_norms_fp32(ref_v1):
    """``amp.convert_hybrid_block``: convolutions and the output layer
    bf16, BatchNorm's four parameters fp32, as the reference converts."""
    mx = _ref()
    jnet = _tiny(mx, 1)
    jnet.load_parameters(ref_v1["path"])
    mx.amp.convert_hybrid_block(jnet)
    net = _tiny(tmx, 1)
    net.load_parameters(ref_v1["path"])
    tamp.convert_hybrid_block(net)
    want = {n: str(p.data().dtype) for n, p in jnet.collect_params().items()}
    got = {n: dtype_name(p.dtype) for n, p in net.collect_params().items()}
    assert got == want
    assert got["features.1.running_var"] == "float32"
    assert got["features.0.weight"] == "bfloat16"
    with tamp.autocast("bfloat16"), torch.no_grad():
        out = net(torch.from_numpy(_inputs()[0][0]))
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()


# -- on the card ---------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_compiled_step_on_the_card_matches_the_cpu(cuda):
    """The thumbnail V1 (deferred, then loaded with numpy weights; no JAX
    on the card's machine) trained by three compiled steps on the card (one
    capture) and three on the CPU: losses and every parameter within
    ``CARD_RTOL`` of each largest entry; TF32 off."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        shaper = _tiny(tmx, 1, thumbnail=True)
        with torch.no_grad():
            shaper(torch.zeros(SHAPE))
        weights = _weights({n: tuple(p.shape) for n, p in
                            shaper.collect_params().items()}, seed=21)
        loss_fn = tgluon.loss.SoftmaxCrossEntropyLoss()
        xs, ys = _inputs(seed=8, n=3)
        runs = []
        for ctx in (tmx.cpu(), tmx.gpu()):
            with ctx:
                net = _tiny(tmx, 1, thumbnail=True)
                net.load_dict(weights)
                trainer = tgluon.Trainer(net.collect_params(), topt.SGD(
                    learning_rate=LR, momentum=MOMENTUM, wd=WD))
                step = trainer.compile_step(net, loss_fn)
                losses = [float(step(torch.from_numpy(x),
                                     torch.from_numpy(y)))
                          for x, y in zip(xs, ys)]
                runs.append((net, losses, step._traces))
        (cpu, lc, _), (gpu, lg, traces) = runs
        assert traces == 1
        assert onp.allclose(lg, lc, rtol=CARD_RTOL)
        pc, pg = cpu.collect_params(), gpu.collect_params()
        for n in pc:
            assert pg[n].is_cuda
            assert _rel(pg[n].cpu(), pc[n].detach().numpy()) <= CARD_RTOL, n
    finally:
        torch.backends.cudnn.allow_tf32 = old


@pytest.mark.cuda
def test_filling_a_placeholder_inside_a_capture_raises(cuda):
    """A forward that would fill a placeholder during a CUDA graph capture
    raises instead of capturing an allocation and a host draw."""
    with tmx.gpu():
        layer = tgluon.nn.BatchNorm()
        x = torch.randn(4, 3, 5, 5, device=cuda)
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream()
        with pytest.raises(MXNetError, match="capture"):
            with torch.cuda.stream(stream), torch.cuda.graph(graph):
                layer(x)
        assert layer.gamma.is_deferred
