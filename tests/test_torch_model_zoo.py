"""PyTorch/CUDA port: the vision zoo families that ``get_model`` refused
until now (AlexNet, VGG, the MLP, DenseNet, MobileNet v1/v2, SqueezeNet,
Inception v3), against the JAX package on the CPU.

Each family runs at reduced settings through its JAX constructor (the
reference compiles every op at every new shape on its first call, so the
ImageNet sizes stay on the card, ``chip_smoke.py`` phase 15): the port's
net takes one forward (its deferred shapes), numpy weights are set into it
(conv and dense weights N(0, 1/fan_in), gammas near 1, betas and biases
near 0, running variances in [1, 1.2]) and saved with ``save_parameters``;
the JAX net loads that file with ``load_parameters``, which checks every
name, and runs on those shapes. Held: the parameter names, the
predict-mode output, and in training mode (``record()``: BatchNorm on the
batch's statistics) the output and the gradients of ``sum(out * c)`` into
the input and every parameter. Dropout draws its masks from each
package's own generator, so the comparison sets every ``Dropout``'s rate
to 0 in both nets.

Tolerances (fp32; the two packages' convolutions sum in other orders):
outputs and the input's gradient within ``RTOL`` (1e-5) of their largest
entry; each parameter's gradient within ``RTOL`` of the net's largest
gradient entry. A parameter's own scale is the wrong yardstick where its
gradient is a cancelling sum: a BatchNorm gamma's (measured 4.6e-4 of its
own largest entry in the DenseNet, 5e-7 of the net's) or a convolution
bias before a training-mode BatchNorm, whose true gradient is zero (the
two packages' rounding noise differ by 180 % of its own size there).
Measured: 1.3e-6 of the net's largest at most, over every family.
Inception's five blocks are held one at a time at small spatial sizes;
``Inception3`` whole runs at 299 on the port's side only (a shape test
here; the card against the CPU in phase 15).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision

RTOL = 1e-5

REFUSED_BEFORE = (
    "alexnet", "vgg11", "vgg13", "vgg16", "vgg19", "mlp", "densenet121",
    "densenet161", "densenet169", "densenet201", "mobilenet1.0",
    "mobilenet0.75", "mobilenet0.5", "mobilenet0.25", "mobilenetv2_1.0",
    "mobilenetv2_0.5", "squeezenet1.0", "squeezenet1.1", "inceptionv3",
    "ssd_300_mobilenet", "ssd_256_lite")


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


def _weights(shapes, seed):
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


def _vis(pkg):
    return pkg.gluon.model_zoo.vision


def _module(pkg, name):
    return getattr(_vis(pkg), name)


# family id -> (its constructor over a package, input shape).
# MobileNet v1/v2 are held block by block, and SqueezeNet 1.0 by its Fire
# block: their whole nets hold 13 to 17 distinct blocks, each a new JAX
# compile forward and backward (MobileNetV2 0.25 at 64 x 64 took 34 s
# there, SqueezeNet 1.0 23 s); the whole nets' names and shapes are held by
# ``test_get_model_builds_every_name``.
FAMILIES = {
    "alexnet": (lambda p: _vis(p).AlexNet(classes=10), (2, 3, 64, 64)),
    # 16 x 16 through two pools: a 256-wide flatten, as AlexNet's
    "vgg": (lambda p: _vis(p).VGG([1, 1], [8, 16], classes=10),
            (2, 3, 16, 16)),
    "vgg_bn": (lambda p: _vis(p).VGG([1, 1], [8, 16], classes=10,
                                     batch_norm=True), (4, 3, 16, 16)),
    "mlp": (lambda p: _vis(p).MLP(hidden=(32, 16), classes=10), (4, 20)),
    "densenet": (lambda p: _vis(p).DenseNet(8, 4, [2, 2], classes=10),
                 (2, 3, 32, 32)),
    "mobilenet_dw": (lambda p: _module(p, "mobilenet")._dw_block(8, 16, 2),
                     (2, 8, 9, 9)),
    "mobilenetv2_t6": (lambda p: _module(p, "mobilenet")._LinearBottleneck(
        8, 8, 6, 1), (2, 8, 9, 9)),
    "mobilenetv2_t1_s2": (lambda p: _module(
        p, "mobilenet")._LinearBottleneck(8, 12, 1, 2), (2, 8, 9, 9)),
    "squeezenet1.1": (lambda p: _vis(p).SqueezeNet("1.1", classes=10),
                      (1, 3, 64, 64)),
    "squeezenet_fire": (lambda p: _module(p, "squeezenet")._Fire(8, 8, 8),
                        (2, 6, 7, 7)),
    "inception_A": (lambda p: _module(p, "inception")._make_A(16),
                    (2, 8, 5, 5)),
    "inception_B": (lambda p: _module(p, "inception")._make_B(),
                    (2, 8, 5, 5)),
    "inception_C": (lambda p: _module(p, "inception")._make_C(12),
                    (2, 8, 5, 5)),
    "inception_D": (lambda p: _module(p, "inception")._make_D(),
                    (2, 8, 5, 5)),
    "inception_E": (lambda p: _module(p, "inception")._make_E(),
                    (2, 8, 5, 5)),
}


def _no_dropout(net):
    for blk in _blocks(net):
        if type(blk).__name__ == "Dropout":
            blk._rate = 0.0


def _blocks(net):
    yield net
    kids = getattr(net, "_children", None)
    kids = kids.values() if kids is not None else net.children()
    for k in kids:
        yield from _blocks(k)


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request, tmp_path_factory):
    """The JAX package's results for one family, and its saved file."""
    import mxnet_tpu as mx

    fid = request.param
    build, shape = FAMILIES[fid]
    rs = onp.random.RandomState(sum(map(ord, fid)))
    x = rs.randn(*shape).astype("float32")
    # the port's net gives the shapes (its first forward), the numpy weights
    # go to a file, and the JAX net loads that file without an initializer
    # or a shape-inferring forward: the JAX package compiles its
    # initializers at each weight's shape, half of its time here
    with tmx.cpu():
        tnet = build(tmx)
        tnet.initialize()
        with torch.no_grad():
            tnet(torch.from_numpy(x))
    tparams = tnet.collect_params()
    weights = _weights({n: tuple(p.shape) for n, p in tparams.items()},
                       seed=7)
    with torch.no_grad():
        for n, p in tparams.items():
            p.copy_(torch.from_numpy(weights[n]))
    path = str(tmp_path_factory.mktemp(fid.replace(".", "_")) / "w.params")
    tnet.save_parameters(path)
    jnet = build(mx)
    names = sorted(jnet.collect_params())
    jnet.load_parameters(path)
    params = jnet.collect_params()
    _no_dropout(jnet)
    out = {"id": fid, "x": x, "path": path, "names": names,
           "predict": jnet(mx.np.array(x)).asnumpy()}
    jx = mx.np.array(x)
    jx.attach_grad()
    with mx.autograd.record():
        y = jnet(jx)
        c = mx.np.array(rs.randn(*y.shape).astype("float32"))
        (y * c).sum().backward()
    out["c"] = c.asnumpy()
    out["train"] = y.asnumpy()
    out["dx"] = jx.grad.asnumpy()
    out["grads"] = {n: p.grad().asnumpy() for n, p in params.items()
                    if p.grad_req != "null"}
    return out


def _port(fam):
    net = FAMILIES[fam["id"]][0](tmx)
    net.load_parameters(fam["path"])
    _no_dropout(net)
    return net


def test_family_names_shapes_and_predict(family):
    """The JAX net's own parameter names (before any load) are the port's,
    and the JAX net ran on the port's shapes; the predict-mode output."""
    net = _port(family)
    assert sorted(net.collect_params()) == family["names"]
    with torch.no_grad():
        got = net(torch.from_numpy(family["x"]))
    assert _rel(got, family["predict"]) <= RTOL


def test_family_train_mode_gradients(family):
    net = _port(family)
    x = torch.from_numpy(family["x"]).requires_grad_(True)
    with tag.record():
        y = net(x)
        (y * torch.from_numpy(family["c"])).sum().backward()
    params = net.collect_params()
    assert set(family["grads"]) == {n for n, p in params.items()
                                    if p.grad_req != "null"}
    assert _rel(y.detach(), family["train"]) <= RTOL
    assert _rel(x.grad, family["dx"]) <= RTOL
    top = max(float(abs(g).max()) for g in family["grads"].values())
    for n, g in family["grads"].items():
        gap = float(abs(params[n].grad.detach().numpy() - g).max())
        assert gap <= RTOL * top, (n, gap / top)


# -- the zoo's names --------------------------------------------------------------
@pytest.mark.parametrize("name", REFUSED_BEFORE)
def test_get_model_builds_every_name(name):
    """Every name the JAX package registers builds, with the JAX model's
    parameter names (before any forward: deferred shapes left open)."""
    from mxnet_tpu.gluon.model_zoo import vision as jvision

    kw = {} if name.startswith("ssd") else {"classes": 7}
    net = tvision.get_model(name.upper(), **kw)
    assert sorted(net.collect_params()) == \
        sorted(jvision.get_model(name, **kw).collect_params())
    with pytest.raises(MXNetError, match="pretrained"):
        tvision.get_model(name, pretrained=True, **kw)


def test_inception3_whole_at_299():
    net = tvision.inception_v3(classes=10)
    net.initialize()
    with torch.no_grad():
        out = net(torch.randn(1, 3, 299, 299))
    assert tuple(out.shape) == (1, 10) and torch.isfinite(out).all()


def test_zoo_families_hybridize_on_the_cpu():
    """A hybridized family runs (on the CPU the body runs eagerly) and
    gives the eager result."""
    net = tvision.get_model("mobilenetv2_0.5", classes=5)
    net.initialize()
    x = torch.randn(2, 3, 32, 32)
    with torch.no_grad():
        want = net(x)
        net.hybridize()
        got = net(x)
    assert torch.equal(got, want)


# -- on the card -------------------------------------------------------------------
@pytest.fixture
def cuda():
    """The card, TF32 off (cuDNN's and the matmuls')."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = old


CARD_FAMILIES = ["alexnet", "vgg_bn", "densenet", "mobilenet_dw",
                 "mobilenetv2_t6", "squeezenet1.1", "inception_E"]
# cuDNN against oneDNN, fp32, summed in other orders; gradients of the
# net's largest gradient entry, as on the CPU
CARD_RTOL = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("fid", CARD_FAMILIES)
def test_family_on_card(cuda, fid, tmp_path):
    """One family's predict and train-mode results on the card against the
    CPU, from one set of weights."""
    build, shape = FAMILIES[fid]
    rs = onp.random.RandomState(1)
    x = rs.randn(*shape).astype("float32")
    res = []
    path = str(tmp_path / "w.params")
    for ctx in (tmx.cpu(), tmx.gpu()):
        with ctx:
            net = build(tmx)
            if ctx.device_type == "cpu":
                net.initialize()
                with torch.no_grad():
                    net(torch.from_numpy(x))
                params = net.collect_params()
                ws = _weights({n: tuple(p.shape) for n, p in params.items()},
                              seed=3)
                with torch.no_grad():
                    for n, p in params.items():
                        p.copy_(torch.from_numpy(ws[n]))
                net.save_parameters(path)
            else:
                net.load_parameters(path)
            _no_dropout(net)
            dev = torch.device(ctx.device_type if ctx.device_type == "cpu"
                               else "cuda")
            with torch.no_grad():
                pred = net(torch.from_numpy(x).to(dev)).cpu().numpy()
            xt = torch.from_numpy(x).to(dev).requires_grad_(True)
            with tag.record():
                y = net(xt)
                (y * y).sum().backward()
            grads = {n: p.grad.detach().cpu().numpy()
                     for n, p in net.collect_params().items()
                     if p.grad is not None}
            res.append((pred, y.detach().cpu().numpy(),
                        xt.grad.cpu().numpy(), grads))
    (p0, y0, d0, g0), (p1, y1, d1, g1) = res
    assert _rel(p1, p0) <= CARD_RTOL
    assert _rel(y1, y0) <= CARD_RTOL
    assert _rel(d1, d0) <= CARD_RTOL
    assert set(g0) == set(g1)
    top = max(float(abs(g).max()) for g in g0.values())
    for n in g0:
        assert float(abs(g1[n] - g0[n]).max()) <= CARD_RTOL * top, n
