"""PyTorch/CUDA port: legacy-symbol graphs across the two packages.

MXNet's legacy AlexNet (``tests/torch_script_legacy_alexnet.py``: LRN,
``Flatten``, ``Dropout``, the ``MakeLoss(_mul_scalar(pick(log_softmax)))``
head and the ``SoftmaxActivation`` prediction head) and a small graph with
``Reshape``'s shape codes, written by either package with ``tojson()``,
load in the other with ``fromjson`` and bind with ``simple_bind`` on the
CPU. Both give the same loss and probabilities within ``RTOL`` (1e-5 of the
largest entry: one fp32 graph on each side, sums in another order), every
argument's gradient within ``RTOL`` of its largest entry, and the same
weights after one ``get_updater(SGD)`` step. ``SliceChannel`` crosses the
JSON in both directions. Dropout runs at rate 0 where the packages'
random streams cannot match. The ``cuda`` test trains the narrow AlexNet
on the card and holds it to the CPU, its gradients to a float64 twin.
"""
import json

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
import torch_script_legacy_alexnet as alex

RTOL = 1e-5
W, IMG, B, CLASSES = 16, 67, 2, 1000


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


def _run(mx, sym, weights, batch, steps=1):
    """Loss, gradients (before the update) and weights after ``steps``
    SGD steps of ``sym`` bound on the CPU."""
    data, label = batch
    exe = alex.bind(mx, sym, weights, B, IMG, mx.cpu())
    out = exe.forward(is_train=True, data=mx.nd.array(data),
                      label=mx.nd.array(label))
    exe.backward()
    loss = out[0].asnumpy()
    grads = {n: exe.arg_dict[n].grad.asnumpy()
             for n in alex.param_names(sym)}
    opt = mx.optimizer.SGD(learning_rate=0.01, momentum=0.9, wd=5e-4)
    updater = mx.optimizer.get_updater(opt)
    for i, n in enumerate(alex.param_names(sym)):
        w = exe.arg_dict[n]
        updater(i, w.grad, w)
    return loss, grads, {n: exe.arg_dict[n].asnumpy()
                         for n in alex.param_names(sym)}


def _probs(mx, sym, weights, data):
    exe = alex.bind(mx, sym, weights, B, IMG, mx.cpu(), grad_req="null")
    return exe.forward(is_train=False, data=mx.nd.array(data))[0].asnumpy()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_alexnet_crosses_json(writer):
    """The narrow AlexNet written by one package runs in the other: the
    same loss, probabilities, gradients and updated weights."""
    import mxnet_tpu as mx

    src, dst = (mx, tmx) if writer == "reference" else (tmx, mx)
    weights = alex.init_weights(W, IMG, CLASSES)
    batch = alex.synthetic_batches(1, B, IMG, CLASSES)[0]
    train_json = alex.alexnet_symbol(src, W, CLASSES, B,
                                     dropout=0.0).tojson()
    pred_json = alex.alexnet_symbol(src, W, CLASSES, B, train=False).tojson()
    assert '"LRN"' in train_json or '"lrn"' in train_json
    got = _run(dst, dst.sym.fromjson(train_json), weights, batch)
    want = _run(src, src.sym.fromjson(train_json), weights, batch)
    assert _rel(got[0], want[0]) <= RTOL
    for n in want[1]:
        assert _rel(got[1][n], want[1][n]) <= RTOL, n
        assert _rel(got[2][n], want[2][n]) <= RTOL, n
    p_got = _probs(dst, dst.sym.fromjson(pred_json), weights, batch[0])
    p_want = _probs(src, src.sym.fromjson(pred_json), weights, batch[0])
    assert _rel(p_got, p_want) <= RTOL
    onp.testing.assert_allclose(p_got.sum(-1), 1.0, rtol=1e-5)


def _small_graph(mx):
    """Convolution, Activation, LRN, Pooling, Reshape(0, -1),
    FullyConnected, log_softmax, pick, _mul_scalar, MakeLoss."""
    s = mx.sym
    x = s.Convolution(s.var("data"), s.var("w"), s.var("b"), kernel=(3, 3),
                      num_filter=6, pad=(1, 1))
    x = s.Activation(x, act_type="relu")
    x = s.LRN(x, alpha=1e-2, beta=0.75, knorm=2.0, nsize=5)
    x = s.Pooling(x, pool_type="max", kernel=(2, 2), stride=(2, 2))
    x = s.Reshape(x, shape=(0, -1))
    x = s.FullyConnected(x, s.var("fw"), s.var("fb"), num_hidden=5)
    nll = s._mul_scalar(s.pick(s.log_softmax(x), s.var("label")),
                        scalar=-1.0)
    return s.MakeLoss(nll, grad_scale=0.5)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_small_legacy_graph_crosses_json(writer):
    import mxnet_tpu as mx

    src, dst = (mx, tmx) if writer == "reference" else (tmx, mx)
    rng = onp.random.RandomState(4)
    args = {"data": rng.randn(2, 3, 6, 6), "w": rng.randn(6, 3, 3, 3) * 0.3,
            "b": rng.randn(6) * 0.1, "fw": rng.randn(5, 54) * 0.2,
            "fb": rng.randn(5) * 0.1, "label": onp.array([1.0, 3.0])}
    args = {k: v.astype("float32") for k, v in args.items()}
    text = _small_graph(src).tojson()
    results = []
    for pkg in (dst, src):
        sym = pkg.sym.fromjson(text)
        exe = sym.simple_bind(pkg.cpu(), grad_req="write",
                              **{n: args[n].shape
                                 for n in sym.list_arguments()})
        for n, v in args.items():
            exe.arg_dict[n][:] = pkg.nd.array(v)
        out = exe.forward(is_train=True)[0].asnumpy()
        exe.backward()
        results.append((out, {n: exe.arg_dict[n].grad.asnumpy()
                              for n in ("data", "w", "b", "fw", "fb")}))
    (got, got_g), (want, want_g) = results
    assert _rel(got, want) <= RTOL
    for n in want_g:
        assert _rel(got_g[n], want_g[n]) <= RTOL, n


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_slice_channel_crosses_json(writer):
    """``SliceChannel`` with ``nout`` entries, written by either package,
    gives the same three outputs in both (one entry by default, as the
    reference's Symbol layer makes)."""
    import mxnet_tpu as mx

    src, dst = (mx, tmx) if writer == "reference" else (tmx, mx)
    s = src.sym.SliceChannel(src.sym.var("x"), num_outputs=3, axis=1,
                             squeeze_axis=True, nout=3)
    assert len(src.sym.SliceChannel(src.sym.var("x"), num_outputs=3)
               .list_outputs()) == 1
    graph = json.loads(s.tojson())
    assert graph["heads"] == [[1, 0], [1, 1], [1, 2]]
    x = onp.arange(24, dtype="float32").reshape(2, 3, 4)
    outs = []
    for pkg in (dst, src):
        exe = pkg.sym.fromjson(s.tojson()).bind(
            pkg.cpu(), args={"x": pkg.np.array(x)})
        outs.append([o.asnumpy() for o in exe.forward()])
    assert len(outs[0]) == len(outs[1]) == 3
    for g, w in zip(*outs):
        onp.testing.assert_array_equal(g, w)


def test_make_loss_ignores_head_gradients_in_an_executor():
    """``backward()`` with or without ``out_grads`` gives the same
    gradients through ``MakeLoss``."""
    rng = onp.random.RandomState(2)
    args = {"data": rng.randn(2, 3, 6, 6), "w": rng.randn(6, 3, 3, 3) * 0.3,
            "b": rng.randn(6) * 0.1, "fw": rng.randn(5, 54) * 0.2,
            "fb": rng.randn(5) * 0.1, "label": onp.array([0.0, 4.0])}
    sym = _small_graph(tmx)
    grads = []
    for heads in (None, tmx.nd.array(onp.full(2, 7.0, "float32"))):
        exe = sym.simple_bind(tmx.cpu(), **{n: v.shape
                                            for n, v in args.items()})
        for n, v in args.items():
            exe.arg_dict[n][:] = tmx.nd.array(v.astype("float32"))
        exe.forward(is_train=True)
        exe.backward(heads)
        grads.append(exe.arg_dict["w"].grad.asnumpy())
    onp.testing.assert_array_equal(grads[0], grads[1])


def test_script_loss_falls():
    """Six steps of the narrow AlexNet on four fixed batches (the
    loop of ``chip_smoke.py`` phase 17): the loss falls. Dropout's masks
    come from the port's generator, seeded here as a process that runs this
    file alone starts: six steps move the loss by about as much as the
    masks do, so the generator's state that earlier tests of the same
    worker leave would decide the outcome."""
    tmx.random.seed(0)
    sym = alex.alexnet_symbol(tmx, W, 10, 8)
    weights = alex.init_weights(W, IMG, 10)
    batches = alex.synthetic_batches(1, 8, IMG, 10)
    exe = alex.bind(tmx, sym, weights, 8, IMG, tmx.cpu())
    losses = alex.train(tmx, exe, sym, batches, 6, tmx.cpu())
    assert all(onp.isfinite(losses)) and losses[-1] < losses[0]


# -- on the card --------------------------------------------------------------
@pytest.mark.cuda
def test_alexnet_step_on_card():
    """A batch-2 step of the narrow AlexNet (dropout 0) on the card against
    the CPU: the loss and probabilities within 1e-5; each gradient no
    further from a float64 twin than twice the CPU fp32 run's distance (a
    batch-2 conv net's fp32 gradients are ill-conditioned)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    old = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        sym = alex.alexnet_symbol(tmx, W, CLASSES, B, dropout=0.0)
        weights = alex.init_weights(W, IMG, CLASSES)
        batch = alex.synthetic_batches(1, B, IMG, CLASSES)[0]
        res = {}
        for name, ctx in (("cpu", tmx.cpu()), ("gpu", tmx.gpu())):
            with ctx:
                exe = alex.bind(tmx, sym, weights, B, IMG, ctx)
                out = exe.forward(is_train=True,
                                  data=tmx.nd.array(batch[0], ctx=ctx),
                                  label=tmx.nd.array(batch[1], ctx=ctx))
                exe.backward()
                res[name] = (out[0].asnumpy(), {
                    n: exe.arg_dict[n].grad.asnumpy()
                    for n in alex.param_names(sym)})
        assert _rel(res["gpu"][0], res["cpu"][0]) <= RTOL
        twin = alex.f64_grads(tmx, sym, weights, batch)
        for n, t in twin.items():
            scale = max(abs(t).max(), 1e-30)
            cpu_err = abs(res["cpu"][1][n] - t).max() / scale
            gpu_err = abs(res["gpu"][1][n] - t).max() / scale
            assert gpu_err <= max(2 * cpu_err, 1e-5), (n, gpu_err, cpu_err)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = old
