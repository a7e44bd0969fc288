"""PyTorch/CUDA port: ``mx.contrib.quantization`` against the JAX package
on the CPU.

``quantize``/``dequantize`` per tensor and per output channel (codes
bitwise, scales exact); ``_LayerStats`` on the same arrays (a growing
largest magnitude rebins) and ``calibrate_net`` in both modes on a
hybridized net: every histogram bitwise, the largest magnitudes and scales
within ``SCALE_RTOL`` (1e-6: the second layer's inputs are each package's
float32 products); ``QuantizedDense`` on the static int8 path and
``quantize_net`` without calibration; ``quantize_net`` with entropy
calibration on the reference's int8 test head (``BasicBlockV1``, global
pooling, ``Dense``; ``tests/test_contrib.py``) and on a 2-layer, 64-unit
``BERTModel``, each with the reference's weights through one ``.params``
file: the layers converted and ``collect_params()`` after conversion as the
reference's, the calibrated scales within ``SCALE_RTOL`` and the outputs
within ``NET_RTOL`` (1e-5) of the largest entry: the integer products are
exact, and on these inputs every code falls as the reference's; the Conv1D
layer left in float32, an all-zero weight, and the reference's other
``contrib`` modules raising ``MXNetError`` naming their ROADMAP item. The
``cuda`` tests hold the head and the BERT on the card against the CPU
within ``CARD_NET_RTOL`` (2e-2): the card's float32 activations are summed
in another order, and a code that falls on the other side of a half there
moves an output by about one quantum, ~0.8 % of the largest entry here.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import np as tnp
from mxnet_tpu_torch.contrib import quantization as tq
from mxnet_tpu_torch.gluon import nn as tnn

SCALE_RTOL = 1e-6
NET_RTOL = 1e-5
CARD_NET_RTOL = 2e-2
BERT = dict(vocab_size=100, num_layers=2, units=64, hidden_size=128,
            num_heads=4, max_length=32, dropout=0.0)
_RUNS = {}           # each reference run once a process


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    old = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = old


def _rel(got, want):
    got = onp.asarray(got, "float64")
    want = onp.asarray(want, "float64")
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(abs(got - want).max() / max(abs(want).max(), 1e-30))


def _scales_close(got, want):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for p in want:
        assert abs(got[p] - want[p]) <= SCALE_RTOL * abs(want[p]), \
            (p, got[p], want[p])


def _act_scales(net):
    """``{path: act_scale}`` of every quantized layer of either package."""
    out = {}

    def walk(block, prefix=""):
        kids = block._modules.items() if hasattr(block, "_modules") else \
            block._children.items()
        for name, child in kids:
            if child is None:
                continue
            if type(child).__name__ == "_QuantizedDenseBlock":
                out[prefix + name] = child._q.act_scale
            else:
                walk(child, prefix + name + ".")

    walk(net)
    return out


@pytest.mark.parametrize("channel_axis", [None, 0])
def test_quantize_and_dequantize_match_the_reference(channel_axis):
    from mxnet_tpu import np as jnp
    from mxnet_tpu.contrib import quantization as jq

    rs = onp.random.RandomState(3)
    x = (rs.uniform(-3, 3, (6, 8)) *
         onp.arange(1, 7)[:, None]).astype("float32")
    jq_, js = jq.quantize(jnp.array(x), channel_axis=channel_axis)
    q, s = tq.quantize(tnp.array(x), channel_axis=channel_axis)
    assert str(q.dtype) == "int8" and q.shape == jq_.shape
    onp.testing.assert_array_equal(q.asnumpy(), jq_.asnumpy())
    onp.testing.assert_array_equal(s.asnumpy(), js.asnumpy())
    onp.testing.assert_array_equal(tq.dequantize(q, s).asnumpy(),
                                   jq.dequantize(jq_, js).asnumpy())
    back = tq.dequantize(q, s).asnumpy()
    assert abs(back - x).max() <= s.asnumpy().max() / 2 * (1 + 1e-6)


def test_layer_stats_histograms_match_the_reference():
    """The same arrays, the third with a larger maximum (a rebin), through
    both packages' ``_LayerStats``: histograms bitwise, the largest
    magnitude and both scales equal."""
    from mxnet_tpu.contrib import quantization as jq

    rs = onp.random.RandomState(4)
    arrays = [rs.randn(64, 32).astype("float32") * s for s in (1, 0.5, 3, 2)]
    arrays[1][0, 0] = 0.0
    j, t = jq._LayerStats(), tq._LayerStats()
    for a in arrays:
        j.update(a)
        t.update(torch.from_numpy(a))
        onp.testing.assert_array_equal(t.hist.numpy(), j.hist)
        assert t.absmax == j.absmax
    for mode in ("naive", "entropy"):
        assert t.scale(mode) == j.scale(mode), mode


def _recorded(monkeypatch, module):
    """Every ``_LayerStats`` that ``module.calibrate_net`` makes, in
    order."""
    made = []

    class Recorded(module._LayerStats):
        __slots__ = ()

        def __init__(self):
            super().__init__()
            made.append(self)

    monkeypatch.setattr(module, "_LayerStats", Recorded)
    return made


def _mlp_pair(tmp_path):
    """The reference's hybridized two-layer MLP and the port's, one set of
    weights."""
    import mxnet_tpu as mx

    mx.random.seed(1)
    jnet = mx.gluon.nn.HybridSequential()
    jnet.add(mx.gluon.nn.Dense(8, activation="relu", in_units=4),
             mx.gluon.nn.Dense(2, in_units=8))
    jnet.initialize()
    path = str(tmp_path / "mlp.params")
    jnet.save_parameters(path)
    net = tnn.HybridSequential()
    net.add(tnn.Dense(8, activation="relu", in_units=4),
            tnn.Dense(2, in_units=8))
    net.load_parameters(path)
    return jnet, net


@pytest.mark.parametrize("mode", ["naive", "entropy"])
def test_calibrate_net_on_a_hybridized_net(tmp_path, monkeypatch, mode):
    import mxnet_tpu as mx
    from mxnet_tpu.contrib import quantization as jq

    jnet, net = _mlp_pair(tmp_path)
    rs = onp.random.RandomState(5)
    xs = [(rs.randn(16, 4) * 10).astype("float32") for _ in range(3)]
    for n in (jnet, net):
        n.hybridize()
    jnet(mx.np.array(xs[0]))
    net(tnp.array(xs[0]))                  # the cache is built
    j_made, t_made = _recorded(monkeypatch, jq), _recorded(monkeypatch, tq)
    want = jq.calibrate_net(jnet, iter([mx.np.array(x) for x in xs]),
                            num_batches=3, calib_mode=mode)
    got = tq.calibrate_net(net, iter([tnp.array(x) for x in xs]),
                           num_batches=3, calib_mode=mode)
    _scales_close(got, want)
    assert max(got.values()) > 0.05
    assert len(t_made) == len(j_made) == 2
    for t, j in zip(t_made, j_made):
        onp.testing.assert_array_equal(t.hist.cpu().numpy(), j.hist)
        assert t.samples == j.samples == 3
    assert net._active and net._cached         # hybridization restored
    with pytest.raises(MXNetError, match="unknown calib_mode"):
        tq.calibrate_net(net, iter(xs), calib_mode="kl")


def test_quantized_dense_and_weights_only_quantize_net(tmp_path):
    """``QuantizedDense`` on a calibrated scale, and ``quantize_net``
    without calibration data (weights dequantized on use), against the
    reference on the same weights."""
    import mxnet_tpu as mx
    from mxnet_tpu.contrib import quantization as jq

    jnet, net = _mlp_pair(tmp_path)
    x = onp.random.RandomState(6).randn(8, 4).astype("float32")
    want = jq.QuantizedDense(jnet[0], act_scale=0.031)(mx.np.array(x))
    got = tq.QuantizedDense(net[0], act_scale=0.031)(tnp.array(x))
    assert _rel(got.asnumpy(), want.asnumpy()) <= 1e-6
    with pytest.raises(MXNetError, match="wraps a Dense"):
        tq.QuantizedDense(tnn.Activation("relu"))
    jq.quantize_net(jnet)
    tq.quantize_net(net)
    assert _rel(net(tnp.array(x)).asnumpy(),
                jnet(mx.np.array(x)).asnumpy()) <= 1e-6
    assert _act_scales(net) == {"0": None, "1": None}


def _head_run():
    """The reference's int8 test head (``tests/test_contrib.py``): weights
    file, fp32 and int8 logits on eval batches, scales and parameter
    names after conversion."""
    if "head" in _RUNS:
        return _RUNS["head"]
    import tempfile

    import mxnet_tpu as mx
    from mxnet_tpu.contrib import quantization as jq
    from mxnet_tpu.gluon.model_zoo.vision.resnet import BasicBlockV1

    mx.random.seed(0)
    head = mx.gluon.nn.Sequential()
    head.add(BasicBlockV1(16, 1, downsample=False, in_channels=16))
    head.add(mx.gluon.nn.GlobalAvgPool2D())
    head.add(mx.gluon.nn.Dense(10, in_units=16))
    head.initialize()
    rs = onp.random.RandomState(0)
    xs = [rs.randn(8, 16, 8, 8).astype("float32") for _ in range(5)]
    fp32 = [head(mx.np.array(x)).asnumpy() for x in xs]
    path = tempfile.mkdtemp(prefix="qhead-") + "/head.params"
    head.save_parameters(path)
    jq.quantize_net(head, calib_data=iter([mx.np.array(x) for x in xs[:4]]),
                    calib_mode="entropy", num_calib_batches=4)
    int8 = [head(mx.np.array(x)).asnumpy() for x in xs]
    _RUNS["head"] = dict(path=path, xs=xs, fp32=fp32, int8=int8,
                         scales=_act_scales(head),
                         names=sorted(head.collect_params()))
    return _RUNS["head"]


def _port_head(path, device="cpu"):
    from mxnet_tpu_torch.gluon.model_zoo.vision.resnet import BasicBlockV1

    head = tnn.Sequential()
    head.add(BasicBlockV1(16, 1, downsample=False, in_channels=16))
    head.add(tnn.GlobalAvgPool2D())
    head.add(tnn.Dense(10, in_units=16))
    head.load_parameters(path)
    return head.to(device)


def test_quantize_net_resnet_block_head_matches_the_reference():
    ref = _head_run()
    head = _port_head(ref["path"])
    xs = [tnp.array(x) for x in ref["xs"]]
    for x, want in zip(xs, ref["fp32"]):
        assert _rel(head(x).asnumpy(), want) <= 1e-5
    tq.quantize_net(head, calib_data=iter(xs[:4]), calib_mode="entropy",
                    num_calib_batches=4)
    scales = _act_scales(head)
    assert sorted(scales) == ["0.body.0", "0.body.3", "2"]
    _scales_close(scales, ref["scales"])
    assert sorted(head.collect_params()) == ref["names"]
    assert not any("qweight" in n for n in head.collect_params())
    for x, want in zip(xs, ref["int8"]):
        assert _rel(head(x).asnumpy(), want) <= NET_RTOL
    # int8 stays near fp32, as the reference's own test asks (< 0.05)
    for x, want in zip(xs, ref["fp32"]):
        assert abs(head(x).asnumpy() - want).max() < 0.05


def _bert_batches():
    rs = onp.random.RandomState(7)
    calib = [rs.randint(0, 100, (4, 16)).astype("int32") for _ in range(2)]
    tok = rs.randint(0, 100, (3, 16)).astype("int32")
    tt = rs.randint(0, 2, (3, 16)).astype("int32")
    vl = onp.array([16, 9, 4], "float32")
    return calib, (tok, tt, vl)


def _bert_run():
    if "bert" in _RUNS:
        return _RUNS["bert"]
    import tempfile

    import mxnet_tpu as mx
    from mxnet_tpu.contrib import quantization as jq
    from mxnet_tpu.gluon.model_zoo.bert import BERTModel

    mx.random.seed(2)
    net = BERTModel(**BERT)
    net.initialize(mx.initializer.Normal(0.3))
    calib, args = _bert_batches()
    net(mx.np.array(calib[0]))
    path = tempfile.mkdtemp(prefix="qbert-") + "/bert.params"
    net.save_parameters(path)
    jq.quantize_net(net, calib_data=iter([mx.np.array(c) for c in calib]),
                    calib_mode="entropy", num_calib_batches=2)
    seq, pooled = net(*(mx.np.array(a) for a in args))
    _RUNS["bert"] = dict(path=path, seq=seq.asnumpy(),
                         pooled=pooled.asnumpy(), scales=_act_scales(net),
                         names=sorted(net.collect_params()))
    return _RUNS["bert"]


def _port_bert(path, device="cpu"):
    from mxnet_tpu_torch.gluon.model_zoo import BERTModel

    net = BERTModel(**BERT, device="cpu")
    net.load_parameters(path)
    return net.to(device)


def test_quantize_net_bert_matches_the_reference():
    """A 2-layer BERT with the reference's weights, calibrated (entropy) on
    the same token batches: 9 ``Dense`` layers converted (4 a layer and the
    pooler), their scales and the masked forward's outputs as the
    reference's."""
    ref = _bert_run()
    net = _port_bert(ref["path"])
    calib, args = _bert_batches()
    tq.quantize_net(net, calib_data=iter([tnp.array(c) for c in calib]),
                    calib_mode="entropy", num_calib_batches=2)
    scales = _act_scales(net)
    assert len(scales) == 9 and "encoder.layers.1.ffn_2" in scales
    _scales_close(scales, ref["scales"])
    assert sorted(net.collect_params()) == ref["names"]
    seq, pooled = net(*(tnp.array(a) for a in args))
    assert _rel(seq.asnumpy(), ref["seq"]) <= NET_RTOL
    assert _rel(pooled.asnumpy(), ref["pooled"]) <= NET_RTOL


def test_quantize_net_leaves_conv1d_and_handles_zero_weights():
    net = tnn.Sequential()
    net.add(tnn.Conv1D(4, 3, padding=1, in_channels=2))
    net.initialize(seed=0)
    x = tnp.array(onp.random.RandomState(8).randn(2, 2, 8).astype(
        "float32"))
    want = net(x).asnumpy()
    tq.quantize_net(net, calib_data=iter([x] * 2), num_calib_batches=2)
    assert isinstance(net[0], tnn.Conv1D)          # left in float32
    onp.testing.assert_allclose(net(x).asnumpy(), want, rtol=1e-6)
    qz, s = tq.quantize(tnp.zeros((4, 4)))
    assert not onp.isnan(tq.dequantize(qz, s).asnumpy()).any()
    dead = tnn.HybridSequential()
    dead.add(tnn.Dense(3, in_units=2))
    dead.initialize(seed=0)
    with pytest.raises(MXNetError, match="saw no data"):
        tq.calibrate_net(dead, iter([]))
    with pytest.raises(MXNetError, match="only int8"):
        tq.quantize_net(dead, quantized_dtype="uint8")


@pytest.mark.parametrize("name,item", [("onnx", "A10 \\(4\\)"),
                                       ("text", "A10 \\(5\\)"),
                                       ("tensorboard", "A10 \\(5\\)"),
                                       ("tensorrt", "A10 \\(5\\)")])
def test_other_contrib_modules_name_their_roadmap_item(name, item):
    assert tmx.contrib.quantization is tq
    with pytest.raises(MXNetError, match=item):
        getattr(tmx.contrib, name)


# -- on the card ---------------------------------------------------------------
@pytest.mark.cuda
def test_quantized_head_on_the_card(cuda, tmp_path):
    """The head quantized on the card and on the CPU from one weights file:
    the buffers moved with ``.to``, the scales within ``SCALE_RTOL``, the
    logits within ``CARD_NET_RTOL``."""
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as zr

    src = tnn.Sequential()
    src.add(zr.BasicBlockV1(16, 1, downsample=False, in_channels=16))
    src.add(tnn.GlobalAvgPool2D())
    src.add(tnn.Dense(10, in_units=16))
    src.initialize(seed=0)
    rs = onp.random.RandomState(0)
    xs = [rs.randn(8, 16, 8, 8).astype("float32") for _ in range(5)]
    src(tnp.array(xs[0]))
    path = str(tmp_path / "head.params")
    src.save_parameters(path)
    nets = {}
    for dev in ("cpu", cuda):
        head = _port_head(path, dev)
        data = [torch.from_numpy(x).to(dev) for x in xs]
        tq.quantize_net(head, calib_data=iter(data[:4]),
                        calib_mode="entropy", num_calib_batches=4)
        nets[str(dev)] = (head, data)
    card, cpu = nets["cuda"][0], nets["cpu"][0]
    assert all(b.is_cuda for b in card.buffers())
    _scales_close(_act_scales(card), _act_scales(cpu))
    with torch.no_grad():
        for x_card, x_cpu in zip(nets["cuda"][1], nets["cpu"][1]):
            assert _rel(card(x_card).cpu().numpy(),
                        cpu(x_cpu).numpy()) <= CARD_NET_RTOL


@pytest.mark.cuda
def test_quantized_bert_on_the_card(cuda, tmp_path):
    """A 2-layer BERT quantized on the card (``torch._int_mm``) and on the
    CPU from one weights file: scales within ``SCALE_RTOL`` and outputs
    within ``CARD_NET_RTOL``, eager and hybridized (one CUDA graph)
    equal."""
    from mxnet_tpu_torch.gluon.model_zoo import BERTModel

    src = BERTModel(**BERT, device="cpu")
    src.initialize(seed=3)
    path = str(tmp_path / "bert.params")
    src.save_parameters(path)
    calib, args = _bert_batches()
    outs, scales = {}, {}
    for dev in ("cpu", cuda):
        net = _port_bert(path, dev)
        tq.quantize_net(net, calib_data=iter(
            [torch.from_numpy(c).to(dev) for c in calib]),
            calib_mode="entropy", num_calib_batches=2)
        scales[str(dev)] = _act_scales(net)
        a = [torch.from_numpy(x).to(dev) for x in args]
        with torch.no_grad():
            outs[str(dev)] = net(*a)
            if dev != "cpu":
                net.hybridize()
                net(*a)
                hyb = net(*a)
                for e, h in zip(outs["cuda"], hyb):
                    assert torch.equal(e, h)
    _scales_close(scales["cuda"], scales["cpu"])
    for g, w in zip(outs["cuda"], outs["cpu"]):
        assert _rel(g.cpu().numpy(), w.numpy()) <= CARD_NET_RTOL
