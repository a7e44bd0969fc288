"""PyTorch/CUDA port: ``HybridBlock.export`` and ``gluon.SymbolBlock``
across both packages, on the CPU.

Each package runs the other's exported graphs:

- the JAX package exports tiny BERT (2 layers, 64 units, 4 heads, hidden
  128, vocab 100, T = 16, token types, valid lengths 16 and 9) and
  ResNet-18 v1 at 32x32 (predict mode); the port's
  ``SymbolBlock.imports(..., ctx=mx.cpu())`` gives the same outputs, eager
  and hybridized;
- the port exports the same models, holding the same weights (carried
  across by the ``.params`` file, i.e. ``params_from_mxnet_tpu``); the JAX
  package's ``SymbolBlock.imports`` gives the same outputs;
- the Dense-ReLU-Dense case of ``tests/test_gluon.py``'s
  ``test_export_symbolblock_import``, both ways.

Also: an imported block is a ``HybridBlock`` (its gradients under
``record()``, eager and as one tape node, against the JAX package's; ``cast``,
``load_parameters``, ``collect_params()`` names), serves through a
``Predictor`` built from a warmup manifest (``tests/test_serve.py``'s
``test_export_import_predictor_roundtrip``), ``export`` refuses before a
hybridized forward and for fp8 parameters, an imported params entry of raw
bytes other than bfloat16's two is refused (bfloat16 graphs cross both
ways: ``tests/test_torch_amp16.py``), and BatchNorm's running statistics come back from a traced
training graph as aux updates. On the card: the imported BERT against the
block it came from, one CUDA graph a signature, with its flash and
LayerNorm launches.

Tolerance: 1e-5 of each tensor's largest entry (fp32 sums in another order;
``tests/test_torch_resnet.py``'s predict-mode bound); the port against
itself (import, hybridize): bitwise on the CPU, where a program runs its
body eagerly.

The JAX package is imported inside the fixtures and tests that use it, so
``pytest --noconftest tests/test_torch_export.py -m cuda`` collects this
file on a machine without JAX.
"""
import json

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError, autograd as tag
from mxnet_tpu_torch import serve
from mxnet_tpu_torch.gluon import SymbolBlock
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo import BERTModel
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet18_v1
from mxnet_tpu_torch.ops import cuda_kernels as ck
from mxnet_tpu_torch.symbol import topo_sort

RTOL = 1e-5
BERT_CFG = dict(vocab_size=100, num_layers=2, units=64, hidden_size=128,
                num_heads=4, max_length=32, dropout=0.0)
BERT_IN = ["data0", "data1", "data2"]


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _rel(got, want):
    got = onp.asarray(got, dtype="float64")
    want = onp.asarray(want, dtype="float64")
    return float(abs(got - want).max() / max(abs(want).max(), 1e-30))


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else x.detach().numpy()


def _bert_inputs():
    rs = onp.random.RandomState(0)
    tok = rs.randint(0, 100, (2, 16)).astype("int32")
    tt = rs.randint(0, 2, (2, 16)).astype("int32")
    return tok, tt, onp.array([16, 9], "float32")


def _image():
    return onp.random.RandomState(1).randn(2, 3, 32, 32).astype("float32")


def _weights(shapes, seed):
    rs = onp.random.RandomState(seed)
    out = {}
    for name, shape in shapes.items():
        if name.endswith(("gamma", "running_var")):
            a = 1 + 0.1 * rs.rand(*shape)
        elif len(shape) == 1:
            a = 0.1 * rs.randn(*shape)
        else:
            a = rs.randn(*shape) / onp.sqrt(onp.prod(shape[1:]))
        out[name] = a.astype("float32")
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX package's exports of tiny BERT and ResNet-18 v1 (numpy
    weights), with their outputs, and the JAX package's ``SymbolBlock``
    class."""
    import mxnet_tpu as mx
    from mxnet_tpu.gluon.model_zoo.bert import BERTModel as JB
    from mxnet_tpu.gluon.model_zoo.vision import resnet18_v1 as jr18

    d = tmp_path_factory.mktemp("export")
    out = {"SymbolBlock": mx.gluon.SymbolBlock, "np": mx.np, "dir": d}
    mx.random.seed(0)
    for key, net, args in (
            ("bert", JB(**BERT_CFG), _bert_inputs()),
            ("resnet", jr18(), (_image(),))):
        net.initialize()
        net(*[mx.np.array(a) for a in args])     # deferred shapes
        params = net.collect_params()
        w = _weights({n: p.shape for n, p in params.items()}, seed=2)
        for n, p in params.items():
            p.set_data(mx.np.array(w[n]))
        net.hybridize()
        res = net(*[mx.np.array(a) for a in args])
        res = res if isinstance(res, (tuple, list)) else (res,)
        files = net.export(str(d / f"jax-{key}"))
        out[key] = (files, [r.asnumpy() for r in res])
    return out


def _jax_import(ref, files, names, args):
    blk = ref["SymbolBlock"].imports(files[0], names, files[1])
    res = blk(*[ref["np"].array(a) for a in args])
    return [r.asnumpy() for r in (res if isinstance(res, (tuple, list))
                                  else (res,))]


@pytest.mark.parametrize("model", ["bert", "resnet"])
def test_port_runs_the_reference_export(ref, model):
    files, want = ref[model]
    names, args = (BERT_IN, _bert_inputs()) if model == "bert" else \
        ("data0", (_image(),))
    blk = SymbolBlock.imports(files[0], names, files[1], ctx=tmx.cpu())
    targs = [torch.from_numpy(a) for a in args]
    with torch.no_grad():
        eager = blk(*targs)
        blk.hybridize()
        hyb = blk(*targs)
    eager = eager if isinstance(eager, tuple) else (eager,)
    hyb = hyb if isinstance(hyb, tuple) else (hyb,)
    for e, h, w in zip(eager, hyb, want):
        assert _rel(_np(e), w) <= RTOL
        assert torch.equal(e, h)
    assert len(blk._cached) == 1
    # the parameters keep the graph's dotted names
    with onp.load(files[1]) as z:
        assert sorted(blk.collect_params()) == sorted(z.files)


@pytest.mark.parametrize("model", ["bert", "resnet"])
def test_reference_runs_the_port_export(ref, model, tmp_path):
    files, want = ref[model]
    if model == "bert":
        net, names, args = BERTModel(**BERT_CFG, device="cpu"), BERT_IN, \
            _bert_inputs()
    else:
        net, names, args = resnet18_v1(), ["data0"], (_image(),)
    net.load_parameters(files[1])
    net.hybridize()
    with torch.no_grad():
        got = net(*[torch.from_numpy(a) for a in args])
    got = got if isinstance(got, tuple) else (got,)
    sym_file, param_file = net.export(str(tmp_path / model))
    assert sym_file.endswith("-symbol.json")
    assert param_file.endswith("-0000.params.npz")
    back = _jax_import(ref, (sym_file, param_file), names, args)
    for g, b, w in zip(got, back, want):
        assert _rel(_np(g), w) <= RTOL
        assert _rel(b, _np(g)) <= RTOL
    graph = json.load(open(sym_file))
    assert graph["mxnet_tpu_version"] == 1
    ops = {n["op"] for n in graph["nodes"]}
    if model == "bert":
        assert {"multihead_attention", "layer_norm", "embedding", "less",
                "astype", "slice_key", "expand_dims", "_const"} <= ops
        assert sum(n["op"] == "layer_norm" for n in graph["nodes"]) == 5
    else:
        assert ops == {"null", "convolution", "batch_norm", "activation",
                       "add", "pooling", "fully_connected"}


def test_export_symbolblock_import_dense(ref, tmp_path):
    """``tests/test_gluon.py``'s Dense-ReLU-Dense export, loaded by both
    packages."""
    net = tnn.HybridSequential()
    net.add(tnn.Dense(4, activation="relu", in_units=3),
            tnn.Dense(2, in_units=4))
    net.initialize(seed=3)
    net.hybridize()
    x = onp.random.RandomState(4).uniform(size=(2, 3)).astype("float32")
    want = net(tmx.np.array(x)).asnumpy()
    sym_file, param_file = net.export(str(tmp_path / "model"))
    loaded = SymbolBlock.imports(sym_file, "data0", param_file)
    onp.testing.assert_allclose(loaded(tmx.np.array(x)).asnumpy(), want,
                                rtol=1e-5, atol=1e-5)
    back = _jax_import(ref, (sym_file, param_file), "data0", (x,))[0]
    onp.testing.assert_allclose(back, want, rtol=1e-5, atol=1e-5)


def _mlp(tmp_path, ref=None):
    """A Dense MLP exported by the port, imported back, and (with ``ref``)
    by the JAX package."""
    net = tnn.HybridSequential()
    net.add(tnn.Dense(16, activation="tanh", in_units=6),
            tnn.Dense(3, in_units=16))
    net.initialize(seed=6)
    net.hybridize()
    net(torch.zeros(1, 6))
    files = net.export(str(tmp_path / "mlp"))
    return net, files


@pytest.mark.parametrize("hybrid", [False, True])
def test_symbol_block_gradients_match_the_reference(ref, tmp_path, hybrid):
    _, (sym_file, param_file) = _mlp(tmp_path)
    x = onp.random.RandomState(7).randn(5, 6).astype("float32")
    blk = SymbolBlock.imports(sym_file, ["data0"], param_file)
    if hybrid:
        blk.hybridize()
    with tag.record():
        y = blk(tmx.np.array(x))
        loss = (y * y).sum()
    loss.backward()
    import mxnet_tpu as mx

    jblk = ref["SymbolBlock"].imports(sym_file, ["data0"], param_file)
    with mx.autograd.record():
        jy = jblk(mx.np.array(x))
        jloss = (jy * jy).sum()
    jloss.backward()
    jparams = jblk.collect_params()
    for name, p in blk.collect_params().items():
        assert _rel(p.grad.numpy(), jparams[name].grad().asnumpy()) <= RTOL
    if hybrid:
        (cop, _, _), = blk._cached.values()
        assert len(cop._recorded) == 1


def test_symbol_block_is_a_block(tmp_path):
    net, (sym_file, param_file) = _mlp(tmp_path)
    blk = SymbolBlock.imports(sym_file, "data0", param_file)
    assert list(blk.collect_params()) == list(net.collect_params())
    x = torch.from_numpy(onp.random.RandomState(8).randn(4, 6)
                         .astype("float32"))
    blk.hybridize()
    with torch.no_grad():
        want = net(x)
        assert torch.equal(blk(x), want)
        blk.cast("float64")
        assert blk(x.double()).dtype == torch.float64
        blk.cast("float32")
        net.collect_params()["0.weight"].mul_(2)
    net.save_parameters(str(tmp_path / "doubled.params"))
    blk.load_parameters(str(tmp_path / "doubled.params"))
    with torch.no_grad():
        assert torch.equal(blk(x), net(x))
    with pytest.raises(MXNetError, match="not in the graph"):
        blk.load_dict({"nope": onp.zeros(1, "float32")})
    with pytest.raises(MXNetError, match="inputs"):
        blk(x, x)
    part = SymbolBlock.imports(sym_file, "data0", None,
                               allow_missing_params=True)
    with pytest.raises(MXNetError, match="not loaded"):
        part(x)
    part.load_parameters(str(tmp_path / "doubled.params"))
    with torch.no_grad():
        assert torch.equal(part(x), blk(x))
    with pytest.raises(MXNetError, match="missing"):
        SymbolBlock.imports(sym_file, "data0", None)
    with pytest.raises(MXNetError, match="not variables"):
        SymbolBlock.imports(sym_file, "input", param_file)


def test_export_refusals(tmp_path):
    net = tnn.Dense(2, in_units=3)
    net.initialize(seed=0)
    with pytest.raises(MXNetError, match="hybridize"):
        net.export(str(tmp_path / "m"))
    net.hybridize()
    net(torch.zeros(1, 3))
    net.cast("float8_e4m3fn")
    with pytest.raises(MXNetError, match="fp8"):
        net.export(str(tmp_path / "m"))
    net.cast("float32")
    sym_file, _ = net.export(str(tmp_path / "m"))
    bad = tmp_path / "v1.npz"
    params = {"weight": onp.zeros((2, 3), dtype="V1"),
              "bias": onp.zeros(2, "float32")}
    onp.savez(str(bad), **params)
    with pytest.raises(MXNetError, match="not read"):
        SymbolBlock.imports(sym_file, "data0", str(bad))


def test_amp_attribute_never_reaches_the_json(tmp_path):
    from mxnet_tpu_torch import amp as tamp

    net = tnn.Dense(4, in_units=3)
    net.initialize(seed=0)
    net.hybridize()
    with tamp.autocast("bfloat16"):
        net(torch.ones(2, 3))
    assert any("__amp__" in n.attrs for n in topo_sort(
        next(iter(net._cached.values()))[0].sym._entries))
    sym_file, _ = net.export(str(tmp_path / "amp"))
    assert "__amp__" not in open(sym_file).read()


def test_batch_norm_statistics_are_aux_updates():
    """A BatchNorm net optimized (default backend) and run under
    ``record()``: the traced graph writes the running statistics after the
    call, as the eager block does."""
    def make():
        net = tnn.HybridSequential()
        net.add(tnn.Dense(8, in_units=4), tnn.BatchNorm(in_channels=8))
        net.initialize(seed=9)
        return net

    x = torch.from_numpy(onp.random.RandomState(9).randn(6, 4)
                         .astype("float32"))
    eager, traced = make(), make()
    traced.optimize_for(x, backend="default")
    for net in (eager, traced):
        with tag.record():
            y = net(x)
        tag.backward(y)
    (cop, _, _), *_ = [v for k, v in traced._cached.items() if k[2]]
    assert len(cop._aux_targets) == 2
    for name, p in eager.collect_params().items():
        q = traced.collect_params()[name]
        assert torch.allclose(p, q, rtol=1e-6, atol=1e-6), name
        if p.grad is not None:
            assert torch.allclose(p.grad, q.grad, rtol=1e-5, atol=1e-6)


def test_predictor_over_an_imported_block(tmp_path):
    """``tests/test_serve.py``'s export / import / Predictor round trip:
    the manifest written by the block's predictor makes every bucket of
    the imported block's at construction, and nothing after."""
    net, (sym_file, param_file) = _mlp(tmp_path)
    rows = onp.random.RandomState(2).randn(8, 6).astype("float32")
    x = torch.from_numpy(rows[:4])
    with torch.no_grad():
        want = net(x).numpy()
    mpath = str(tmp_path / "model.warmup.json")
    pred = net.predictor(example=x, max_batch=8, cache_dir=False)
    try:
        pred.warmup(mpath)
    finally:
        pred.close()
    blk = SymbolBlock.imports(sym_file, ["data0"], param_file)
    pred2 = blk.predictor(manifest=mpath, cache_dir=False)
    try:
        made = pred2.stats()["captures"]
        assert pred2.buckets == [1, 2, 4, 8]
        for n in (1, 3, 4, 8):
            assert pred2.predict(rows[:n]).shape == (n, 3)
        onp.testing.assert_allclose(pred2.predict(x).asnumpy(), want,
                                    rtol=2e-5, atol=2e-5)
        f = pred2.submit(rows[0])
        onp.testing.assert_allclose(f.result(timeout=60), want[0],
                                    rtol=2e-5, atol=2e-5)
        assert pred2.stats()["captures"] == made
    finally:
        pred2.close()
    serve.load_manifest(mpath)


# -- on the card --------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_imported_bert_on_the_card(cuda, tmp_path):
    """Tiny BERT exported on the card and imported back there: hybridized,
    the same outputs as the block it came from (the same kernels in the
    same order: bitwise), one program a signature, and per forward one
    ``flash_fwd`` (key-padding branch) a layer and one ``layer_norm`` a
    LayerNorm."""
    net = BERTModel(**BERT_CFG, device=cuda)
    net.initialize(seed=4)
    net.hybridize()
    args = [torch.from_numpy(a).to(cuda) for a in _bert_inputs()]
    with torch.no_grad():
        want = net(*args)
    files = net.export(str(tmp_path / "bert"))
    blk = SymbolBlock.imports(files[0], BERT_IN, files[1], ctx=tmx.gpu())
    blk.hybridize()
    with torch.no_grad():
        blk(*args)
        before = ck.launch_counts()
        got = blk(*args)
        torch.cuda.synchronize()
        assert ck.launch_counts() == before     # a replay launches nothing
    (cop, _, _), = blk._cached.values()
    stats = cop.graph_stats()
    assert len(stats) == 1 and stats[0]["replays"] == 2
    captured = stats[0]["captured_launches"]
    assert captured["flash_fwd"] == 2 and captured["layer_norm"] == 5
    for g, w in zip(got, want):
        assert torch.equal(g, w)
