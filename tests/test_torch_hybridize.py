"""PyTorch/CUDA port: ``hybridize`` and ``cached_op`` against the eager
port and the JAX package, on the CPU.

A hybridized block is held to the same block run eagerly and to the JAX
package's hybridized block loaded from the same ``.params`` file, for a
Dense MLP, a ResNet v1 thumbnail (``ResNetV1(BottleneckV1, [1, 1, 1, 1],
[8, 16, 32, 64, 128], thumbnail=True)`` in predict mode) and tiny BERT (2
layers, 64 units, 4 heads, hidden 128, vocab 100, max_length 32, dropout
0). Also: the signature cache, ``load_parameters`` after ``hybridize``,
gradients under ``record()``, deferred shapes, nested blocks, dropout's
generator, and ``cached_op.trace`` as ``bench.py``'s ResNet inference bench
uses it. Tolerances, each with its reason:

- hybridized against eager, on the CPU: bitwise (the same ops on the same
  operands; a CPU program runs its body eagerly), and on the card bitwise
  too (a replay runs the captured kernels in the eager order);
- against the JAX package: 1e-5 of each tensor's largest entry (fp32
  sums in another order; ``tests/test_torch_resnet.py``'s predict-mode
  bound).

The JAX package is imported inside the tests that use it, so ``pytest
--noconftest tests/test_torch_hybridize.py -m cuda`` collects this file on
a machine without JAX.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError, amp as tamp, autograd as tag
from mxnet_tpu_torch import cached_op, random as trandom
from mxnet_tpu_torch.gluon import HybridBlock
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.gluon.model_zoo.bert import BERTModel as TBERT
from mxnet_tpu_torch.ops import cuda_kernels as ck

RTOL = 1e-5
BERT_CFG = dict(vocab_size=100, num_layers=2, units=64, hidden_size=128,
                num_heads=4, max_length=32, dropout=0.0)
RESNET = ([1, 1, 1, 1], [8, 16, 32, 64, 128])


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _rel(got, want):
    got = onp.asarray(got, dtype="float64")
    want = onp.asarray(want, dtype="float64")
    return float(abs(got - want).max() / max(abs(want).max(), 1e-30))


def _np(t):
    """Host float32 values of a tensor or of either package's NDArray."""
    if hasattr(t, "asnumpy"):
        return onp.asarray(t.asnumpy(), dtype="float32")
    return t.detach().float().cpu().numpy()


def _mlp(pkg, **kw):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(8, activation="relu", in_units=6, **kw),
            pkg.gluon.nn.Dense(3, in_units=8, **kw))
    return net


def _weights(shapes, seed):
    """O(1) activations: weights N(0, 1/fan_in), gammas near 1, betas,
    biases and running means near 0, running variances in [1, 1.2]."""
    rs = onp.random.RandomState(seed)
    out = {}
    for name, shape in shapes.items():
        if name.endswith("running_var"):
            a = 1 + 0.2 * rs.rand(*shape)
        elif name.endswith("gamma"):
            a = 1 + 0.1 * rs.randn(*shape)
        elif name.endswith(("beta", "bias", "running_mean")):
            a = 0.1 * rs.randn(*shape)
        elif len(shape) == 1:
            a = 0.1 * rs.randn(*shape)
        else:
            a = rs.randn(*shape) / onp.sqrt(onp.prod(shape[1:]))
        out[name] = a.astype("float32")
    return out


def _jnd(a):
    from mxnet_tpu import np as mnp

    return mnp.array(a)


def _port(kind, path=None):
    if kind == "mlp":
        net = _mlp(tmx)
    elif kind == "resnet":
        res = tvision.resnet
        net = res.ResNetV1(res.BottleneckV1, *RESNET, classes=10,
                           thumbnail=True)
    else:
        net = TBERT(**BERT_CFG, device="cpu")
    if path is not None:
        net.load_parameters(str(path))
    return net


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    """The three models' weights in ``.params`` files (numpy draws over the
    port's shapes), the inputs, and the JAX package's hybridized blocks
    loaded from the files with their outputs (no eager JAX forward: a
    hybridized first call compiles one program)."""
    import mxnet_tpu as mx
    from mxnet_tpu.gluon.model_zoo.bert import BERTModel

    d = tmp_path_factory.mktemp("hyb")
    rs = onp.random.RandomState(0)
    res = mx.gluon.model_zoo.vision.resnet
    models = {
        "mlp": (lambda: _mlp(mx), (rs.randn(4, 6).astype("float32"),)),
        "resnet": (lambda: res.ResNetV1(res.BottleneckV1, *RESNET,
                                        classes=10, thumbnail=True),
                   (rs.randn(2, 3, 32, 32).astype("float32"),)),
        # token types and valid lengths, one row of length 0
        "bert": (lambda: BERTModel(**BERT_CFG),
                 (rs.randint(0, 100, (3, 16)).astype("int32"),
                  rs.randint(0, 2, (3, 16)).astype("int32"),
                  onp.array([16, 5, 0], "float32"))),
    }
    out = {}
    for seed, (kind, (make, xs)) in enumerate(models.items()):
        with tmx.cpu():
            net = _port(kind)
            with torch.no_grad():   # fills the thumbnail's deferred shapes
                net(*[torch.from_numpy(a) for a in xs])
            net.load_dict(_weights({n: tuple(p.shape) for n, p in
                                    net.collect_params().items()}, seed))
        path = d / f"{kind}.params"
        net.save_parameters(str(path))
        j = make()
        j.load_parameters(str(path))
        j.hybridize()
        got = j(*[_jnd(a) for a in xs])
        want = [_np(o) for o in got] if kind == "bert" else _np(got)
        out[kind] = (j, xs, path, want)
    return out


@pytest.mark.parametrize("kind", ["mlp", "resnet", "bert"])
def test_hybridized_matches_eager_and_jax(twins, kind):
    _, xs, path, want = twins[kind]
    net = _port(kind, path)
    args = [torch.from_numpy(a) for a in xs]
    with torch.no_grad():
        eager = net(*args)
    net.hybridize()
    hyb = net(*args)
    again = net(*args)
    if kind != "bert":
        eager, hyb, again, want = [eager], [hyb], [again], [want]
    assert len(net._cached) == 1
    for e, h, a, w in zip(eager, hyb, again, want):
        assert torch.equal(e, h) and torch.equal(h, a)
        assert _rel(_np(h), w) <= RTOL
    cop = next(iter(net._cached.values()))[0]
    assert cop._captures == 1 and not cop._uses_rng


def test_signature_cache(twins):
    _, xs, path, _ = twins["mlp"]
    net = _port("mlp", path)
    net.hybridize()
    x = torch.from_numpy(xs[0])
    net(x)
    net(x)
    assert len(net._cached) == 1
    net(x[:2])                          # a new shape
    assert len(net._cached) == 2
    with tag.train_mode():              # the training flag
        net(x)
    assert len(net._cached) == 3
    net(x)
    assert len(net._cached) == 3
    with tamp.autocast("bfloat16"):     # the AMP state
        assert net(x).dtype == torch.bfloat16
    assert len(net._cached) == 4
    net.cast("bfloat16")                # new memory, a new dtype: the
    out = net(x.to(torch.bfloat16))     # programs of the old addresses go
    assert out.dtype == torch.bfloat16 and len(net._cached) == 1
    net.hybridize()                     # hybridize again: a clean cache
    assert net._cached == {}


def test_static_arguments_key_the_cache(twins):
    _, xs, path, _ = twins["bert"]
    tok, tt, vl = (torch.from_numpy(a) for a in xs)
    net = _port("bert", path)
    net.hybridize()
    with torch.no_grad(), cached_op.inlined():
        want = net(tok, None, vl)
    got = net(tok, None, vl)           # None: a static argument
    assert torch.equal(got[0], want[0])
    net(tok, tt, vl)
    net(tok)
    assert len(net._cached) == 3


class _Pair(HybridBlock):
    """Takes its data in a tuple and a list, and a static flag."""

    def __init__(self):
        super().__init__()
        self.dense = tnn.Dense(3, in_units=4)

    def forward(self, pair, extra, scale=1.0):
        a, b = pair
        return self.dense(a) * scale + b + extra[0]


def test_tensors_inside_tuples_are_operands():
    """Tensors inside tuples and lists are data operands keyed by shape:
    fresh tuples of the same shapes reuse one entry, whose program reads
    each call's tensors."""
    net = _Pair()
    net.initialize(seed=2)
    net.hybridize()
    rs = onp.random.RandomState(1)
    calls = [[torch.from_numpy(rs.randn(*s).astype("float32"))
              for s in ((2, 4), (2, 3), (3,))] for _ in range(3)]
    outs = [net((a, b), [c]) for a, b, c in calls]
    assert len(net._cached) == 1
    with torch.no_grad(), cached_op.inlined():
        for (a, b, c), out in zip(calls, outs):
            assert torch.equal(out, net((a, b), [c]))
    a, b, c = calls[0]
    net((a[:1], b[:1]), [c])            # a new shape inside the tuple
    net((a, b), [c], scale=2.0)         # a static keyword argument
    assert len(net._cached) == 3
    net((a, b), [c], scale=2.0)
    assert len(net._cached) == 3


def test_load_parameters_after_hybridize(twins, tmp_path):
    _, xs, path, want = twins["mlp"]
    net = _port("mlp")
    net.initialize(seed=3)
    net.hybridize()
    x = torch.from_numpy(xs[0])
    before = net(x)
    net.load_parameters(str(path))      # a copy in place: same addresses
    after = net(x)
    assert len(net._cached) == 1
    assert not torch.equal(before, after)
    assert _rel(_np(after), want) <= RTOL


def test_gradients_under_record_match_eager_and_jax(twins):
    import mxnet_tpu as mx

    jnet, xs, path, _ = twins["mlp"]
    x = torch.from_numpy(xs[0])
    grads = []
    for hybrid in (False, True):
        net = _port("mlp", path)
        if hybrid:
            net.hybridize()
        with tag.record():
            loss = (net(x) ** 2).sum()
        tag.backward(loss)
        grads.append({n: p.grad.clone()
                      for n, p in net.collect_params().items()})
        if hybrid:
            assert net._cached == {}    # recorded calls run eagerly
    xj = _jnd(xs[0])
    with mx.autograd.record():
        jl = (jnet(xj) ** 2).sum()
    jl.backward()
    jgrads = {n: p.grad().asnumpy()
              for n, p in jnet.collect_params().items()}
    for n, g in grads[0].items():
        assert torch.equal(g, grads[1][n]), n
        assert _rel(g.numpy(), jgrads[n]) <= RTOL, n


def test_deferred_shapes_fill_before_the_program():
    net = tnn.HybridSequential()
    net.add(tnn.Dense(5, activation="relu"), tnn.LayerNorm(),
            tnn.Dense(2))
    net.initialize(seed=4)
    net.hybridize()
    x = torch.randn(3, 7)
    out = net(x)
    assert out.shape == (3, 2)
    assert net[0].weight.shape == (5, 7) and net[1].gamma.shape == (5,)
    assert not any(p.is_deferred for p in net.parameters())
    with torch.no_grad(), cached_op.inlined():
        assert torch.equal(out, net(x))


def test_nested_hybrid_blocks_inline():
    inner = tnn.Dense(4, in_units=3)
    outer = tnn.HybridSequential()
    outer.add(inner, tnn.Dense(2, in_units=4))
    outer.initialize(seed=5)
    inner.hybridize()
    outer.hybridize()
    out = outer(torch.randn(2, 3))
    assert out.shape == (2, 2)
    assert len(outer._cached) == 1 and inner._cached == {}


def test_trace_as_the_resnet_inference_bench_uses_it():
    """``bench.py``'s ``bench_resnet_infer`` body with the port's imports,
    at a thumbnail size on the CPU: the port's Parameter is the tensor, so
    the parameter list holds the parameters themselves where the reference
    reads ``p.data()``."""
    from mxnet_tpu_torch.cached_op import trace

    res = tvision.resnet
    net = res.ResNetV1(res.BottleneckV1, *RESNET, classes=10,
                       thumbnail=True)
    net.initialize()
    net.cast("bfloat16")
    x = tmx.np.zeros((2, 3, 32, 32), dtype="bfloat16")
    params = [(name, p) for name, p in net.collect_params().items()]
    _, _, cop = trace(lambda a: net(a), [x], params)
    arrs = [x] + [arr for _, arr in params]
    out = cop(*arrs)
    assert isinstance(out, tmx.nd.NDArray) and out.shape == (2, 10)
    with torch.no_grad():
        want = net(x._data)
    assert torch.equal(out._data, want)
    assert cop.num_inputs == 1 + len(params)
    assert cop._n_main == 1 and cop._captures == 1


def test_trace_outputs_rng_and_errors():
    from mxnet_tpu_torch.cached_op import trace

    x = tmx.np.array([[1.0, 2.0]])
    tree, flat, cop = trace(lambda a: (a * 2, [a + 1]), [x])
    o1, o2 = cop(x)
    assert tree == (tuple, [(1, None), (1, (list, [(1, None)]))])
    assert onp.array_equal(o1.asnumpy(), [[2.0, 4.0]])
    assert onp.array_equal(o2.asnumpy(), [[2.0, 3.0]])
    assert cached_op.unflatten_out([o1, o2], tree)[1][0] is o2

    def noisy(a):
        with tag.train_mode():
            return tmx.npx.dropout(a, p=0.5)

    ones = tmx.np.ones((50, 50))
    _, _, cop = trace(noisy, [ones])
    assert cop._uses_rng
    assert not onp.array_equal(cop(ones).asnumpy(), cop(ones).asnumpy())
    with pytest.raises(MXNetError, match="A10"):
        cop.lower_hlo(ones)
    with pytest.raises(MXNetError, match="A10"):
        trace(noisy, [ones], transform=lambda s: s)
    with pytest.raises(MXNetError, match="expects 1 inputs"):
        cop(ones, ones)
    dense = tnn.Dense(2, in_units=3)
    dense.initialize(seed=1)
    params = list(dense.collect_params().items())
    x3 = tmx.np.ones((1, 3))
    _, _, cop = trace(lambda a: dense(a), [x3], params)
    with pytest.raises(MXNetError, match="not the traced parameter"):
        cop(x3, *[p.detach().clone() for _, p in params])
    cop(x3, *[p for _, p in params])
    dense.cast("bfloat16")              # the traced parameters moved
    xb = x3.astype("bfloat16")
    got = cop(xb, *[p for _, p in params])
    assert cop._captures == 2 and got._data.dtype == torch.bfloat16
    with torch.no_grad():
        assert torch.equal(got._data, dense(xb._data))
    net = _mlp(tmx)
    with pytest.raises(MXNetError, match="A10"):
        net.export("model")
    with pytest.raises(MXNetError, match="A10"):
        net.optimize_for(torch.zeros(1, 6))


class _Noisy(HybridBlock):
    def __init__(self, device):
        super().__init__()
        self.dense = tnn.Dense(64, in_units=32, device=device)

    def forward(self, x):
        return tmx.ops.nn.dropout(self.dense(x), 0.5)


def _dropout_draws(device):
    """A hybridized block with dropout in training mode, no recording:
    fresh masks every call, and ``random.seed`` replays them (on the card
    through the generator registered with the graph)."""
    net = _Noisy(device)
    net.initialize(seed=8)
    net.hybridize()
    x = torch.ones(16, 32, device=device)
    with tag.train_mode():
        net(x)                  # the first call traces and makes the program
        trandom.seed(3)
        a, b = net(x), net(x)
        trandom.seed(3)
        c = net(x)
    cop = next(iter(net._cached.values()))[0]
    assert cop._uses_rng and len(net._cached) == 1
    assert not torch.equal(a, b) and torch.equal(a, c)
    assert float((a == 0).float().mean()) > 0.3
    return cop


def test_dropout_draws_fresh_masks_when_hybridized():
    _dropout_draws("cpu")


def test_cached_op_under_record_goes_through_the_tape():
    from mxnet_tpu_torch.cached_op import trace

    x = tmx.np.array([1.0, 2.0, 3.0])
    _, _, cop = trace(lambda a: (a * a).sum(), [x])
    inp = tmx.np.array([2.0, 3.0, 4.0])
    inp.attach_grad()
    with tag.record():
        y = cop(inp)
    y.backward()
    assert onp.array_equal(inp.grad.asnumpy(), [4.0, 6.0, 8.0])


# -- on the card --------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_captured_matches_eager_on_the_card(cuda):
    torch.manual_seed(0)
    net = TBERT(**BERT_CFG, device=cuda)
    net.initialize(seed=6)
    tok = torch.randint(0, 100, (3, 16), device=cuda, dtype=torch.int32)
    vl = torch.tensor([16.0, 5.0, 0.0], device=cuda)
    with torch.no_grad():
        want = net(tok, None, vl)
    ck.reset_launch_counts()
    net.hybridize()
    got = net(tok, None, vl)
    cop = next(iter(net._cached.values()))[0]
    captured = ck.launch_counts()
    again = net(tok, None, vl)
    torch.cuda.synchronize()
    assert cop._captures == 1 and len(cop._programs) == 1
    prog = next(iter(cop._programs.values()))
    assert prog.captured_launches["flash_fwd"] == 2
    assert prog.captured_launches["layer_norm"] == 5
    assert ck.launch_counts() == captured       # replays move no counter
    assert prog.replays == 2
    for w, g, a in zip(want, got, again):
        assert torch.equal(w, g) and torch.equal(g, a)
    assert float(want[0][2].abs().max()) < float("inf")


@pytest.mark.cuda
def test_nested_and_cast_on_the_card(cuda):
    net = tnn.HybridSequential()
    net.add(tnn.Dense(16, activation="relu", device=cuda),
            tnn.LayerNorm(device=cuda), tnn.Dense(4, device=cuda))
    net.initialize(seed=7)
    x = torch.randn(8, 12, device=cuda)
    with torch.no_grad():
        want = net(x)
    net.hybridize()
    assert torch.equal(net(x), want)
    assert all(child._cached == {} for child in net)
    net.cast("bfloat16")
    xb = x.to(torch.bfloat16)
    with torch.no_grad(), cached_op.inlined():
        want_b = net(xb)
    assert torch.equal(net(xb), want_b) and len(net._cached) == 1


@pytest.mark.cuda
def test_captured_dropout_registers_the_generator(cuda):
    cop = _dropout_draws(cuda)
    assert cop._captures == 1
    assert next(iter(cop._programs.values())).replays == 4
