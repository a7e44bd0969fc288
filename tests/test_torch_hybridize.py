"""PyTorch/CUDA port: ``hybridize`` and ``cached_op`` against the eager
port and the JAX package, on the CPU.

A hybridized block is held to the same block run eagerly and to the JAX
package's hybridized block loaded from the same ``.params`` file, for a
Dense MLP, a ResNet v1 thumbnail (``ResNetV1(BottleneckV1, [1, 1, 1, 1],
[8, 16, 32, 64, 128], thumbnail=True)`` in predict mode) and tiny BERT (2
layers, 64 units, 4 heads, hidden 128, vocab 100, max_length 32, dropout
0). Also: the signature cache, ``load_parameters`` after ``hybridize``,
gradients under ``record()`` (one tape node a call: two calls before one
``backward()``, ``grad_req`` ``'add'``/``'null'``, dropout's mask shared by
the node's forward and backward, a program per signature and after a
``cast``, at most ``GraphPool.recorded_limit`` recorded programs a block;
on the card the replayed backward graph and a second call's replay against
the eager block, and the block's graph pools bounded over six signatures),
deferred shapes, nested blocks, dropout's generator, and
``cached_op.trace`` as ``bench.py``'s ResNet inference bench uses it (and
under ``record()``, where it runs on the tape). Tolerances, each with its
reason:

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
            out = net(x)
            loss = (out ** 2).sum()
        tag.backward(loss)
        grads.append({n: p.grad.clone()
                      for n, p in net.collect_params().items()})
        if hybrid:
            # one tape node for the whole recorded call
            assert len(net._cached) == 1
            assert type(out.grad_fn).__name__ == "_TapeBackward"
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


def test_trace_outputs_rng_and_errors(tmp_path):
    from mxnet_tpu_torch.cached_op import trace
    from mxnet_tpu_torch.symbol import topo_sort

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
    # the graph layer: the lowered program's text is its Symbol JSON, and a
    # transform traces through deferred compute into the graph's executor
    assert '"op": "dropout"' in cop.lower_hlo(ones)
    _, _, graph_op = trace(noisy, [ones], transform=lambda s: s)
    assert graph_op._uses_rng and [
        n.op.name for n in topo_sort(graph_op.sym._entries) if n.op] == \
        ["dropout"]
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
    with pytest.raises(MXNetError, match="hybridize"):
        net.export(str(tmp_path / "model"))
    net.optimize_for(torch.zeros(1, 6))     # no backend: hybridize and run
    assert len(net._cached) == 1
    sym_file, _ = net.export(str(tmp_path / "model"))
    assert '"fully_connected"' in open(sym_file).read()


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


# -- a recorded call as one tape node -------------------------------------------
def _grads(net):
    return {n: p.grad.clone() for n, p in net.collect_params().items()
            if p.grad is not None}


def _siamese_loss(out_a, out_b):
    return (out_a ** 2).sum() + (out_a * out_b).sum() + (out_b ** 3).sum()


def test_two_calls_before_one_backward_match_eager_and_jax(twins):
    """A siamese use: the block called twice under one ``record()``, one
    ``backward()``: each call one node, and the gradients the eager
    block's (bitwise) and the reference's (1e-5)."""
    import mxnet_tpu as mx

    jnet, xs, path, _ = twins["mlp"]
    x1 = torch.from_numpy(xs[0])
    x2 = torch.from_numpy(xs[0][::-1].copy())
    grads = []
    for hybrid in (False, True):
        net = _port("mlp", path)
        if hybrid:
            net.hybridize()
        with tag.record():
            a, b = net(x1), net(x2)
            loss = _siamese_loss(a, b)
        tag.backward(loss)
        grads.append(_grads(net))
        if hybrid:
            assert type(a.grad_fn).__name__ == "_TapeBackward"
            assert a.grad_fn is not b.grad_fn
            cop = next(iter(net._cached.values()))[0]
            assert len(cop._recorded) == 1
    with mx.autograd.record():
        jl = _siamese_loss(jnet(_jnd(xs[0])), jnet(_jnd(xs[0][::-1].copy())))
    jl.backward()
    jgrads = {n: p.grad().asnumpy()
              for n, p in jnet.collect_params().items()}
    for n, g in grads[0].items():
        assert torch.equal(g, grads[1][n]), n
        assert _rel(g.numpy(), jgrads[n]) <= RTOL, n


def test_grad_req_add_and_null_keep_their_meaning(twins):
    """``'add'`` sums two backward calls (two micro-batches), ``'null'``
    gives no gradient, as the eager block does."""
    _, xs, path, _ = twins["mlp"]
    batches = [torch.from_numpy(xs[0]), torch.from_numpy(xs[0] * 0.5)]
    grads = []
    for hybrid in (False, True):
        net = _port("mlp", path)
        params = net.collect_params()
        for n, p in params.items():
            p.grad_req = "null" if n == "0.bias" else "add"
        if hybrid:
            net.hybridize()
        for x in batches:
            with tag.record():
                loss = (net(x) ** 2).sum()
            tag.backward(loss)
        assert params["0.bias"].grad is None
        grads.append(_grads(net))
    assert sorted(grads[0]) == sorted(grads[1])
    for n, g in grads[0].items():
        assert torch.equal(g, grads[1][n]), n
    one = _port("mlp", path)
    with tag.record():
        loss = (one(batches[0]) ** 2).sum()
    tag.backward(loss)
    assert not torch.equal(one.collect_params()["1.weight"].grad,
                           grads[1]["1.weight"])


class _DropMLP(HybridBlock):
    def __init__(self, device="cpu"):
        super().__init__()
        self.d1 = tnn.Dense(32, activation="relu", in_units=6, device=device)
        self.d2 = tnn.Dense(3, in_units=32, device=device)

    def forward(self, x):
        return self.d2(tmx.ops.nn.dropout(self.d1(x), 0.5))


def test_dropout_forward_and_backward_share_the_mask():
    """Dropout under ``record()``: the hybridized node's forward and
    backward see the same mask, and the whole step equals the eager
    block's from the same seed (outputs and gradients bitwise)."""
    x = torch.from_numpy(onp.random.RandomState(2).randn(5, 6)
                         .astype("float32"))
    runs = []
    for hybrid in (False, True):
        net = _DropMLP()
        net.initialize(seed=3)
        if hybrid:
            net.hybridize()
        trandom.seed(11)
        outs = []
        for _ in range(2):
            with tag.record():
                out = net(x)
                loss = (out ** 2).sum()
            tag.backward(loss)
            outs.append(out.detach().clone())
        runs.append((outs, _grads(net)))
    (eo, eg), (ho, hg) = runs
    assert not torch.equal(eo[0], eo[1])         # fresh masks each call
    for a, b in zip(eo, ho):
        assert torch.equal(a, b)
    for n, g in eg.items():
        assert torch.equal(g, hg[n]), n


def test_recorded_program_per_signature_and_cast():
    """A new input signature, and a ``cast``, make new recorded programs;
    outside ``record()`` the forward program serves the same block."""
    net = _mlp(tmx)
    net.initialize(seed=1)
    net.hybridize()
    for rows in (4, 4, 3):
        with tag.record():
            loss = (net(torch.randn(rows, 6)) ** 2).sum()
        tag.backward(loss)
    cop = next(iter(net._cached.values()))[0]
    assert len(net._cached) == 2 and len(cop._recorded) == 1
    with torch.no_grad():
        net(torch.randn(4, 6))
    assert len(net._cached) == 3    # predict mode: a signature of its own
    net.cast("bfloat16")
    with tag.record():
        out = net(torch.randn(4, 6, dtype=torch.bfloat16))
    tag.backward((out.float() ** 2).sum())
    assert out.dtype == torch.bfloat16 and len(net._cached) == 1
    assert net[0].weight.grad.dtype == torch.bfloat16


def _trace_under_record(device):
    """A CachedOp that ``trace`` made from a closure (it cannot rebind the
    closure's parameters) runs its body eagerly under ``record()``, on the
    tape: the gradients the plain call's, bitwise, and no recorded
    program."""
    from mxnet_tpu_torch.cached_op import trace

    net = _mlp(tmx, device=device)
    net.initialize(seed=2)
    params = list(net.collect_params().items())
    x = torch.randn(4, 6, device=device)
    _, _, cop = trace(lambda a: net(a), [x], params)
    arrs = [x] + [p for _, p in params]
    grads = []
    for call in (lambda: net(x), lambda: cop(*arrs)):
        for p in net.parameters():
            p.grad = None
        with tag.record():
            loss = (call() ** 2).sum()
        tag.backward(loss)
        grads.append(_grads(net))
    assert cop._recorded == {} and len(grads[1]) == len(params)
    for n, g in grads[0].items():
        assert torch.equal(g, grads[1][n]), n


def test_trace_under_record_runs_on_the_tape():
    _trace_under_record("cpu")


def _bounded_runs(device, shapes, features, width):
    """A hybridized two-layer block and its eager twin trained under
    ``record()`` on inputs of ``shapes`` (each a new signature), one
    backward a call: the gradients of each call bitwise equal, and the
    block's pool bytes after each call (0 off the card)."""
    nets = []
    for hybrid in (False, True):
        net = tnn.HybridSequential()
        net.add(tnn.Dense(width, activation="relu", flatten=False,
                          in_units=features, device=device),
                tnn.Dense(10, flatten=False, in_units=width, device=device))
        net.initialize(seed=3)
        if hybrid:
            net.hybridize()
        nets.append(net)
    sizes = []
    for shape in shapes:
        x = torch.randn(*shape, features, device=device)
        grads = []
        for net in nets:
            for p in net.parameters():
                p.grad = None
            with tag.record():
                loss = (net(x) ** 2).sum()
            tag.backward(loss)
            grads.append(_grads(net))
        for n, g in grads[0].items():
            assert torch.equal(g, grads[1][n]), (shape, n)
        ops = [entry[0] for entry in nets[1]._cached.values()]
        sizes.append(ops[0].pool_bytes() if ops else 0)
    return nets[1], sizes


def test_recorded_programs_are_bounded(monkeypatch):
    """A block keeps at most ``GraphPool.recorded_limit`` recorded
    programs, over all its signatures: the least recently used goes, a
    signature met again is recorded anew, and every call's gradients are
    the eager block's."""
    monkeypatch.setattr(cached_op.GraphPool, "recorded_limit", 2)
    net, _ = _bounded_runs("cpu", [(2,), (3,), (4,), (5,), (2,), (3,)],
                           6, 8)
    live = [k for op, _, _ in net._cached.values() for k in op._recorded]
    gpool = next(iter(net._gpools.values()))
    assert len(live) == 2 and gpool.evicted == 4


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


def _card_runs(cuda, siamese):
    """The same BERT block trained one recorded call at a time (or two
    calls a backward), eager and hybridized, on the card: outputs and
    gradients of three steps."""
    runs = []
    tok = torch.randint(0, 100, (3, 16), device=cuda, dtype=torch.int32)
    tok2 = torch.randint(0, 100, (3, 16), device=cuda, dtype=torch.int32)
    vl = torch.tensor([16.0, 5.0, 9.0], device=cuda)
    for hybrid in (False, True):
        net = TBERT(**BERT_CFG, device=cuda)
        net.initialize(seed=6)
        if hybrid:
            net.hybridize()
        steps = []
        for _ in range(3):
            for p in net.parameters():
                p.grad = None
            with tag.record():
                seq, pooled = net(tok, None, vl)
                loss = (seq ** 2).mean() + pooled.sum()
                if siamese:
                    seq2, _ = net(tok2, None, vl)
                    loss = loss + (seq * seq2).mean()
            tag.backward(loss)
            steps.append((seq.detach().clone(), _grads(net)))
        runs.append((net, steps))
    return runs


@pytest.mark.cuda
def test_replayed_backward_matches_eager_on_the_card(cuda):
    """One forward and one backward capture; the replayed backward's
    gradients bitwise equal to the eager block's; the backward flash
    kernels inside the captured backward."""
    (_, eager), (net, hyb) = _card_runs(cuda, siamese=False)
    cop = next(iter(net._cached.values()))[0]
    prog = next(iter(cop._recorded.values()))
    assert cop._captures == 1 and cop._backward_captures == 1
    assert prog.replays == 2 and prog.backward_replays == 2
    assert prog.backward_launches["flash_bwd_dkv"] == 2
    assert prog.backward_launches["flash_bwd_dq"] == 2
    assert prog.captured_launches["flash_fwd"] == 2
    for (eo, eg), (ho, hg) in zip(eager, hyb):
        assert torch.equal(eo, ho)
        for n, g in eg.items():
            assert torch.equal(g, hg[n]), n


@pytest.mark.cuda
def test_second_call_keeps_the_first_nodes_residuals_on_the_card(cuda):
    """Two calls under one ``record()`` before ``backward()``: the second
    replay does not disturb what the first node's backward reads."""
    (_, eager), (net, hyb) = _card_runs(cuda, siamese=True)
    cop = next(iter(net._cached.values()))[0]
    assert cop._captures == 1 and cop._backward_captures == 1
    for (eo, eg), (ho, hg) in zip(eager, hyb):
        assert torch.equal(eo, ho)
        for n, g in eg.items():
            assert torch.equal(g, hg[n]), n


@pytest.mark.cuda
def test_trace_under_record_on_the_card(cuda):
    _trace_under_record(cuda)


@pytest.mark.cuda
def test_recorded_pool_stays_bounded_on_the_card(cuda, monkeypatch):
    """Six signatures of one size under ``record()`` with a limit of two
    recorded programs: the block's graph pools hold at most a quarter more
    after the sixth than after the second (a dropped program's memory
    serves the next; six kept programs would hold about three times as
    much), and every call's gradients are the eager block's."""
    monkeypatch.setattr(cached_op.GraphPool, "recorded_limit", 2)
    shapes = [(a, 256 // a) for a in (1, 2, 4, 8, 16, 32)]
    net, sizes = _bounded_runs(cuda, shapes, 1024, 2048)
    gpool = next(iter(net._gpools.values()))
    assert gpool.evicted == 4
    assert 0 < sizes[-1] <= 1.25 * sizes[1], sizes
