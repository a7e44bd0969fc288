"""PyTorch/CUDA port: the reference's nineteen optimizers, ``Updater``, the
fused ``Trainer`` update and the compiled step over each, against the JAX
package on the CPU.

Checked, each with its tolerance:

- ``update`` of every optimizer but SGLD against the reference's on the
  same numpy weights and gradients (a (5, 4) and a (7,) tensor, 3 steps,
  ``wd`` 0.01 where allowed, ``rescale_grad`` 0.5 and ``clip_gradient``
  0.8): weights and states within 1e-5 of each tensor's largest entry
  (the port computes ``1 - beta ** t`` in double, the reference in float32:
  measured at most 3.5e-6, FTML's ``d``);
- SGLD by its noise: with a zero gradient a step moves the weight by
  N(0, lr), mean and variance held over 2^16 values (4 sigma), in both
  packages;
- the reference's ``test_optimizer_minimizes_quadratic`` for its eighteen:
  the port's first 20 iterates within 1e-5 of the reference's (SGLD left
  out: its noise), and its 500-step result within the reference's bound
  (for SGLD and LANS the mean of the last 50 iterates);
- the fused ``Trainer`` update against the per-parameter loop (a tensor
  over 4096 values beside small ones that the elementwise recurrences
  flatten), fp32 and, for the elementwise recurrences, bf16 weights under
  ``multi_precision``: weights and states within 1e-6 of each tensor's
  largest (the loop's Python-number hypers round once more than the fused
  float32 ones in ``lr / (1 - beta ** t)``); the non-elementwise ones
  (LAMB, LARS, LANS, GroupAdaGrad, NAG) never flattened;
- ``compile_step`` of each fusable optimizer against the eager loop on a
  small MLP, fp32 and bf16 under ``multi_precision``, the rate halved
  before the third step: rtol 1e-6 (one body of torch ops in another order
  of calls); SGLD takes the reference's eager fallback, every other one
  builds one program;
- the reference's ``test_updater_roundtrip`` and ``test_group_adagrad``,
  and ``Updater`` states crossing between the packages.

The JAX package is imported inside the tests that use it, so
``pytest --noconftest tests/test_torch_optimizers.py -m cuda`` collects
this file on a machine without JAX.
"""
import math

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.gluon import Parameter, Trainer
from mxnet_tpu_torch.gluon import loss as tloss

NAMES = sorted(topt.optimizer._registry)
DETERMINISTIC = [n for n in NAMES if n != "sgld"]
ELEMENTWISE = [n for n in DETERMINISTIC
               if topt.create(n, learning_rate=0.01).fused_step[3]]
WHOLE_TENSOR = ("groupadagrad", "lamb", "lans", "lars", "nag")
RTOL = 1e-5
FUSED_RTOL = 1e-6
SHAPES = [(5, 4), (7,)]


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _kw(name, **extra):
    kw = dict(learning_rate=0.01)
    if name != "groupadagrad":      # the reference rejects its wd
        kw["wd"] = 0.01
    kw.update(extra)
    return kw


def _rel(got, want):
    got = onp.asarray(got, dtype="float64")
    want = onp.asarray(want, dtype="float64")
    return float(abs(got - want).max() / max(abs(want).max(), 1e-30))


def test_every_reference_name_is_registered():
    assert NAMES == sorted(
        ["adabelief", "adadelta", "adagrad", "adam", "adamax", "adamw",
         "dcasgd", "ftml", "ftrl", "groupadagrad", "lamb", "lans", "lars",
         "nadam", "nag", "rmsprop", "sgd", "sgld", "signum"])
    assert set(WHOLE_TENSOR) == set(DETERMINISTIC) - set(ELEMENTWISE)
    assert topt.create("sgld").fused_step is None
    with pytest.raises(MXNetError, match="not registered"):
        topt.create("nope")


@pytest.mark.parametrize("name", DETERMINISTIC)
def test_update_matches_the_reference(name):
    import mxnet_tpu as mx
    from mxnet_tpu.ndarray.ndarray import NDArray

    kw = _kw(name, rescale_grad=0.5, clip_gradient=0.8)
    jo, to = mx.optimizer.create(name, **kw), topt.create(name, **kw)
    rs = onp.random.RandomState(1)
    ws = [rs.randn(*s).astype("float32") for s in SHAPES]
    jw = [NDArray(w.copy()) for w in ws]
    tw = [torch.tensor(w) for w in ws]
    js = [jo.create_state(i, w) for i, w in enumerate(jw)]
    ts = [to.create_state(i, w) for i, w in enumerate(tw)]
    for _ in range(3):
        for i, s in enumerate(SHAPES):
            g = rs.randn(*s).astype("float32")
            jo.update(i, jw[i], NDArray(g), js[i])
            to.update(i, tw[i], torch.tensor(g), ts[i])
    for i in range(len(SHAPES)):
        assert _rel(tw[i].numpy(), jw[i].asnumpy()) <= RTOL, i
        assert set(ts[i]) == set(js[i])
        for k in js[i]:
            assert tuple(ts[i][k].shape) == tuple(js[i][k].shape), k
            assert _rel(ts[i][k].numpy(), js[i][k].asnumpy()) <= RTOL, k
    assert to.num_update == jo.num_update == 3


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_sgld_noise_is_normal_with_variance_lr(pkg):
    lr, n = 0.04, 1 << 16
    if pkg == "jax":
        import mxnet_tpu as mx
        from mxnet_tpu.ndarray.ndarray import NDArray

        mx.random.seed(3)
        o = mx.optimizer.SGLD(learning_rate=lr)
        w = NDArray(onp.zeros(n, "float32"))
        o.update(0, w, NDArray(onp.zeros(n, "float32")), {})
        moved = w.asnumpy()
    else:
        tmx.random.seed(3)
        o = topt.SGLD(learning_rate=lr)
        w = torch.zeros(n)
        o.update(0, w, torch.zeros(n), {})
        moved = w.numpy()
    assert abs(moved.mean()) < 4 * math.sqrt(lr / n)
    # the sample variance's standard error is sqrt(2 / n) of lr
    assert abs(moved.var() / lr - 1) < 4 * math.sqrt(2 / n)


def _quadratic_kwargs(name):
    """The reference test's rates (tests/test_optimizer.py:63)."""
    kw = {"learning_rate": 0.05}
    if name in ("adam", "adamw", "adamax", "nadam", "adabelief", "ftml",
                "lans"):
        kw["learning_rate"] = 0.1
    if name in ("adagrad", "ftrl"):
        kw["learning_rate"] = 0.5
    if name == "adadelta":
        kw["learning_rate"] = 1.0
    if name == "lars":
        kw["learning_rate"] = 10.0
    if name == "lamb":
        kw["learning_rate"] = 0.02
    if name == "sgld":
        kw["learning_rate"] = 0.001
    return kw


def _quadratic_run(opt, w, grad_of, steps, wrap):
    state = opt.create_state(0, w)
    out = []
    for _ in range(steps):
        opt.update(0, w, wrap(grad_of(w)), state)
        out.append(onp.array(w.asnumpy() if hasattr(w, "asnumpy")
                             else w.numpy()))
    return out


@pytest.mark.parametrize("name", [n for n in NAMES if n != "groupadagrad"])
def test_optimizer_minimizes_quadratic(name):
    """The reference's case over its eighteen optimizers (GroupAdaGrad is
    ``test_group_adagrad``'s): 500 steps on (w - target)^2 from 0.5; its final
    error bound (0.35, SGLD's posterior mean 0.8 at a sharpened
    curvature). The port's first 20 iterates are held to the
    reference's."""
    import mxnet_tpu as mx
    from mxnet_tpu.ndarray.ndarray import NDArray

    kw = _quadratic_kwargs(name)
    gscale = 100.0 if name == "sgld" else 1.0
    target = onp.array([1.0, -2.0, 3.0], "float32")

    def grad_of(w):
        host = w.asnumpy() if hasattr(w, "asnumpy") else w.numpy()
        return (gscale * 2 * (host - target)).astype("float32")

    if name != "sgld":
        want = _quadratic_run(mx.optimizer.create(name, **kw),
                              NDArray(onp.full(3, 0.5, "float32")), grad_of,
                              20, NDArray)
        got = _quadratic_run(topt.create(name, **kw),
                             torch.full((3,), 0.5), grad_of, 20,
                             torch.from_numpy)
        for j, (g, w) in enumerate(zip(got, want)):
            assert _rel(g, w) <= RTOL, (j, g, w)
    tmx.random.seed(42)
    tail = _quadratic_run(topt.create(name, **kw), torch.full((3,), 0.5),
                          grad_of, 500, torch.from_numpy)[450:]
    # SGLD samples a posterior; LANS, like LAMB in the reference's note,
    # oscillates about the optimum at ~lr |w| (its trajectory parts from
    # the reference's after ~50 steps on float rounding; both packages'
    # last 50 iterates reach 0.65 off, their means 0.05-0.06): the mean
    # of the late iterates is judged for both
    final = onp.mean(tail, axis=0) if name in ("sgld", "lans") \
        else tail[-1]
    err = onp.abs(final - target).max()
    assert err < (0.8 if name == "sgld" else 0.35), f"{name}: {err}"


# -- the fused Trainer update --------------------------------------------------
TRAINER_SHAPES = [(80, 64), (64,), (3, 64), (3,)]   # 5120 values: alone


def _trainer(name, dtype, fuse, seed=3, mp=False, device="cpu"):
    rs = onp.random.RandomState(seed)
    params = [Parameter(torch.tensor(rs.randn(*s).astype("float32"))
                        .to(device=device, dtype=dtype))
              for s in TRAINER_SHAPES]
    tr = Trainer(params, name, _kw(name, multi_precision=mp))
    tr._fuse = fuse
    return tr, params


def _grads(step, dtype, device="cpu"):
    rs = onp.random.RandomState(100 + step)
    return [torch.tensor(rs.randn(*s).astype("float32")).to(device=device,
                                                             dtype=dtype)
            for s in TRAINER_SHAPES]


def _train(tr, params, steps, dtype, device="cpu", lr_change=True):
    for step in range(steps):
        if lr_change and step == 2:
            tr.set_learning_rate(tr.learning_rate * 0.5)
        for p, g in zip(params, _grads(step, dtype, device)):
            p.grad = g
        tr.update(2)


_FUSED_CASES = [(n, False) for n in DETERMINISTIC] + \
    [(n, True) for n in ELEMENTWISE]


@pytest.mark.parametrize("name,mp", _FUSED_CASES)
def test_fused_trainer_matches_per_param(name, mp):
    dtype = torch.bfloat16 if mp else torch.float32
    tf, pf = _trainer(name, dtype, True, mp=mp)
    tp, pp = _trainer(name, dtype, False, mp=mp)
    _train(tf, pf, 4, dtype)
    _train(tp, pp, 4, dtype)
    assert tf._fused_dispatches == 4 and tp._fused_dispatches == 0
    layout = next(iter(tf._fused_fn.values()))
    if name in WHOLE_TENSOR:
        assert layout.small == [] and layout.calls == len(TRAINER_SHAPES)
    else:
        assert layout.calls == 2    # the big tensor, the three small ones
    for a, b in zip(pf, pp):
        assert a.dtype == dtype
        assert _rel(a.detach().float(), b.detach().float()) <= FUSED_RTOL
    for sa, sb in zip(tf._states, tp._states):
        assert set(sa) == set(sb) == (set(sb) | ({"weight_fp32"} if mp
                                                 else set()))
        for k in sa:
            assert _rel(sa[k].float(), sb[k].float()) <= FUSED_RTOL, k


# -- compile_step ----------------------------------------------------------------
def _mlp(dtype, seed=5):
    net = tmx.gluon.nn.HybridSequential()
    net.add(tmx.gluon.nn.Dense(64, activation="relu", in_units=80),
            tmx.gluon.nn.Dense(3, in_units=64))
    rs = onp.random.RandomState(seed)
    net.load_dict({n: (rs.randn(*p.shape) / 8).astype("float32")
                   for n, p in net.collect_params().items()})
    if dtype != torch.float32:
        net.cast(tmx.base.dtype_name(dtype))
    return net


def _mlp_batches(dtype, n=3):
    rs = onp.random.RandomState(9)
    return [(torch.tensor(rs.randn(6, 80).astype("float32")).to(dtype),
             torch.tensor(rs.randint(0, 3, (6,)).astype("float32")))
            for _ in range(n)]


@pytest.mark.parametrize("name,mp", _FUSED_CASES)
def test_compile_step_matches_the_eager_loop(name, mp):
    dtype = torch.bfloat16 if mp else torch.float32
    loss_fn = tloss.SoftmaxCrossEntropyLoss()
    a, b = _mlp(dtype), _mlp(dtype)
    ta = Trainer(a.collect_params(), name, _kw(name, multi_precision=mp))
    tb = Trainer(b.collect_params(), name, _kw(name, multi_precision=mp))
    step = ta.compile_step(a, loss_fn)
    assert step.fallback_reason is None
    for j, (x, y) in enumerate(_mlp_batches(dtype)):
        if j == 2:      # a new rate is an operand: no new program
            for tr in (ta, tb):
                tr.set_learning_rate(tr.learning_rate * 0.5)
        got = step(x, y)
        with tag.record():
            want = loss_fn(b(x), y).mean()
        tag.backward(want)
        tb.step(1)
        assert _rel(got.float(), want.detach().float()) <= FUSED_RTOL
    assert step._traces == 1
    for (n, p), q in zip(a.collect_params().items(),
                         b.collect_params().values()):
        assert p.dtype == dtype
        assert _rel(p.detach().float(), q.detach().float()) <= FUSED_RTOL, n
    if mp:
        assert all("weight_fp32" in st for st in ta._states)


def test_sgld_compile_step_takes_the_reference_fallback():
    net = _mlp(torch.float32)
    tr = Trainer(net.collect_params(), "sgld", {"learning_rate": 0.01})
    step = tr.compile_step(net, tloss.SoftmaxCrossEntropyLoss())
    assert "SGLD declares no fusable" in step.fallback_reason
    x, y = _mlp_batches(torch.float32, 1)[0]
    with pytest.warns(RuntimeWarning, match="falling back"):
        assert math.isfinite(float(step(x, y)))
    assert step._traces == 0


# -- Updater ---------------------------------------------------------------------
def test_updater_roundtrip():
    """The reference's case (tests/test_optimizer.py:130)."""
    upd = topt.get_updater(topt.Adam())
    w = torch.tensor([1.0])
    upd(0, torch.tensor([0.1]), w)
    blob = upd.get_states()
    upd2 = topt.get_updater(topt.Adam())
    upd2.set_states(blob)
    assert 0 in upd2.states
    assert float(w) != 1.0


def test_updater_states_cross_the_packages():
    """The port's states load into the reference's Updater and back; a step
    after each load agrees with the other package's (rtol 1e-5)."""
    import mxnet_tpu as mx
    from mxnet_tpu.ndarray.ndarray import NDArray

    rs = onp.random.RandomState(2)
    w0 = rs.randn(4, 3).astype("float32")
    g = [rs.randn(4, 3).astype("float32") for _ in range(3)]
    tu = topt.get_updater(topt.create("lamb", learning_rate=0.1, wd=0.01))
    ju = mx.optimizer.get_updater(mx.optimizer.create("lamb",
                                                      learning_rate=0.1,
                                                      wd=0.01))
    tw, jw = tmx.np.array(w0.copy()), NDArray(w0.copy())
    tu(0, tmx.np.array(g[0]), tw)
    ju.set_states(tu.get_states())
    ju.optimizer._index_update_count = {0: 1}
    jw = NDArray(tw.asnumpy())
    ju(0, NDArray(g[1]), jw)
    tu(0, tmx.np.array(g[1]), tw)
    assert _rel(tw.asnumpy(), jw.asnumpy()) <= RTOL
    tu.set_states(ju.get_states(dump_optimizer=False))
    for k, v in ju.states[0].items():
        assert _rel(tu.states[0][k], v.asnumpy()) == 0.0, k
    tu(0, tmx.np.array(g[2]), tw)
    ju(0, NDArray(g[2]), jw)
    assert _rel(tw.asnumpy(), jw.asnumpy()) <= RTOL


def test_group_adagrad():
    """The reference's case (tests/test_optimizer.py:354), dense part:
    per-row history, the recurrence's exact values, wd rejected, a Trainer
    driving it."""
    opt = topt.create("groupadagrad", learning_rate=0.1)
    w = torch.ones(3, 4)
    g = torch.arange(12, dtype=torch.float32).reshape(3, 4) / 10
    state = opt.create_state(0, w)
    assert tuple(state["history"].shape) == (3, 1)
    w_before = w.clone()
    opt.update(0, w, g, state)
    hist = (g ** 2).mean(dim=1, keepdim=True)
    want = w_before - 0.1 * g / (hist.sqrt() + 1e-6)
    onp.testing.assert_allclose(w.numpy(), want.numpy(), rtol=1e-5,
                                atol=1e-6)
    with pytest.raises(ValueError):
        topt.create("groupadagrad", learning_rate=0.1, wd=0.01)
    net = tmx.gluon.nn.Dense(2, in_units=3)
    net.initialize()
    tr = Trainer(net.collect_params(), "groupadagrad",
                 {"learning_rate": 0.05})
    before = net.weight.detach().clone()
    x = torch.randn(4, 3)
    with tag.record():
        loss = (net(x) ** 2).sum()
    tag.backward(loss)
    tr.step(4)
    assert not torch.equal(before, net.weight.detach())
    assert tuple(tr._states[0]["history"].shape) == (2, 1)


def test_trainer_state_file_holds_group_adagrad_history(tmp_path):
    """A state whose shape is not the weight's ((rows, 1) history) saves
    and loads through ``Trainer.save_states``/``load_states``."""
    tr, params = _trainer("groupadagrad", torch.float32, True)
    _train(tr, params, 2, torch.float32)
    path = str(tmp_path / "states")
    tr.save_states(path)
    tr2, _ = _trainer("groupadagrad", torch.float32, True)
    tr2.load_states(path)
    for a, b in zip(tr._states, tr2._states):
        for k in a:
            assert torch.equal(a[k], b[k]), k


# -- on the card -----------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


CARD_RTOL = 1e-5      # card against CPU, fp32 elementwise and norms


@pytest.mark.cuda
@pytest.mark.parametrize("name,mp", [("lamb", False), ("lans", False),
                                     ("groupadagrad", False),
                                     ("adam", True), ("dcasgd", True)])
def test_fused_trainer_and_compiled_step_on_card(cuda, name, mp):
    """The fused update on the card against the per-parameter loop on the
    CPU from the same gradients, and the compiled step captured once."""
    dtype = torch.bfloat16 if mp else torch.float32
    tc, pc = _trainer(name, dtype, True, mp=mp, device=cuda)
    th, ph = _trainer(name, dtype, False, mp=mp)
    _train(tc, pc, 3, dtype, device=cuda)
    _train(th, ph, 3, dtype)
    for a, b in zip(pc, ph):
        tol = CARD_RTOL if not mp else 2 ** -7   # one bf16 rounding
        assert _rel(a.detach().float().cpu(), b.detach().float()) <= tol
    with tmx.gpu():
        net = _mlp(dtype).to(cuda)
        tr = Trainer(net.collect_params(), name, _kw(name,
                                                     multi_precision=mp))
        step = tr.compile_step(net, tloss.SoftmaxCrossEntropyLoss())
        losses = [float(step(x.to(cuda), y.to(cuda)))
                  for x, y in _mlp_batches(dtype, 4)]
    assert step._traces == 1 and all(map(math.isfinite, losses))
