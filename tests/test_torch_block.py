"""PyTorch/CUDA port: ``gluon.Block``'s reference surface, held to the JAX
package's on the same cases.

Every case runs in both packages (``pkg``) unless it says otherwise:
``initialize(init, ctx=, force_reinit=)``, ``collect_params(select)`` (the
reference's ``test_collect_params_names``, ``tests/test_gluon.py:29``, and
``re.match`` selections), ``save_parameters``/``load_parameters``
(``test_save_load_parameters`` :171) with ``allow_missing``,
``ignore_extra``, ``cast_dtype``, ``dtype_source`` and ``ctx``, files
crossing between the packages, ``save``/``load`` by prefix, forward hooks
and pre-hooks with the reference's signatures, ``summary``'s lines,
``register_child``, ``apply`` (torch's, which has the reference's order and
return value), ``zero_grad`` in place and ``reset_ctx``. Outputs of the
two packages on the same weights agree within 1e-6 of the largest entry
(one fp32 product of three terms); within one package, exactly.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon import Trainer

TOL = 1e-6


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


@pytest.fixture(params=["jax", "port"])
def pkg(request):
    if request.param == "jax":
        import mxnet_tpu

        return mxnet_tpu
    return tmx


def _a(x):
    return onp.asarray(x.asnumpy())


def _mlp(pkg):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(4, in_units=3), pkg.gluon.nn.Dense(2,
                                                                 in_units=4))
    return net


X = onp.random.RandomState(2).rand(2, 3).astype("float32")


def test_collect_params_names(pkg):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(4), pkg.gluon.nn.Dense(2))
    params = net.collect_params()
    assert "0.weight" in params and "1.bias" in params


def test_collect_params_select(pkg):
    net = _mlp(pkg)
    assert list(net.collect_params(".*weight")) == ["0.weight", "1.weight"]
    assert list(net.collect_params("1")) == ["1.weight", "1.bias"]
    assert list(net.collect_params("bias")) == []       # re.match, not search
    assert list(net.collect_params("0.bias|1.weight")) == ["0.bias",
                                                            "1.weight"]


def test_initialize_keeps_initialized_parameters(pkg):
    net = _mlp(pkg)
    net.initialize(pkg.initializer.One())
    net.initialize(pkg.initializer.Zero())
    assert _a(net[0].weight.data()).all()
    net.initialize(pkg.initializer.Zero(), force_reinit=True)
    assert not _a(net[0].weight.data()).any()
    net.initialize(pkg.initializer.One(), ctx=pkg.cpu(), force_reinit=True)
    assert _a(net[1].weight.data()).all()


def test_initialize_ctx_moves_the_same_objects():
    net = _mlp(tmx)
    before = list(net.collect_params().values())
    tr = Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    net.initialize(ctx=tmx.cpu(), seed=1)
    after = list(net.collect_params().values())
    assert all(a is b for a, b in zip(before, after))
    assert all(a is b for a, b in zip(tr._params, after))
    assert all(str(p.list_ctx()[0]) == "cpu(0)" for p in after)
    net.reset_ctx(tmx.cpu())
    assert all(a is b for a, b in zip(net.collect_params().values(), after))


def test_save_load_parameters(pkg, tmp_path):
    net = _mlp(pkg)
    net.initialize()
    f = str(tmp_path / "net.params.npz")
    net.save_parameters(f)
    net2 = _mlp(pkg)
    net2.load_parameters(f)
    x = pkg.np.array(X)
    assert onp.array_equal(_a(net(x)), _a(net2(x)))


def test_parameters_cross_packages(tmp_path):
    import mxnet_tpu as mx

    for src, dst in ((tmx, mx), (mx, tmx)):
        a = _mlp(src)
        a.initialize()
        f = str(tmp_path / f"{src.__name__}.params")
        a.save_parameters(f)
        b = _mlp(dst)
        b.load_parameters(f)
        want, got = _a(a(src.np.array(X))), _a(b(dst.np.array(X)))
        assert abs(got - want).max() <= TOL * abs(want).max()


def test_load_parameters_options(pkg, tmp_path):
    net = _mlp(pkg)
    net.initialize(pkg.initializer.One())
    full = str(tmp_path / "full.params")
    net.save_parameters(full)
    part = str(tmp_path / "part.params")
    onp.savez(open(part, "wb"), **{"0.weight": onp.full((4, 3), 2.0,
                                                       "float32")})
    extra = str(tmp_path / "extra.params")
    with onp.load(full) as z:
        arrays = {n: z[n] for n in z.files}
    onp.savez(open(extra, "wb"), **arrays, stray=onp.zeros(1, "float32"))

    fresh = _mlp(pkg)
    with pytest.raises(pkg.base.MXNetError, match="missing"):
        fresh.load_parameters(part)
    fresh.load_parameters(part, allow_missing=True)
    assert _a(fresh[0].weight.data()).tolist() == [[2.0] * 3] * 4
    with pytest.raises(pkg.base.MXNetError, match="extra"):
        _mlp(pkg).load_parameters(extra)
    fresh.load_parameters(extra, ignore_extra=True, cast_dtype=True,
                          ctx=pkg.cpu())
    assert _a(fresh[0].weight.data()).tolist() == [[1.0] * 3] * 4

    half = _mlp(pkg)
    half.initialize()
    half.cast("float16")
    half.load_parameters(full)                        # dtype_source current
    assert str(half[0].weight.data().dtype) == "float16"
    half.load_parameters(full, dtype_source="saved")
    assert str(half[0].weight.data().dtype) == "float32"
    assert _a(half[1].bias.data()).dtype == onp.float32


def test_save_and_load_by_prefix(pkg, tmp_path):
    net = _mlp(pkg)
    net.initialize()
    prefix = str(tmp_path / "model")
    net.save(prefix)
    assert (tmp_path / "model-model.params.npz").exists()
    net2 = _mlp(pkg)
    net2.load(prefix)
    assert onp.array_equal(_a(net2[1].weight.data()),
                           _a(net[1].weight.data()))


def test_forward_hooks(pkg):
    net = _mlp(pkg)
    net.initialize()
    seen = []
    net.register_forward_pre_hook(
        lambda blk, args: seen.append(("pre", type(blk).__name__,
                                       len(args))))
    net.register_forward_hook(
        lambda blk, args, out: seen.append(("post", type(blk).__name__,
                                            tuple(out.shape))))
    net(pkg.np.array(X))
    assert seen == [("pre", "HybridSequential", 1),
                    ("post", "HybridSequential", (2, 2))]


def test_summary_lines(capsys):
    import mxnet_tpu as mx

    lines = []
    for pkg in (mx, tmx):
        net = _mlp(pkg)
        net.initialize()
        net.summary(pkg.np.array(X))
        lines.append(capsys.readouterr().out)
    assert lines[0] == lines[1]
    assert lines[1].splitlines()[-1] == "  total parameters: 26"


def test_register_child_and_apply(pkg):
    net = pkg.gluon.nn.HybridSequential()
    net.register_child(pkg.gluon.nn.Dense(2, in_units=3))
    net.register_child(pkg.gluon.nn.Dense(1, in_units=2), "head")
    assert list(net.collect_params()) == ["0.weight", "0.bias",
                                          "head.weight", "head.bias"]
    visited = []
    assert net.apply(lambda b: visited.append(type(b).__name__)) is net
    assert visited == ["Dense", "Dense", "HybridSequential"]


def test_zero_grad_in_place():
    net = _mlp(tmx)
    net.initialize(seed=0)
    x = tmx.np.array(X)
    with tmx.autograd.record():
        net(x).sum().backward()
    g = net[0].weight.grad                 # a view of the gradient
    assert g.abs().sum() > 0
    net.zero_grad()
    assert not g.any() and net[0].weight.grad is not None
