"""PyTorch/CUDA port: the dense registered updates of
``mxnet_tpu_torch/ops/optimizer_ops.py`` (the single-tensor updates, the
LAMB phases, ``all_finite``/``multi_all_finite``, the ``mp_*`` forms, the
multi-tensor ``multi_*``/``preloaded_multi_*`` families and their
underscore names) against the JAX package on the CPU.

Each name is a case of one parametrised test, on the inputs of
``tests/torch_extra_cases.py``: every output within 1e-5 of its largest
entry (bitwise for the bool outputs; ``torch_extra_cases.BF16_RTOL``, 2^-6
of the largest entry, for a case with bf16 operands), output dtypes equal
(JAX's promotion: a bf16 weight beside an fp32 tensor hyper or state gives
fp32), and the inputs' gradients within the same bounds where the case
asks for them. Beside them: ``out=`` writes a multi-output update back into
grad-attached arrays, as in the reference, and the optimizer classes whose
formula is the op's run the op's recurrence (bitwise equal). The ``cuda``
test holds the card against the CPU.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
import torch_extra_cases as ec
from mxnet_tpu_torch.ops import optimizer_ops as too
from mxnet_tpu_torch.ops import registry as treg

# the names of the reference's optimizer_ops.py that earlier slices ported
EARLIER = {"sparse_sgd_update", "sparse_adagrad_update", "sparse_adam_update",
           "sparse_ftrl_update", "group_adagrad_update",
           "_sparse_adagrad_update", "_contrib_group_adagrad_update"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def test_names_are_the_references():
    """The table holds exactly the reference's ``optimizer_ops`` names that
    earlier slices left (its own and their aliases), 51, and the port now
    registers every name of the module."""
    from mxnet_tpu.ops import registry as jreg

    names = {n for n, op in jreg._OPS.items()
             if op._make_fn.__module__ == "mxnet_tpu.ops.optimizer_ops"}
    assert set(ec.OPTIM) == names - EARLIER, sorted(set(ec.OPTIM) ^
                                                    (names - EARLIER))
    assert len(ec.OPTIM) == 51 and EARLIER <= names
    assert names <= set(treg.list_ops())
    # the multi-tensor forms keep one Symbol entry, as the reference's
    for name in ec.OPTIM:
        if name.startswith(("multi_", "preloaded_")):
            assert treg.get_op(name).nout == jreg.get_op(name).nout == 1


def test_cases_follow_the_sweep():
    """Where ``tests/test_op_sweep.py`` has a spec, the first case here has
    its attributes and its inputs' shapes and dtypes."""
    import test_op_sweep as sweep

    shared = sorted(set(ec.OPTIM) & set(sweep.SPECS))
    assert len(shared) == 39
    for name in shared:
        build, attrs, _, _ = sweep.SPECS[name]
        mine = ec.cases(name)[0]
        assert mine[1] == attrs, (name, mine[1], attrs)
        want = [onp.asarray(a) for a in build()]
        got = ec.inputs(name, 0)
        assert [a.shape for a in got] == [a.shape for a in want], name
        assert [a.dtype.kind for a in got] == [a.dtype.kind for a in want], \
            name


@pytest.mark.parametrize("name", sorted(ec.OPTIM))
def test_name_matches_reference(name):
    if ec.target(name) != name:
        from mxnet_tpu.ops import registry as jreg

        assert treg.get_op(name) is treg.get_op(ec.target(name))
        assert jreg.get_op(name) is jreg.get_op(ec.target(name))
        ec.check_against_reference(name, first=True)
        return
    ec.check_against_reference(name)


def test_out_writes_a_multi_output_update_back():
    """``mx.nd.multi_mp_lamb_update(..., out=[...])`` rebinds every
    destination to its result, in the port as in the reference, and a
    weight marked for gradients stays marked: the next recorded step gives
    it a gradient."""
    import mxnet_tpu as mx

    rng = onp.random.RandomState(5)
    shapes = ((3, 4), (5,))
    host = [[rng.randn(*s).astype("float32") for _ in range(4)]
            for s in shapes]
    attrs = dict(learning_rates=(0.01, 0.02), wds=(0.01, 0.0),
                 step_count=(1, 1), num_tensors=2)
    results = []
    for mod in (mx, tmx):
        arrs = []
        for w, g, m, v in host:
            wa = mod.nd.array(w)
            wa.attach_grad()
            arrs.append([wa, mod.nd.array(g), mod.nd.array(m),
                         mod.nd.array(abs(v)), mod.nd.array(w)])
        flat = [a for group in arrs for a in group]
        outs = [a for group in arrs for a in (group[0], group[2], group[3],
                                              group[4])]
        got = mod.nd.multi_mp_lamb_update(*flat, out=outs, **attrs)
        assert got is outs
        with mod.autograd.record():
            loss = (arrs[0][0] * arrs[0][0]).sum()
        loss.backward()
        results.append(([a.asnumpy() for a in outs],
                        arrs[0][0].grad.asnumpy()))
    (want, want_g), (got, got_g) = results
    for g, w in zip(got, want):
        ec.lc._close(g, w, 1e-5)
    ec.lc._close(got_g, want_g, 1e-5)
    onp.testing.assert_allclose(got_g, 2 * got[0], rtol=1e-6)


def _twin(opt, op, attrs, states, rng):
    """One update of an ``Optimizer`` and the op on the same fp32 weight,
    gradient and states: (class results, op results)."""
    w = torch.from_numpy(rng.randn(4, 5).astype("float32"))
    g = torch.from_numpy(rng.randn(4, 5).astype("float32"))
    st = {k: torch.from_numpy(abs(rng.randn(4, 5)).astype("float32"))
          for k in states}
    ops = treg.get_op(op).fn(**attrs)(w, g, *[st[k] for k in states])
    wc = w.clone()
    state = {k: v.clone() for k, v in st.items()}
    opt.update(0, wc, g, state)
    return [wc] + [state[k] for k in states], list(ops)


@pytest.mark.parametrize("kind", ["sgd", "nag", "signum", "ftrl", "ftml"])
def test_optimizers_run_the_ops_recurrence(kind):
    """Where an optimizer's formula is the op's (momentum SGD, NAG, Signum,
    FTRL, FTML), the class runs the op's recurrence: one update from the
    same weight, gradient and states is bitwise equal."""
    from mxnet_tpu_torch import optimizer as topt

    rng = onp.random.RandomState(9)
    lr, wd = 0.05, 0.01
    spec = {
        "sgd": (topt.SGD(learning_rate=lr, momentum=0.9, wd=wd),
                "sgd_mom_update", dict(lr=lr, momentum=0.9, wd=wd), ["mom"]),
        "nag": (topt.NAG(learning_rate=lr, momentum=0.9, wd=wd),
                "nag_mom_update", dict(lr=lr, momentum=0.9, wd=wd), ["mom"]),
        "signum": (topt.Signum(learning_rate=lr, momentum=0.9, wd=wd),
                   "signum_update", dict(lr=lr, momentum=0.9, wd=wd),
                   ["mom"]),
        "ftrl": (topt.Ftrl(learning_rate=lr, wd=wd), "ftrl_update",
                 dict(lr=lr, wd=wd), ["z", "n"]),
        "ftml": (topt.FTML(learning_rate=lr, wd=wd), "ftml_update",
                 dict(lr=lr, wd=wd, beta1=0.6, beta2=0.999, t=1),
                 ["d", "s", "z"]),
    }[kind]
    got, want = _twin(spec[0], spec[1], spec[2], spec[3], rng)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w), kind


def test_shared_helpers():
    """``norm`` is the whole tensor's 2-norm; ``trust_ratio`` is 1 where
    either norm is 0."""
    x = torch.tensor([[3.0, 4.0], [0.0, 0.0]])
    assert float(too.norm(x)) == 5.0
    one = torch.tensor(1.0)
    zero = torch.tensor(0.0)
    assert float(too.trust_ratio(torch.tensor(2.0), torch.tensor(4.0))) == 0.5
    assert float(too.trust_ratio(zero, one)) == 1.0
    assert float(too.trust_ratio(one, zero)) == 1.0


@pytest.mark.cuda
def test_names_on_the_card(cuda):
    """Every name on the card against the CPU (1e-5 of the largest entry;
    ``BF16_RTOL`` for a case with bf16 operands; bool outputs bitwise)."""
    failed = {}
    for name in sorted(ec.OPTIM):
        try:
            ec.check_card(name)
        except Exception as e:  # noqa: BLE001 — collected, then reported
            failed[name] = repr(e)[:200]
    assert not failed, failed
