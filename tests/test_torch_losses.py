"""PyTorch/CUDA port: the fourteen losses of ``gluon/loss.py`` and the
``ctc_loss`` op against the JAX package's, with the same numpy inputs.

Checked, each with its tolerance:

- every loss class (and its options: ``weight``, ``sample_weight``,
  ``batch_axis``, ``from_logits``, ``from_sigmoid``, ``sparse_label``,
  ``axis``, ``pos_weight``, ``label_format``, ``compute_full``, the CTC
  layouts and lengths): the loss and the gradient of its first input
  within 1e-5 of each tensor's largest entry (fp32 ``exp``/``log`` may
  round differently by an ulp; CTC's log-space recursion sums in the same
  order), eagerly and hybridized;
- ``ctc_loss`` on an infeasible row (more labels than frames allow): the
  same large finite loss as the reference's (optax's ``log(0) = -1e5``),
  and both blank positions;
- the aliases ``SigmoidBCELoss`` and ``SoftmaxCELoss``, and the reference's
  own cases ``tests/test_loss_metric.py:19-193`` (``test_l1_loss`` to
  ``test_poisson_and_sdml_losses``) on the port.

The JAX package is imported inside the tests that use it, so
``pytest --noconftest tests/test_torch_losses.py -m cuda`` collects this
file on a machine without JAX.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon import loss as tloss

RTOL = 1e-5
N, C = 4, 6


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _rel(got, want):
    got = onp.asarray(got, dtype="float64")
    want = onp.asarray(want, dtype="float64")
    return float(abs(got - want).max() / max(abs(want).max(), 1e-30))


def _rs(seed):
    return onp.random.RandomState(seed)


def _f(a):
    return onp.asarray(a, dtype="float32")


def _ctc_inputs(layout):
    rs = _rs(7)
    T, V = 12, 5
    pred = _f(rs.randn(N, T, V) if layout == "NTC" else rs.randn(T, N, V))
    label = _f([[1, 2, 2, -1], [3, -1, -1, -1], [1, 1, 1, 1], [2, 3, 0, 1]])
    return pred, label


# case -> (loss class name, constructor kwargs, inputs, call kwargs)
def _cases():
    rs = _rs(0)
    pred = _f(rs.randn(N, C))
    target = _f(rs.randn(N, C))
    sw = _f(rs.rand(N, 1))
    binary = _f(rs.randint(0, 2, (N, C)))
    signed = 2 * binary - 1
    prob = _f(1 / (1 + onp.exp(-pred)))
    dist = _f(onp.exp(target) / onp.exp(target).sum(-1, keepdims=True))
    cls = _f(rs.randint(0, C, (N,)))
    ctc_ntc, ctc_label = _ctc_inputs("NTC")
    ctc_tnc, _ = _ctc_inputs("TNC")
    return {
        "l2": ("L2Loss", {}, [pred, target], {}),
        "l2_weighted": ("L2Loss", {"weight": 0.5}, [pred, target],
                        {"sample_weight": sw}),
        "l1": ("L1Loss", {"weight": 2.0}, [pred, target],
               {"sample_weight": sw}),
        "huber": ("HuberLoss", {"rho": 0.5}, [pred, target], {}),
        "sigmoid_bce": ("SigmoidBinaryCrossEntropyLoss", {},
                        [pred, binary], {"sample_weight": sw}),
        "sigmoid_bce_pos_weight": ("SigmoidBCELoss", {}, [pred, binary],
                                   {"pos_weight": _f(onp.full(C, 3.0))}),
        "sigmoid_bce_from_sigmoid": ("SigmoidBCELoss",
                                     {"from_sigmoid": True}, [prob, binary],
                                     {}),
        "softmax_ce_sparse": ("SoftmaxCrossEntropyLoss", {}, [pred, cls],
                              {}),
        "softmax_ce_dense": ("SoftmaxCELoss", {"sparse_label": False},
                             [pred, dist], {}),
        "softmax_ce_axis0": ("SoftmaxCELoss", {"axis": 0, "batch_axis": 1},
                             [pred, _f(rs.randint(0, N, (C,)))], {}),
        "kl_div_logits": ("KLDivLoss", {"from_logits": False}, [pred, dist],
                          {}),
        "kl_div_logp": ("KLDivLoss", {}, [_f(onp.log(dist + 0.1)), dist],
                        {}),
        "ctc_ntc": ("CTCLoss", {}, [ctc_ntc, ctc_label], {}),
        "ctc_lengths": ("CTCLoss", {}, [ctc_ntc, ctc_label],
                        {"pred_lengths": _f([12, 9, 10, 12]),
                         "label_lengths": _f([3, 1, 4, 2])}),
        "ctc_tnc": ("CTCLoss", {"layout": "TNC", "weight": 0.5},
                    [ctc_tnc, ctc_label], {}),
        "hinge": ("HingeLoss", {"margin": 0.8}, [pred, signed], {}),
        "squared_hinge": ("SquaredHingeLoss", {}, [pred, signed], {}),
        "logistic_signed": ("LogisticLoss", {}, [pred, signed], {}),
        "logistic_binary": ("LogisticLoss", {"label_format": "binary"},
                            [pred, binary], {}),
        "triplet": ("TripletLoss", {"margin": 0.5},
                    [pred, target, _f(rs.randn(N, C))], {}),
        "cosine": ("CosineEmbeddingLoss", {"margin": 0.1},
                   [pred, target, _f([1, -1, 1, -1])], {}),
        "poisson_logits": ("PoissonNLLLoss", {}, [pred, _f(abs(target))],
                           {}),
        "poisson_full": ("PoissonNLLLoss", {"from_logits": False,
                                            "compute_full": True},
                         [_f(abs(pred) + 0.1), _f(3 * abs(target))], {}),
        "sdml": ("SDMLLoss", {"smoothing_parameter": 0.2},
                 [pred, target], {}),
    }


CASES = _cases()


def _run(pkg, case, hybridize):
    cls, kw, inputs, call = CASES[case]
    loss = getattr(pkg.gluon.loss, cls)(**kw)
    if hybridize:
        loss.hybridize()
    arrs = [pkg.np.array(a) for a in inputs]
    arrs[0].attach_grad()
    extra = {k: pkg.np.array(v) for k, v in call.items()}
    with pkg.autograd.record():
        out = loss(*arrs, **extra)
        out.sum().backward()
    return out.asnumpy(), arrs[0].grad.asnumpy()


def test_the_reference_losses_all_exist():
    import mxnet_tpu as mx

    assert sorted(tloss.__all__) == sorted(mx.gluon.loss.__all__)
    assert tloss.SigmoidBCELoss is tloss.SigmoidBinaryCrossEntropyLoss
    assert tloss.SoftmaxCELoss is tloss.SoftmaxCrossEntropyLoss
    assert len({getattr(tloss, n) for n in tloss.__all__} -
               {tloss.Loss}) == 14


@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_losses_match_the_reference(case, hybridize):
    import mxnet_tpu as mx

    want = _run(mx, case, hybridize)
    got = _run(tmx, case, hybridize)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g, w) <= RTOL


@pytest.mark.parametrize("blank", ["first", "last"])
def test_ctc_infeasible_row_is_large_and_finite(blank):
    """Row 1 needs 7 frames (1, blank, 1, blank, 1, blank, 1) and gets 3:
    the reference's optax recursion gives ~1e5, not inf."""
    import mxnet_tpu as mx

    pred, _ = _ctc_inputs("TNC")
    label = _f([[1, 2, 0, 0], [1, 1, 1, 1]]) if blank == "first" else \
        _f([[1, 2, -1, -1], [1, 1, 1, 1]])
    dl = _f([12, 3])
    args = [pred[:, :2], label, dl]
    want = mx.npx.ctc_loss(*[mx.np.array(a) for a in args],
                           blank_label=blank).asnumpy()
    got = tmx.npx.ctc_loss(*[tmx.np.array(a) for a in args],
                           blank_label=blank).asnumpy()
    assert onp.isfinite(got).all() and got[1] > 1e4 > got[0]
    assert _rel(got, want) <= RTOL


# -- the reference's own cases (tests/test_loss_metric.py) --------------------------
np = tmx.np


def test_l1_loss():
    out = tloss.L1Loss()(np.array([[1.0, -2.0]]), np.array([[0.0, 0.0]]))
    onp.testing.assert_allclose(out.asnumpy(), [1.5])


def test_softmax_ce_sparse():
    pred = np.array([[5.0, 0.0, 0.0], [0.0, 5.0, 0.0]])
    out = tloss.SoftmaxCrossEntropyLoss()(pred, np.array([0, 1]))
    p = onp.exp(5.0) / (onp.exp(5.0) + 2)
    onp.testing.assert_allclose(out.asnumpy(), [-onp.log(p)] * 2,
                                rtol=1e-4, atol=1e-5)


def test_softmax_ce_dense():
    pred = np.array([[1.0, 2.0, 3.0]])
    label = np.array([[0.0, 0.0, 1.0]])
    out = tloss.SoftmaxCrossEntropyLoss(sparse_label=False)(pred, label)
    logp = pred.asnumpy() - onp.log(onp.exp(pred.asnumpy()).sum())
    onp.testing.assert_allclose(out.asnumpy(), [-logp[0, 2]], rtol=1e-4,
                                atol=1e-5)


def test_sigmoid_bce():
    pred = np.array([[0.0, 2.0]])
    label = np.array([[0.0, 1.0]])
    out = tloss.SigmoidBCELoss()(pred, label)
    x, z = pred.asnumpy(), label.asnumpy()
    ref = (onp.maximum(x, 0) - x * z + onp.log1p(onp.exp(-onp.abs(x)))) \
        .mean(axis=1)
    onp.testing.assert_allclose(out.asnumpy(), ref, rtol=1e-4, atol=1e-5)


def test_kl_hinge_huber():
    pred = np.array([[0.1, -0.5]])
    label = np.array([[1.0, -1.0]])
    for cls in (tloss.HingeLoss, tloss.SquaredHingeLoss, tloss.HuberLoss,
                tloss.LogisticLoss):
        assert cls()(pred, label).shape == (1,)


def test_ctc_loss_shape():
    pred = tmx.np.random.uniform(size=(2, 10, 5))
    label = np.array([[1, 2, 0, 0], [2, 3, 4, 0]])
    out = tloss.CTCLoss()(pred, label, pred_lengths=np.array([10, 10]),
                          label_lengths=np.array([2, 3]))
    assert out.shape == (2,)
    assert (out.asnumpy() > 0).all()


def test_triplet_cosine():
    a, p, n = (tmx.np.random.uniform(size=(2, 4)) for _ in range(3))
    assert tloss.TripletLoss()(a, p, n).shape == (2,)
    assert tloss.CosineEmbeddingLoss()(a, p, np.array([1, -1])).shape == (2,)


def test_poisson_and_sdml_losses():
    pl = tloss.PoissonNLLLoss(from_logits=True)
    pred = onp.array([[0.0, 1.0]], "float32")
    tgt = onp.array([[1.0, 2.0]], "float32")
    want = (onp.exp(pred) - tgt * pred).mean()
    assert abs(float(pl(np.array(pred), np.array(tgt)).asnumpy()) -
               want) < 1e-5
    pf = tloss.PoissonNLLLoss(from_logits=False, compute_full=True)
    got2 = float(pf(np.array([[2.0, 2.0]]), np.array([[0.5, 3.0]]))
                 .asnumpy())
    base = (2.0 - 0.5 * onp.log(2.0 + 1e-8) +
            2.0 - 3.0 * onp.log(2.0 + 1e-8)) / 2
    stir = (3.0 * onp.log(3.0 + 1e-8) - 3.0 +
            0.5 * onp.log(2 * (3.0 + 1e-8) * onp.pi)) / 2
    assert abs(got2 - (base + stir)) < 1e-4
    sd = tloss.SDMLLoss(smoothing_parameter=0.1)
    x = onp.random.RandomState(5).randn(6, 8).astype("float32")
    aligned = float(sd(np.array(x), np.array(x)).asnumpy().mean())
    shuffled = float(sd(np.array(x), np.array(onp.roll(x, 1, axis=0)))
                     .asnumpy().mean())
    assert aligned < shuffled


# -- on the card ---------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_losses_on_card_match_the_cpu(cuda, case):
    """The loss and its first input's gradient on the card against the
    CPU, within 1e-5 of each tensor's largest entry (fp32)."""
    cls, kw, inputs, call = CASES[case]
    outs = []
    for dev in ("cpu", cuda):
        loss = getattr(tloss, cls)(**kw)
        ts = [torch.tensor(a, device=dev) for a in inputs]
        ts[0].requires_grad_(True)
        out = loss(*ts, **{k: torch.tensor(v, device=dev)
                           for k, v in call.items()})
        out.sum().backward()
        outs.append((out.detach().cpu(), ts[0].grad.cpu()))
    for a, b in zip(*outs):
        assert _rel(b, a) <= RTOL
