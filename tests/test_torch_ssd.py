"""PyTorch/CUDA port: SSD (``gluon.model_zoo.vision.ssd``) against the JAX
package on the CPU, following tests/test_ssd_model.py.

``ssd_256_lite(num_classes=2)`` on (2, 3, 32, 32) runs in both packages
from one ``.params`` file (numpy draws at the shapes of the port's first
forward). Held:

- the forward contract and the three outputs: ``cls_preds`` and
  ``box_preds`` within ``RTOL`` (1e-5) of their largest entry, the anchors
  within ``ANCHOR_ATOL`` (2^-22: the reference's XLA program fuses some of
  the anchors' multiply-adds, see tests/test_torch_warp_ops.py);
- ``ssd_target`` and ``ssd_detect`` given identical inputs (the JAX net's
  outputs): masks, class targets and detected classes exactly, the other
  floats within ``RTOL``; the best-anchor rule, hard negative mining's
  budget, and a shared best anchor;
- one training step: the loss of tests/test_ssd_model.py's loop (masked
  NLL plus ``smooth_l1``) and every parameter's gradient, within ``RTOL``
  of the net's largest gradient entry; four SGD steps lower the loss,
  eager and hybridized;
- the save/load round trip, and the JAX package loading the port's file.

The ``cuda`` tests hold the card to the CPU on the same weights.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import np as tnp
from mxnet_tpu_torch import npx as tnpx
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision

RTOL = 1e-5
ANCHOR_ATOL = 2.0 ** -22
CARD_RTOL = 1e-4      # cuDNN against oneDNN, fp32


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


def _batch():
    rs = onp.random.RandomState(0)
    x = rs.rand(2, 3, 32, 32).astype("float32")
    labels = onp.array([[[0, .1, .1, .4, .4], [-1, -1, -1, -1, -1]],
                        [[1, .5, .5, .9, .9], [0, .2, .6, .5, .95]]],
                       "float32")
    return x, labels


def _loss(pkg, net, x, labels, targets=None):
    """tests/test_ssd_model.py's loss: masked NLL over the kept anchors plus
    smooth L1 over the positives' boxes; ``targets`` given (another run's)
    or from ``ssd_target``."""
    np_, npx_ = pkg.np, pkg.npx
    cls_p, box_p, anchors = net(x)
    lt, lm, ct = targets if targets is not None else \
        pkg.gluon.model_zoo.vision.ssd_target(anchors, cls_p, labels)
    keep = ct >= 0
    logp = npx_.log_softmax(cls_p, axis=-1)
    nll = -npx_.pick(logp, np_.maximum(ct, 0), axis=-1) * keep
    box_loss = npx_.smooth_l1((box_p - lt) * lm, scalar=1.0).mean()
    return nll.sum() / keep.sum() + box_loss, (cls_p, box_p, anchors)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX package's SSD: weights, outputs, targets, detections, one
    step's loss and gradients, and four SGD steps' losses."""
    import mxnet_tpu as mx
    from mxnet_tpu.gluon.model_zoo.vision import (ssd_256_lite, ssd_detect,
                                                  ssd_target)

    x, labels = _batch()
    # the weights: drawn at the port's shapes (its first forward) and loaded
    # into the JAX net from a file, which skips the JAX initializers'
    # per-shape compiles
    with tmx.cpu():
        tnet = tvision.ssd_256_lite(num_classes=2)
        tnet.initialize()
        with torch.no_grad():
            tnet(torch.from_numpy(x))
    rs = onp.random.RandomState(5)
    with torch.no_grad():
        for p in tnet.collect_params().values():
            scale = 0.1 if p.dim() == 1 else \
                1.5 / onp.sqrt(onp.prod(tuple(p.shape[1:])))
            p.copy_(torch.from_numpy((scale * rs.randn(*p.shape)).astype(
                "float32")))
    path = str(tmp_path_factory.mktemp("ssd") / "ssd.params")
    tnet.save_parameters(path)
    net = ssd_256_lite(num_classes=2)
    net.load_parameters(path)
    jx, jl = mx.np.array(x), mx.np.array(labels)
    cls_p, box_p, anchors = net(jx)
    out = {"path": path, "x": x, "labels": labels,
           "outs": [a.asnumpy() for a in (cls_p, box_p, anchors)]}
    out["target"] = [a.asnumpy() for a in ssd_target(anchors, cls_p, jl)]
    out["target_all"] = [a.asnumpy() for a in ssd_target(
        anchors, cls_p, jl, negative_mining_ratio=-1.0)]
    out["detect"] = ssd_detect(cls_p, box_p, anchors).asnumpy()
    with mx.autograd.record():
        loss, _ = _loss(mx, net, jx, jl)
    loss.backward()
    out["loss"] = float(loss.asnumpy())
    out["grads"] = {n: p.grad().asnumpy()
                    for n, p in net.collect_params().items()}
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.05})
    net.load_parameters(path)
    losses = []
    for _ in range(4):
        with mx.autograd.record():
            loss, _ = _loss(mx, net, jx, jl)
        loss.backward()
        tr.step(2)
        losses.append(float(loss.asnumpy()))
    out["losses"] = losses
    return out


def _port_net(ref_out):
    net = tvision.ssd_256_lite(num_classes=2)
    net.load_parameters(ref_out["path"])
    return net


def test_forward_contract_and_outputs(ref):
    net = _port_net(ref)
    cls_p, box_p, anchors = net(tnp.array(ref["x"]))
    a = anchors.shape[1]
    assert cls_p.shape == (2, a, 3) and box_p.shape == (2, a * 4)
    assert anchors.shape == (1, a, 4)
    want = ref["outs"]
    assert _rel(cls_p.asnumpy(), want[0]) <= RTOL
    assert _rel(box_p.asnumpy(), want[1]) <= RTOL
    assert abs(anchors.asnumpy() - want[2]).max() <= ANCHOR_ATOL


def test_target_and_detect_on_identical_inputs(ref):
    """The JAX net's outputs through the port's ``ssd_target`` (mining at
    3 and off) and ``ssd_detect``."""
    cls_p, box_p, anchors = (tnp.array(a) for a in ref["outs"])
    labels = tnp.array(ref["labels"])
    for key, ratio in (("target", 3.0), ("target_all", -1.0)):
        got = [a.asnumpy() for a in tvision.ssd_target(
            anchors, cls_p, labels, negative_mining_ratio=ratio)]
        want = ref[key]
        assert _rel(got[0], want[0]) <= RTOL
        onp.testing.assert_array_equal(got[1], want[1])
        onp.testing.assert_array_equal(got[2], want[2])
    got = tvision.ssd_detect(cls_p, box_p, anchors).asnumpy()
    want = ref["detect"]
    onp.testing.assert_array_equal(got[..., 0], want[..., 0])
    assert _rel(got, want) <= RTOL


def test_target_best_anchor_rule_and_mining(ref):
    """tests/test_ssd_model.py:69 and :110: every ground truth's best
    anchor is positive, the box mask is set exactly on the positives, and
    mining keeps at most 3 negatives a positive, the rest ignored (-1)."""
    cls_p, _, anchors = (tnp.array(a) for a in ref["outs"])
    lt, lm, ct = (o.asnumpy() for o in tvision.ssd_target(
        anchors, cls_p, tnp.array(ref["labels"])))
    pos = ct > 0
    assert (pos.sum(1) >= onp.array([1, 2])).all()
    assert ((lm.reshape(2, -1, 4).max(-1) > 0) == pos).all()
    n_pos, n_neg = pos.sum(1), (ct == 0).sum(1)
    assert ((ct == -1).sum(1) > 0).all() and (n_neg <= 3 * n_pos).all()
    _, _, ct_all = tvision.ssd_target(anchors, cls_p,
                                      tnp.array(ref["labels"]),
                                      negative_mining_ratio=-1.0)
    assert (ct_all.asnumpy() >= 0).all()
    anchors = ref["outs"][2][0]
    labels = ref["labels"]
    for b in range(2):
        for row in labels[b]:
            if row[0] < 0:
                continue
            tl = onp.maximum(anchors[:, :2], row[1:3])
            br = onp.minimum(anchors[:, 2:], row[3:5])
            inter = onp.prod(onp.clip(br - tl, 0, None), -1)
            area = onp.prod(anchors[:, 2:] - anchors[:, :2], -1)
            iou = inter / (area + onp.prod(row[3:5] - row[1:3]) - inter)
            assert pos[b, onp.argmax(iou)]


def test_shared_best_anchor_through_ssd_target():
    """Two ground truths whose best anchor is the same SSD anchor: both
    packages keep the later one."""
    import mxnet_tpu as mx
    from mxnet_tpu.gluon.model_zoo.vision import ssd_target as jax_target

    net = tvision.ssd_256_lite(num_classes=3)
    net.initialize()
    cls_p, _, anchors = net(tnp.array(_batch()[0][:1]))
    a = anchors.asnumpy()[0, 5]
    labels = onp.array([[[2] + list(a + [0.01, 0.01, -0.01, -0.01]),
                         [0] + list(a + [0.0, 0.0, 0.0, -0.02])]],
                       "float32")
    got = [o.asnumpy() for o in tvision.ssd_target(
        anchors, cls_p, tnp.array(labels), overlap_threshold=0.99)]
    want = [o.asnumpy() for o in jax_target(
        mx.np.array(anchors.asnumpy()), mx.np.array(cls_p.asnumpy()),
        mx.np.array(labels), overlap_threshold=0.99)]
    onp.testing.assert_array_equal(got[2], want[2])
    assert got[2][0, 5] == 1.0     # class 0 + 1: the second claim


def _train(net, x, labels, steps, hybridize=False):
    if hybridize:
        net.hybridize()
    tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.05})
    losses = []
    for _ in range(steps):
        with tag.record():
            loss, outs = _loss(tmx, net, x, labels)
        loss.backward()
        tr.step(2)
        losses.append(float(loss.asnumpy()))
    return losses, outs


def test_one_step_loss_and_gradients(ref):
    net = _port_net(ref)
    with tag.record():
        loss, _ = _loss(tmx, net, tnp.array(ref["x"]),
                        tnp.array(ref["labels"]))
    loss.backward()
    assert abs(float(loss.asnumpy()) - ref["loss"]) <= RTOL * ref["loss"]
    params = net.collect_params()
    top = max(float(abs(g).max()) for g in ref["grads"].values())
    for n, g in ref["grads"].items():
        gap = float(abs(params[n].grad.numpy() - g).max())
        assert gap <= RTOL * top, (n, gap / top)


@pytest.mark.parametrize("hybridize", [False, True])
def test_trains_and_detects(ref, hybridize):
    """tests/test_ssd_model.py:36: four SGD steps lower the loss; the
    port's losses follow the reference's; detections are scored rows."""
    net = _port_net(ref)
    losses, (cls_p, box_p, anchors) = _train(
        net, tnp.array(ref["x"]), tnp.array(ref["labels"]), 4, hybridize)
    assert losses[-1] < losses[0]
    onp.testing.assert_allclose(losses, ref["losses"], rtol=1e-4)
    o = tvision.ssd_detect(cls_p, box_p, anchors).asnumpy()
    assert o.shape[2] == 6
    kept = o[o[..., 0] >= 0]
    assert len(kept) and (kept[:, 1] >= 0).all() and (kept[:, 1] <= 1).all()


def test_save_load_roundtrip_across_packages(ref, tmp_path):
    import mxnet_tpu as mx
    from mxnet_tpu.gluon.model_zoo.vision import ssd_256_lite as jax_lite

    net = _port_net(ref)
    x = tnp.array(ref["x"])
    want = net(x)[0].asnumpy()
    path = str(tmp_path / "port.params")
    net.save_parameters(path)
    net2 = tvision.ssd_256_lite(num_classes=2)
    net2.load_parameters(path)
    onp.testing.assert_array_equal(net2(x)[0].asnumpy(), want)
    jnet = jax_lite(num_classes=2)
    jnet.load_parameters(path)
    assert _rel(jnet(mx.np.array(ref["x"]))[0].asnumpy(), want) <= RTOL


def test_zoo_entries():
    """tests/test_ssd_model.py:85 on the port's side."""
    assert tvision.get_model("ssd_256_lite", num_classes=3).num_classes == 3
    net = tvision.get_model("ssd_300_mobilenet", num_classes=5)
    net.initialize()
    cls_p, box_p, anchors = net(torch.rand(1, 3, 64, 64))
    assert cls_p.shape[2] == 6 and box_p.shape[1] == anchors.shape[1] * 4
    # at 300 x 300: a 19 x 19 trunk, then 19, 10 and 5: 4 anchors each
    net = tvision.ssd_300_mobilenet(num_classes=20)
    net.initialize()
    with torch.no_grad():
        _, _, anchors = net(torch.rand(1, 3, 300, 300))
    assert anchors.shape[1] == 4 * (19 * 19 + 10 * 10 + 5 * 5) == 1944


# -- on the card -------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = old


@pytest.mark.cuda
@pytest.mark.parametrize("hybridize", [False, True])
def test_ssd_on_card(cuda, hybridize, tmp_path):
    """The same SSD on the card and on the CPU: outputs, one step's loss and
    gradients; targets and detections from the CPU's outputs given to the
    card, integers exactly; four steps lower the loss (hybridized: one
    CUDA graph forward and backward). The card's step takes the CPU's
    targets, and its gradients are held to a float64 twin of the net on
    the CPU (the fp32 CPU run lies within 1e-7 of it), within
    ``CARD_RTOL`` of the twin's largest entry."""
    x, labels = _batch()
    with tmx.cpu():
        net = tvision.ssd_256_lite(num_classes=2)
        net.initialize()
        net(tnp.array(x))
        path = str(tmp_path / "w.params")
        net.save_parameters(path)
        with tag.record():
            loss0, outs0 = _loss(tmx, net, tnp.array(x), tnp.array(labels))
        loss0.backward()
        outs0 = [o.asnumpy() for o in outs0]
        tgt0 = [o.asnumpy() for o in tvision.ssd_target(
            *(tnp.array(outs0[i]) for i in (2, 0)), tnp.array(labels))]
        det0 = tvision.ssd_detect(*(tnp.array(o) for o in outs0)).asnumpy()
        twin = tvision.ssd_256_lite(num_classes=2)
        twin.load_parameters(path)
        with torch.no_grad():
            for p in twin.collect_params().values():
                p.data = p.data.double()
        with tag.record():
            loss64, _ = _loss(tmx, twin, torch.from_numpy(x).double(), None,
                              [torch.from_numpy(t).double() for t in tgt0])
        loss64.backward()
        g64 = {n: p.grad.numpy().copy()
               for n, p in twin.collect_params().items()}
    with tmx.gpu():
        net = tvision.ssd_256_lite(num_classes=2)
        net.load_parameters(path)
        if hybridize:
            net.hybridize()
        with tag.record():
            loss1, outs1 = _loss(tmx, net, tnp.array(x), None,
                                 [tnp.array(t) for t in tgt0])
        loss1.backward()
        top = max(float(abs(g).max()) for g in g64.values())
        for n, p in net.collect_params().items():
            assert float(abs(p.grad.cpu().double().numpy() - g64[n]).max()) \
                <= CARD_RTOL * top, n
        for g, w in zip(outs1, outs0):
            assert _rel(g.asnumpy(), w) <= CARD_RTOL
        assert abs(float(loss1.asnumpy()) - float(loss0.asnumpy())) <= \
            CARD_RTOL * float(loss0.asnumpy())
        tgt1 = [o.asnumpy() for o in tvision.ssd_target(
            *(tnp.array(outs0[i]) for i in (2, 0)), tnp.array(labels))]
        assert _rel(tgt1[0], tgt0[0]) <= RTOL
        onp.testing.assert_array_equal(tgt1[1], tgt0[1])
        onp.testing.assert_array_equal(tgt1[2], tgt0[2])
        det1 = tvision.ssd_detect(*(tnp.array(o) for o in outs0)).asnumpy()
        onp.testing.assert_array_equal(det1[..., 0], det0[..., 0])
        assert _rel(det1, det0) <= RTOL
        losses, _ = _train(net, tnp.array(x), tnp.array(labels), 4)
        assert losses[-1] < losses[0]
