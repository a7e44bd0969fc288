"""PyTorch/CUDA port: ``serve.Predictor`` on the CPU, held to the
reference's Predictor tests (``tests/test_serve.py``: the bucket ladder,
``predict`` at every size, input validation, dynamic batching, close,
no program made after warmup, the warmup manifest) and its three chaos
tests (``tests/test_chaos.py``: a transient dispatch failure retried, an
exhausted one failing only its batch, a dispatcher crash failing
everything), and to the JAX package's Predictor on the same rows and
weights. Also: the predictor serves the copy of the weights it took at
construction, and a multi-input tiny BERT predictor holds a row served in
a mixed, padded batch to the same row predicted alone.

Tolerances: against the block's own forward and between batches, 2e-5
(the reference's; on the CPU a batch of another size may take another
BLAS path); against the JAX package, 1e-5 of the largest entry (fp32
sums in another order); on the card, a served batch against the eager
block's forward of the same padded bucket: bitwise (a replay runs the
captured kernels in the eager order).

Every ``Future.result`` has a timeout and every Predictor is closed in a
``finally``, so no test can hang the suite. The JAX package is imported
inside the test that uses it, so ``pytest --noconftest
tests/test_torch_predictor.py -m cuda`` collects this file on a machine
without JAX.
"""
import json
import threading

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError, cached_op, serve
from mxnet_tpu_torch import telemetry as ttm
from mxnet_tpu_torch.gluon import Block
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo import BERTModel
from mxnet_tpu_torch.serve import (EngineDeadError, Predictor, bucket_ladder,
                                   pick_bucket, split_sizes)
from mxnet_tpu_torch.serve.bucketing import padded_rows
from mxnet_tpu_torch.testing import chaos

FEAT = 6
TOL = 2e-5
JAX_RTOL = 1e-5
WAIT = 60


@pytest.fixture(autouse=True)
def _clean():
    ttm.reset()
    chaos.clear()
    with tmx.cpu():
        yield
    chaos.clear()
    ttm.reset()


def _make_net(hybrid=True, seed=5):
    net = tnn.HybridSequential()
    net.add(tnn.Dense(8, activation="relu"), tnn.Dense(3))
    net.initialize(seed=seed)
    if hybrid:
        net.hybridize()
    return net


def _rows(n, seed=0, feat=FEAT):
    return onp.random.RandomState(seed).standard_normal(
        (n, feat)).astype("float32")


def _predictor(net, **kw):
    kw.setdefault("cache_dir", False)
    return net.predictor(example=torch.from_numpy(_rows(2)), **kw)


def _eager(net, x):
    with torch.no_grad(), cached_op.inlined():
        return net(torch.as_tensor(x)).float().numpy()


# -- bucketing --------------------------------------------------------------
def test_bucket_ladder_shapes():
    assert bucket_ladder(64) == [1, 2, 4, 8, 16, 32, 64]
    assert bucket_ladder(1) == [1]
    assert bucket_ladder(48, min_bucket=4) == [4, 8, 16, 32, 48]
    assert bucket_ladder(7) == [1, 2, 4, 7]
    with pytest.raises(MXNetError):
        bucket_ladder(0)
    with pytest.raises(MXNetError):
        bucket_ladder(4, min_bucket=8)


def test_pick_bucket_and_split_sizes():
    ladder = bucket_ladder(32)
    assert pick_bucket(1, ladder) == 1
    assert pick_bucket(5, ladder) == 8
    assert pick_bucket(32, ladder) == 32
    assert pick_bucket(33, ladder) is None
    assert split_sizes(70, 32) == [32, 32, 6]
    assert split_sizes(1, 32) == [1]
    assert split_sizes(32, 32) == [32]
    with pytest.raises(MXNetError):
        split_sizes(0, 32)
    assert padded_rows(5, 8) == 3


# -- predict: correctness across the ladder ---------------------------------
def test_predict_matches_eager_all_sizes():
    net = _make_net()
    pred = _predictor(net, max_batch=8)
    try:
        # a batch of 1, an interior bucket, ragged padding, exactly
        # max_batch, and more than max_batch (8 + 3)
        for n in (1, 3, 5, 8, 11):
            x = _rows(n, seed=n)
            got = pred.predict(tmx.np.array(x)).asnumpy()
            want = _eager(net, x)
            assert got.shape == want.shape
            onp.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        assert set(pred.stats()["programs"]) <= set(pred.buckets)
    finally:
        pred.close()


def test_predict_input_validation():
    net = _make_net()
    pred = _predictor(net, max_batch=4)
    try:
        with pytest.raises(MXNetError, match="dtype mismatch"):
            pred.predict(_rows(2).astype("int32"))
        with pytest.raises(MXNetError, match="item shape mismatch"):
            pred.predict(_rows(2, feat=FEAT + 1))
        with pytest.raises(MXNetError, match="1 inputs"):
            pred.predict((_rows(2), _rows(2)))
        with pytest.raises(MXNetError, match="empty batch"):
            pred.predict(onp.zeros((0, FEAT), "float32"))
    finally:
        pred.close()


def test_predictor_rejects_plain_block():
    class Plain(Block):
        def __init__(self):
            super().__init__()
            self.dense = tnn.Dense(3, in_units=FEAT)

        def forward(self, x):
            return self.dense(x)

    net = Plain()
    net.initialize()
    with pytest.raises(MXNetError, match="hybridizable"):
        Predictor(net, torch.from_numpy(_rows(2)), max_batch=4)


def test_bad_bucket_ladder_rejected():
    net = _make_net()
    with pytest.raises(MXNetError, match="ladder"):
        _predictor(net, max_batch=8, buckets=[1, 2, 4])


# -- submit: dynamic batching -----------------------------------------------
def test_submit_resolves_futures_correctly():
    net = _make_net()
    pred = _predictor(net, max_batch=8, max_wait_us=500)
    try:
        items = _rows(12, seed=3)
        want = _eager(net, items)
        futs = [pred.submit(items[i]) for i in range(len(items))]
        for i, f in enumerate(futs):
            onp.testing.assert_allclose(f.result(timeout=WAIT), want[i],
                                        rtol=TOL, atol=TOL)
        with pytest.raises(MXNetError, match="use predict"):
            pred.submit(items)
        with pytest.raises(MXNetError, match="dtype mismatch"):
            pred.submit(items[0].astype("int32"))
    finally:
        pred.close()


def test_dynamic_batching_coalesces_concurrent_submits():
    net = _make_net()
    pred = _predictor(net, max_batch=16, max_wait_us=20_000)
    try:
        pred.warmup()
        items = _rows(48, seed=7)
        want = _eager(net, items)
        barrier = threading.Barrier(8 + 1, timeout=WAIT)
        results = {}

        def client(cid):
            barrier.wait()
            for r in range(6):
                i = cid * 6 + r
                results[i] = pred.submit(items[i]).result(timeout=WAIT)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(8)]
        for t in threads:
            t.start()
        barrier.wait()
        for t in threads:
            t.join(timeout=WAIT)
            assert not t.is_alive()
        for i in range(48):
            onp.testing.assert_allclose(results[i], want[i], rtol=TOL,
                                        atol=TOL)
        st = pred.stats()
        assert st["requests"] == 48
        assert st["batches"] < 48, \
            "dispatcher never coalesced concurrent requests"
        assert st["batched_rows"] == 48
        assert 0.0 <= st["padding_waste"] < 1.0
        assert st["latency_ms_p50"] is not None
        assert st["latency_ms_p99"] >= st["latency_ms_p50"]
        assert ttm.histogram("serve.latency_ms").count == 48
    finally:
        pred.close()


def test_close_is_idempotent_and_rejects_traffic():
    net = _make_net()
    pred = _predictor(net, max_batch=4)
    pred.submit(_rows(1)[0]).result(timeout=WAIT)
    pred.close()
    pred.close()
    with pytest.raises(MXNetError, match="closed"):
        pred.submit(_rows(1)[0])
    with pytest.raises(MXNetError, match="closed"):
        pred.predict(_rows(2))


def test_no_program_made_after_warmup():
    net = _make_net()
    pred = _predictor(net, max_batch=8)
    try:
        pred.warmup()
        made = pred.stats()["captures"]
        assert made == len(pred.buckets) == 4
        for n in (1, 2, 3, 5, 8, 11, 19):
            pred.predict(_rows(n, seed=n))
        futs = [pred.submit(_rows(1, seed=90 + i)[0]) for i in range(10)]
        for f in futs:
            f.result(timeout=WAIT)
        assert pred.stats()["captures"] == made
        assert ttm.counter("serve.batches").value >= 1
        assert ttm.counter("serve.requests").value == 7 + 10
    finally:
        pred.close()


def test_warmup_manifest_roundtrip(tmp_path):
    net = _make_net()
    mpath = str(tmp_path / "model.warmup.json")
    pred = net.predictor(example=torch.from_numpy(_rows(2)), max_batch=8,
                         cache_dir=str(tmp_path / "cache"))
    try:
        manifest = pred.warmup(mpath)
        x = _rows(3, seed=1)
        want = pred.predict(x).asnumpy()
    finally:
        pred.close()
    m = serve.load_manifest(mpath)
    assert m["version"] == 1 and m["torch_version"] == torch.__version__
    assert m["max_batch"] == 8 and m["buckets"] == [1, 2, 4, 8]
    assert m["inputs"] == [{"item_shape": [FEAT], "dtype": "float32"}]
    assert m["signatures"] == manifest["signatures"] == {
        str(b): f"f32[{b},{FEAT}]" for b in (1, 2, 4, 8)}
    assert m["cache_dir"] == str(tmp_path / "cache")

    # a Predictor built from the manifest makes every bucket at
    # construction and then serves every size without another
    pred2 = Predictor(net, max_batch=3, manifest=mpath)
    try:
        assert pred2.max_batch == 8 and pred2.buckets == [1, 2, 4, 8]
        assert pred2.stats()["programs"] == [1, 2, 4, 8]
        made = pred2.stats()["captures"]
        onp.testing.assert_allclose(pred2.predict(x).asnumpy(), want,
                                    rtol=1e-6, atol=1e-6)
        assert pred2.stats()["captures"] == made
    finally:
        pred2.close()

    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"version": 99}))
    with pytest.raises(MXNetError, match="manifest version"):
        serve.load_manifest(str(bad))


def test_predictor_serves_its_copy_of_the_weights(tmp_path):
    net = _make_net()
    x = _rows(4, seed=4)
    before = _eager(net, x)
    pred = _predictor(net, max_batch=4)
    try:
        other = _make_net(hybrid=False, seed=9)
        other(torch.zeros(1, FEAT))
        other.save_parameters(str(tmp_path / "other.params"))
        net.load_parameters(str(tmp_path / "other.params"))
        after = _eager(net, x)
        assert not onp.allclose(before, after)
        # the predictor serves a copy: no tensor of its own is the block's,
        # and the block's hybridized calls read the block's weights
        ours = {p.data_ptr() for p in net.parameters()}
        assert not any(p.data_ptr() in ours for p in pred._params)
        assert net._cached == {}
        onp.testing.assert_array_equal(
            net(torch.from_numpy(x)).numpy(), after)
        onp.testing.assert_allclose(pred.predict(x).asnumpy(), before,
                                    rtol=TOL, atol=TOL)
        f = pred.submit(x[0])
        onp.testing.assert_allclose(f.result(timeout=WAIT), before[0],
                                    rtol=TOL, atol=TOL)
        net.cast("bfloat16")
        onp.testing.assert_allclose(pred.predict(x).asnumpy(), before,
                                    rtol=TOL, atol=TOL)
    finally:
        pred.close()


def test_matches_the_jax_predictor(tmp_path):
    import mxnet_tpu as mx

    net = _make_net(hybrid=False)
    net(torch.zeros(1, FEAT))
    path = str(tmp_path / "mlp.params")
    net.save_parameters(path)
    jnet = mx.gluon.nn.HybridSequential()
    jnet.add(mx.gluon.nn.Dense(8, activation="relu"), mx.gluon.nn.Dense(3))
    jnet.load_parameters(path)
    jnet.hybridize()
    x = _rows(7, seed=11)
    jpred = jnet.predictor(example=mx.np.array(_rows(2)), max_batch=4,
                           cache_dir=False)
    net.hybridize()
    pred = _predictor(net, max_batch=4)
    try:
        want = jpred.predict(mx.np.array(x)).asnumpy()
        got = pred.predict(x).asnumpy()
        assert got.shape == want.shape == (7, 3)
        assert abs(got - want).max() <= JAX_RTOL * abs(want).max()
        fj = jpred.submit(x[2])
        ft = pred.submit(x[2])
        onp.testing.assert_allclose(ft.result(timeout=WAIT),
                                    fj.result(timeout=WAIT),
                                    rtol=JAX_RTOL, atol=JAX_RTOL)
    finally:
        pred.close()
        jpred.close()


def test_bert_predictor_rows_do_not_leak():
    """Three-input items (tokens, token types, valid length): a row served
    in a mixed batch, beside rows of other lengths and the padding rows
    (valid length 0: every key masked), against the same row alone."""
    model = BERTModel(vocab_size=100, num_layers=2, units=32, hidden_size=64,
                      num_heads=4, max_length=16, dropout=0.1, device="cpu")
    model.initialize(seed=8)
    model.hybridize()
    rs = onp.random.RandomState(12)
    n = 5
    tok = rs.randint(0, 100, (n, 16)).astype("int32")
    tt = rs.randint(0, 2, (n, 16)).astype("int32")
    vl = rs.randint(1, 17, (n,)).astype("float32")
    example = (torch.zeros(1, 16, dtype=torch.int32),
               torch.zeros(1, 16, dtype=torch.int32), torch.zeros(1))
    pred = model.predictor(example=example, max_batch=8, max_wait_us=20_000)
    try:
        seq, pooled = pred.predict((tok, tt, vl))     # bucket 8: 3 pads
        alone = pred.predict((tok[2:3], tt[2:3], vl[2:3]))
        onp.testing.assert_allclose(seq.asnumpy()[2], alone[0].asnumpy()[0],
                                    rtol=TOL, atol=TOL)
        assert onp.isfinite(seq.asnumpy()).all()
        futs = [pred.submit((tok[i], tt[i], vl[i])) for i in range(n)]
        rows = [f.result(timeout=WAIT) for f in futs]
        for i, (s, p) in enumerate(rows):
            onp.testing.assert_allclose(s, seq.asnumpy()[i], rtol=TOL,
                                        atol=TOL)
            onp.testing.assert_allclose(p, pooled.asnumpy()[i], rtol=TOL,
                                        atol=TOL)
    finally:
        pred.close()


# -- self-healing (tests/test_chaos.py) ---------------------------------------
def _small_predictor():
    block = tnn.Dense(4, in_units=3)
    block.initialize(seed=13)
    block.hybridize()
    return Predictor(block, example=torch.zeros(2, 3), max_batch=4,
                     cache_dir=False, max_wait_us=100)


@pytest.mark.chaos
def test_predictor_transient_dispatch_retried():
    pred = _small_predictor()
    try:
        chaos.inject("serve.dispatch", "raise", countdown=0, times=1)
        futs = [pred.submit(onp.ones(3, "float32") * i) for i in range(2)]
        for f in futs:
            assert onp.asarray(f.result(timeout=WAIT)).shape == (4,)
        assert pred.healthy
        assert ttm.REGISTRY.counter("serve.retries").value >= 1
    finally:
        pred.close()


@pytest.mark.chaos
def test_predictor_terminal_dispatch_fails_only_that_batch():
    pred = _small_predictor()
    try:
        chaos.inject("serve.dispatch", "raise", countdown=0, times=50)
        f = pred.submit(onp.ones(3, "float32"))
        with pytest.raises(chaos.FaultError):
            f.result(timeout=WAIT)
        chaos.clear("serve.dispatch")
        assert pred.healthy and pred.stats()["dead"] is False
        f2 = pred.submit(onp.ones(3, "float32"))
        assert onp.asarray(f2.result(timeout=WAIT)).shape == (4,)
    finally:
        pred.close()


def test_predictor_dispatcher_crash_fails_everything():
    pred = _small_predictor()
    try:
        boom = RuntimeError("dispatcher exploded")

        def bad_dispatch(batch):
            raise boom

        pred._dispatch = bad_dispatch
        f = pred.submit(onp.ones(3, "float32"))
        with pytest.raises(EngineDeadError) as exc_info:
            f.result(timeout=WAIT)
        assert exc_info.value.__cause__ is boom
        with pytest.raises(EngineDeadError):
            pred.submit(onp.ones(3, "float32"))
        assert not pred.healthy
        assert pred.stats()["dead"] is True
        ok, why = pred._health()
        assert ok is False and "dispatcher exploded" in why
        assert ttm.REGISTRY.counter("serve.scheduler_crashes").value == 1
    finally:
        pred.close()


# -- on the card --------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_predictor_on_the_card(cuda):
    """Every bucket captured once by warmup, no capture while serving,
    each served batch bitwise equal to the eager block's forward of the
    same padded bucket batch, and the graphs' pool reported."""
    net = tnn.HybridSequential()
    net.add(tnn.Dense(64, activation="relu", device=cuda),
            tnn.LayerNorm(device=cuda), tnn.Dense(10, device=cuda))
    net.initialize(seed=14)
    net.hybridize()
    pred = net.predictor(example=torch.zeros(2, 32, device=cuda),
                         max_batch=16)
    try:
        pred.warmup()
        assert pred.stats()["captures"] == len(pred.buckets) == 5
        assert pred.stats()["pool_bytes"] > 0
        x = torch.randn(21, 32, device=cuda)
        got = pred.predict(x).asnumpy()
        padded = torch.cat([x[16:], x.new_zeros(3, 32)])
        with torch.no_grad(), cached_op.inlined():
            want = torch.cat([net(x[:16]), net(padded)[:5]]).cpu().numpy()
        assert onp.array_equal(got, want)
        futs = [pred.submit(x[i].cpu()) for i in range(8)]
        for f in futs:
            f.result(timeout=WAIT)
        assert pred.stats()["captures"] == 5
    finally:
        pred.close()
