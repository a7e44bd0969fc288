"""PyTorch/CUDA port: the GPT model slice against the JAX package.

A JAX ``gpt_tiny`` (2 layers, 64 units, 4 heads, vocab 50, max_length 64,
dropout 0) is built under ``mx.random.seed``, given weights drawn with
numpy, and its parameters carried into the port's by
``params_from_mxnet_tpu``; then the same numpy inputs go through both.
Logits and KV pools agree within fp32 max |diff| <= 1e-5;
greedy tokens agree up to the first near tie (top-2 margin < 1e-3).
"""
import numpy as onp
import pytest
import torch

from torch_parity import (MAX_LEN, VOCAB, assert_greedy_agree, prompts,
                          twin_gpt)

from mxnet_tpu_torch import MXNetError, params_from_mxnet_tpu
from mxnet_tpu_torch.gluon.model_zoo import gpt2_small, gpt_tiny

TOL = 1e-5


@pytest.fixture(scope="module")
def twins():
    return twin_gpt(seed=11)


def _j(a):
    from mxnet_tpu import np as mnp

    return mnp.array(onp.asarray(a))


def _t(a):
    return torch.from_numpy(onp.ascontiguousarray(a))


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = want.asnumpy() if hasattr(want, "asnumpy") else onp.asarray(want)
    assert got.shape == want.shape
    return float(onp.abs(got - want).max()) <= tol


def test_parameter_names_and_order_match(twins):
    jnet, tnet = twins
    jp, tp = jnet.collect_params(), tnet.collect_params()
    assert list(jp) == list(tp)
    assert all(tuple(jp[n].shape) == tuple(tp[n].shape) for n in jp)
    assert "blocks.0.ln_1.gamma" in tp and "ln_f.beta" in tp


@pytest.mark.parametrize("padded", [False, True])
def test_forward_logits_match(twins, padded):
    jnet, tnet = twins
    rs = onp.random.RandomState(1)
    toks = rs.randint(1, VOCAB, size=(3, 20)).astype("int32")
    if padded:
        vl = onp.array([20, 13, 5], "int32")
        want = jnet(_j(toks), _j(vl))
        got = tnet(_t(toks), _t(vl))
    else:
        want = jnet(_j(toks))
        got = tnet(_t(toks))
    assert _close(got, want)


def test_untied_lm_head_matches():
    jnet, tnet = twin_gpt(seed=12, tie_weights=False)
    assert "lm_head.weight" in tnet.collect_params()
    toks = onp.random.RandomState(3).randint(1, VOCAB, (2, 9)).astype("int32")
    assert _close(tnet(_t(toks)), jnet(_j(toks)))


def test_initialize_is_seeded_and_uses_each_parameters_initializer():
    a = gpt_tiny(vocab_size=VOCAB, num_layers=1, device="cpu")
    b = gpt_tiny(vocab_size=VOCAB, num_layers=1, device="cpu")
    a.initialize(seed=3)
    b.initialize(seed=3)
    pa = {n: p.detach() for n, p in a.collect_params().items()}
    pb = {n: p.detach() for n, p in b.collect_params().items()}
    assert all(torch.equal(pa[n], pb[n]) for n in pa)
    assert torch.equal(pa["blocks.0.ln_1.gamma"], torch.ones(64))
    assert not pa["blocks.0.attn_qkv.bias"].any()
    std = float(pa["blocks.0.ffn_1.weight"].std())
    assert 0.015 < std < 0.025                       # Normal(0.02)
    emb = pa["tok_embed.weight"]
    assert float(emb.abs().max()) <= 0.07            # default U(0.07)
    assert 0.035 < float(emb.std()) < 0.046          # 0.07 / sqrt(3)
    b.initialize(seed=4, force_reinit=True)
    assert not torch.equal(pa["tok_embed.weight"], pb["tok_embed.weight"])


def test_slot_cache_prefill_and_decode_match(twins):
    jnet, tnet = twins
    rs = onp.random.RandomState(2)
    toks = rs.randint(1, VOCAB, size=(2, 12)).astype("int32")
    vl = onp.array([12, 7], "int32")
    jl, jk, jv = jnet.forward_prefill(_j(toks), _j(vl))
    tl, tk_, tv = tnet.forward_prefill(_t(toks), _t(vl))
    assert _close(tl, jl) and _close(tk_, jk) and _close(tv, jv)
    kc = onp.pad(jk.asnumpy(), ((0, 0),) * 3 + ((0, 4), (0, 0)))
    vc = onp.pad(jv.asnumpy(), ((0, 0),) * 3 + ((0, 4), (0, 0)))
    nxt = onp.array([3, 4], "int32")
    jl, jk, jv = jnet.forward_decode(_j(nxt), _j(vl), _j(kc), _j(vc))
    tl, tk_, tv = tnet.forward_decode(_t(nxt), _t(vl), _t(kc), _t(vc))
    assert _close(tl, jl) and _close(tk_, jk) and _close(tv, jv)


# -- the paged trio: logits AND pools -----------------------------------------
NP, P = 12, 8
W = MAX_LEN // P          # 8 page-table columns + the sentinel column
S_ = NP                   # sentinel page id


def _pools(seed):
    rs = onp.random.RandomState(seed)
    shape = (NP, 2, 4, P, 16)
    return (rs.randn(*shape).astype("float32"),
            rs.randn(*shape).astype("float32"))


def _table(rows):
    t = onp.full((len(rows), W + 1), S_, "int32")
    for i, r in enumerate(rows):
        t[i, :len(r)] = r
    return t


def _paged_both(twins, fn, *args):
    jnet, tnet = twins
    jout = getattr(jnet, fn)(*[_j(a) for a in args])
    with torch.no_grad():   # the port writes the pools in place
        tout = getattr(tnet, fn)(*[_t(a.copy()) for a in args])
    return jout, tout


def test_prefill_paged_matches_and_drops_sentinel_writes(twins):
    rs = onp.random.RandomState(3)
    toks = rs.randint(1, VOCAB, size=(3, 16)).astype("int32")
    vl = onp.array([16, 9, 1], "int32")
    # row 1: its second live chunk maps to the sentinel (dropped); row 2 is
    # a batch-padding row whose whole table is the sentinel
    table = _table([[3, 5], [7, S_], []])
    kp, vp = _pools(4)
    (jl, jk, jv), (tl, tk_, tv) = _paged_both(
        twins, "forward_prefill_paged", toks, vl, table, kp, vp)
    assert _close(tl, jl) and _close(tk_, jk) and _close(tv, jv)
    untouched = [p for p in range(NP) if p not in (3, 5, 7)]
    assert onp.array_equal(tk_.numpy()[untouched], kp[untouched])
    assert onp.array_equal(tv.numpy()[NP - 1], vp[NP - 1])


def test_prefill_join_matches(twins):
    rs = onp.random.RandomState(5)
    toks = rs.randint(1, VOCAB, size=(2, 8)).astype("int32")
    vl = onp.array([8, 3], "int32")
    start = onp.array([8, 16], "int32")
    # prefix pages already resident: row 0 page 2, row 1 pages 4, 6
    table = _table([[2, 9], [4, 6, 10]])
    kp, vp = _pools(6)
    (jl, jk, jv), (tl, tk_, tv) = _paged_both(
        twins, "forward_prefill_join", toks, vl, start, table, kp, vp)
    assert _close(tl, jl) and _close(tk_, jk) and _close(tv, jv)


@pytest.mark.parametrize("K", [1, 3])
def test_decode_paged_matches(twins, K):
    rs = onp.random.RandomState(7)
    toks = rs.randint(1, VOCAB, size=(4, K)).astype("int32")
    # row 0 mid-page; row 1 crosses into an unmapped column (its writes
    # there drop); row 2 at the last position; row 3 an idle slot
    pos = onp.array([5, 15, MAX_LEN - 1, 0], "int32")
    table = _table([[1], [2, 3], [0, 4, 5, 6, 7, 8, 9, 10], []])
    kp, vp = _pools(8)
    (jl, jk, jv), (tl, tk_, tv) = _paged_both(
        twins, "forward_decode_paged", toks, pos, table, kp, vp)
    assert _close(tl, jl) and _close(tk_, jk) and _close(tv, jv)
    assert onp.array_equal(tk_.numpy()[NP - 1], kp[NP - 1])


@pytest.mark.parametrize("use_cache", [None, False])
def test_greedy_generate_matches(twins, use_cache):
    jnet, tnet = twins
    for p in prompts(3, seed=4):
        want = [int(t) for t in jnet.generate(
            p, max_new_tokens=10, use_cache=use_cache)[len(p):]]
        got = tnet.generate(p, max_new_tokens=10,
                            use_cache=use_cache)[len(p):]
        assert_greedy_agree(tnet, p, got, want)
    assert len(set(want)) > 1   # the continuation is not one repeated token


# -- parameters across packages --------------------------------------------
def test_params_file_round_trip_between_packages(twins, tmp_path):
    jnet, tnet = twins
    path = str(tmp_path / "gpt.params")
    jnet.save_parameters(path)
    fresh = gpt_tiny(vocab_size=VOCAB, dropout=0.0, num_layers=2, units=64,
                     num_heads=4, max_length=MAX_LEN, device="cpu")
    fresh.load_parameters(path)
    toks = _t(onp.arange(1, 11, dtype="int32").reshape(1, 10))
    assert torch.equal(fresh(toks), tnet(toks))
    back = str(tmp_path / "port.params")
    fresh.save_parameters(back)
    with onp.load(back) as z:
        for n, p in jnet.collect_params().items():
            assert onp.array_equal(z[n], p.data().asnumpy())


def test_params_from_mxnet_tpu_checks_names_and_shapes(twins):
    jnet, tnet = twins
    arrays = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    out = params_from_mxnet_tpu(arrays)
    assert set(out) == set(arrays)
    assert all(isinstance(t, torch.Tensor) for t in out.values())
    bad = dict(arrays)
    bad["ln_f.gamma"] = onp.zeros(3, "float32")
    with pytest.raises(MXNetError, match="ln_f.gamma"):
        params_from_mxnet_tpu(bad, tnet)
    missing = dict(arrays)
    del missing["tok_embed.weight"]
    with pytest.raises(MXNetError, match="tok_embed.weight"):
        params_from_mxnet_tpu(missing, tnet)
    extra = dict(arrays, stray=onp.zeros(2, "float32"))
    with pytest.raises(MXNetError, match="stray"):
        params_from_mxnet_tpu(extra, tnet)


# -- no silent CPU run ------------------------------------------------------
def test_entry_points_without_device_need_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid here")
    with pytest.raises(MXNetError, match="GPU is required"):
        gpt2_small()
    with pytest.raises(MXNetError, match="GPU is required"):
        gpt_tiny(vocab_size=VOCAB)
