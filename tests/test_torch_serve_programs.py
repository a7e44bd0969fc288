"""PyTorch/CUDA port: the decode engine's program table, manifests and
robustness layer against the JAX package.

Twin ``gpt_tiny`` models (2 layers, 64 units, 4 heads, vocab 50,
max_length 64, dropout 0) hold one set of numpy weights
(``torch_parity.twin_gpt``). Tolerances, each with its reason:

- pool writes that copy values (``_scatter_pages`` on given k/v) and every
  cell a write must leave alone: bitwise;
- logits, and pool cells holding k/v that each package computes: fp32 max
  |diff| <= 1e-5 (the parity bound of ``test_torch_gpt.py``);
- greedy tokens: equal up to the first near tie (top-2 margin < 1e-3);
- on the card, a captured replay against the eager body on the same
  operands and pools: bitwise (the same kernels in the same order).

The fixed-shape paged writes are held to the reference's one-hot versions
with sentinel columns, chunks past ``valid_length``, a slot at ``max_len``
and dropped writes that clamp onto a cell a live write owns. The JAX
package is imported inside the tests that use it, so
``pytest --noconftest tests/test_torch_serve_programs.py -m cuda`` collects
this file on a machine without JAX.
"""
import json
import subprocess
import sys
import threading

import numpy as onp
import pytest
import torch

from torch_parity import (MAX_LEN, VOCAB, assert_greedy_agree, numpy_weights,
                          prompts, twin_gpt)

from mxnet_tpu_torch import MXNetError, params_from_mxnet_tpu
from mxnet_tpu_torch import telemetry as ttm
from mxnet_tpu_torch.gluon.model_zoo import GPTModel, gpt_tiny
from mxnet_tpu_torch.serve.decode import (DecodeEngine, EngineDeadError,
                                          ShedError, load_decode_manifest)
from mxnet_tpu_torch.testing import chaos as tchaos

TOL = 1e-5
P = 8                     # page tokens
W = MAX_LEN // P          # page-table columns before the sentinel column
L, H, D = 2, 4, 16        # layers, heads, head dim of the twins


@pytest.fixture(scope="module")
def twins():
    return twin_gpt(seed=11)


def _j(a):
    from mxnet_tpu import np as mnp

    return mnp.array(onp.asarray(a))


def _t(a):
    return torch.from_numpy(onp.ascontiguousarray(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else x.asnumpy()


def _table(rows, sentinel):
    t = onp.full((len(rows), W + 1), sentinel, "int32")
    for i, r in enumerate(rows):
        t[i, :len(r)] = r
    return t


def _pools(seed, n_pages):
    rs = onp.random.RandomState(seed)
    shape = (n_pages, L, H, P, D)
    return (rs.randn(*shape).astype("float32"),
            rs.randn(*shape).astype("float32"))


def _counter(name):
    return ttm.counter(name).value


# -- fixed-shape paged writes against the reference's one-hot versions --------
NP_S = 12     # pages of the scatter cases; the sentinel is 12


@pytest.mark.parametrize("case", ["prefill", "join"])
def test_scatter_pages_matches_reference_bitwise(twins, case):
    """Page chunks into the pool: a chunk on a sentinel column, chunks past
    ``valid_length`` (one mapped to real pages that must stay as they
    were), and dropped chunks that clamp onto page 11, which a live chunk
    of row 0 owns — the owner's value must win, whatever the order."""
    jnet, _ = twins
    rs = onp.random.RandomState(21)
    S = NP_S
    if case == "prefill":
        T, start = 20, None
        valid = onp.array([20, 9, 1, 5], "int32")
        table = _table([[3, 11, 5], [7, S], [], [4, 6, 8]], S)
    else:
        T = 8
        start = onp.array([8, 0, 16, 0], "int32")
        valid = onp.array([8, 8, 3, 1], "int32")
        table = _table([[2, 11], [9], [0, 1, 10], []], S)
    k = rs.randn(len(valid), L, H, T, D).astype("float32")
    v = rs.randn(len(valid), L, H, T, D).astype("float32")
    kp, vp = _pools(22, NP_S)
    jk, jv = jnet._scatter_pages(
        _j(k), _j(v), _j(valid), None if start is None else _j(start),
        _j(table), _j(kp), _j(vp))
    tk, tv = _t(kp.copy()), _t(vp.copy())
    GPTModel._scatter_pages(_t(k), _t(v), _t(valid),
                            None if start is None else _t(start),
                            _t(table), tk, tv)
    assert onp.array_equal(tk.numpy(), _np(jk))
    assert onp.array_equal(tv.numpy(), _np(jv))
    assert not onp.array_equal(tk.numpy()[11], kp[11])   # row 0 wrote it


NP_D = 20     # pages of the decode and join cases; the sentinel is 20


@pytest.mark.parametrize("K", [1, 4])
def test_decode_paged_fixed_shape_matches_reference(twins, K):
    """Rows: 0 writes page 19 at offset 3; 1 is an idle slot whose dropped
    writes clamp onto (19, 3..); 2 ends at the last position (K > 1 runs
    past the page view); 3 is a slot at ``max_len`` (every write dropped);
    4 crosses into an unmapped column."""
    jnet, tnet = twins
    S = NP_D
    rs = onp.random.RandomState(23)
    toks = rs.randint(1, VOCAB, size=(5, K)).astype("int32")
    pos = onp.array([3, 3, MAX_LEN - 1, MAX_LEN, 6], "int32")
    table = _table([[19], [], list(range(8)), list(range(8, 16)), [16]], S)
    kp, vp = _pools(24, NP_D)
    jl, jk, jv = jnet.forward_decode_paged(_j(toks), _j(pos), _j(table),
                                           _j(kp), _j(vp))
    tk, tv = _t(kp.copy()), _t(vp.copy())
    with torch.no_grad():
        tl, _, _ = tnet.forward_decode_paged(_t(toks), _t(pos), _t(table),
                                             tk, tv)
    for got, want in ((tl, jl), (tk, jk), (tv, jv)):
        assert float(onp.abs(_np(got) - _np(want)).max()) <= TOL
    written = onp.zeros(kp.shape[:1] + kp.shape[3:4], bool)   # (page, off)
    for r, p0 in enumerate(pos):
        for i in range(K):
            col = (p0 + i) // P
            if col < W and table[r, col] < S:
                written[table[r, col], (p0 + i) % P] = True
    for page in range(NP_D):
        for off in range(P):
            if not written[page, off]:
                assert onp.array_equal(tk.numpy()[page, :, :, off],
                                       kp[page, :, :, off])
    assert written[19, 3]   # row 0's cell, which row 1's drops clamp onto


def test_prefill_join_fixed_shape_matches_reference(twins):
    """Rows: 0 joins at 8 and owns page 19; 1 joins at 56 so its padded
    suffix runs past the page view (positions >= 64 dropped, clamping onto
    position 63, which its own live row owns); 2 is a batch-padding row
    whose dropped chunk clamps onto page 19."""
    jnet, tnet = twins
    S = NP_D
    rs = onp.random.RandomState(25)
    toks = rs.randint(1, VOCAB, size=(3, 16)).astype("int32")
    valid = onp.array([5, 8, 1], "int32")
    start = onp.array([8, 56, 0], "int32")
    table = _table([[2, 19, 11], [0, 1, 3, 4, 5, 6, 7, 8], []], S)
    kp, vp = _pools(26, NP_D)
    jl, jk, jv = jnet.forward_prefill_join(_j(toks), _j(valid), _j(start),
                                           _j(table), _j(kp), _j(vp))
    tk, tv = _t(kp.copy()), _t(vp.copy())
    with torch.no_grad():
        tl, _, _ = tnet.forward_prefill_join(_t(toks), _t(valid), _t(start),
                                             _t(table), tk, tv)
    for got, want in ((tl, jl), (tk, jk), (tv, jv)):
        assert float(onp.abs(_np(got) - _np(want)).max()) <= TOL
    for page in (11, 12, 13, 14, 15, 16, 17, 18) + (0, 1, 2, 3, 4, 5, 6, 7):
        assert onp.array_equal(tk.numpy()[page], kp[page]), page


def test_prefill_logits_gathered_before_the_head(twins):
    """``forward_prefill`` and ``forward_prefill_paged`` gather the last
    valid hidden row before ``ln_f`` and the head: the reference's one-hot
    pick of the full logits, and the port's own full forward at that row,
    within 1e-5."""
    jnet, tnet = twins
    rs = onp.random.RandomState(27)
    toks = rs.randint(1, VOCAB, size=(3, 24)).astype("int32")
    valid = onp.array([24, 11, 1], "int32")
    jl, _, _ = jnet.forward_prefill(_j(toks), _j(valid))
    table = _table([[0, 1, 2], [3, 4], [5]], NP_D)
    kp, vp = _pools(28, NP_D)
    jpl, _, _ = jnet.forward_prefill_paged(_j(toks), _j(valid), _j(table),
                                           _j(kp), _j(vp))
    with torch.no_grad():
        tl, _, _ = tnet.forward_prefill(_t(toks), _t(valid))
        tpl, _, _ = tnet.forward_prefill_paged(
            _t(toks), _t(valid), _t(table), _t(kp.copy()), _t(vp.copy()))
        full = tnet(_t(toks), _t(valid))
    rows = full[torch.arange(3), _t(valid).long() - 1]
    for got, want in ((tl, jl), (tpl, jpl), (tl, rows)):
        assert tuple(got.shape) == (3, VOCAB)
        assert float(onp.abs(_np(got) - _np(want)).max()) <= TOL


# -- manifests ----------------------------------------------------------------
MANIFEST_ENGINE = dict(num_slots=4, max_len=MAX_LEN, max_prompt_len=16,
                       prefill_batch=2)   # the reference's test_decode.py:495


@pytest.fixture(scope="module")
def jax_manifest_engine(twins):
    from mxnet_tpu.serve.decode import DecodeEngine as JaxDecodeEngine

    jnet, _ = twins
    jeng = JaxDecodeEngine(jnet, cache_dir=False, **MANIFEST_ENGINE)
    manifest = jeng.warmup()
    yield jeng, manifest
    jeng.close()


def test_manifest_has_the_reference_keys_geometry_and_signatures(
        twins, jax_manifest_engine, tmp_path):
    _, tnet = twins
    _, want = jax_manifest_engine
    path = str(tmp_path / "gpt.decode.manifest.json")
    eng = DecodeEngine(tnet, device="cpu", cache_dir=str(tmp_path / "c"),
                       **MANIFEST_ENGINE)
    try:
        got = eng.warmup(path)
    finally:
        eng.close()
    assert set(got) - {"torch_version"} == set(want) - {"jax_version"}
    for key in ("version", "kind", "num_slots", "max_len", "prefill_batch",
                "max_prompt_len", "page_tokens", "kv_pages", "speculate_k",
                "prefix_cache", "tp", "batch_ladder", "len_ladder",
                "cache_shape", "cache_dtype", "signatures", "graphs"):
        assert got[key] == want[key], key
    assert set(got["signatures"]) == {
        "decode|1", "prefill|1|8", "prefill|1|16", "prefill|2|8",
        "prefill|2|16", "prefill_ext|1|8", "prefill_ext|1|16",
        "prefill_ext|2|8", "prefill_ext|2|16"}
    assert got["cache_dir"] == str(tmp_path / "c")
    assert got["torch_version"] == torch.__version__
    on_disk = load_decode_manifest(path)
    assert on_disk["signatures"] == got["signatures"]


def test_engine_from_manifest_adopts_geometry_and_builds_nothing(
        twins, jax_manifest_engine, tmp_path):
    jnet, tnet = twins
    jeng, _ = jax_manifest_engine
    path = str(tmp_path / "m.json")
    first = DecodeEngine(tnet, device="cpu", **MANIFEST_ENGINE)
    first.warmup(path)
    first.close()
    prompt = [2, 7, 1, 8]
    want = jeng.submit(prompt, max_new_tokens=5).result(timeout=120)
    for manifest in (path, load_decode_manifest(path)):
        eng = DecodeEngine(tnet, device="cpu", num_slots=16,
                           manifest=manifest)
        try:
            assert eng.num_slots == 4 and eng.prefill_batch == 2
            assert eng.max_prompt_len == 16 and eng.page_tokens == MAX_LEN
            built = eng.programs._captures
            assert built == 9 and len(eng.stats()["programs"]) == 9
            got = eng.submit(prompt, max_new_tokens=5).result(timeout=120)
            assert_greedy_agree(tnet, prompt, got, want)
            assert eng.programs._captures == built
        finally:
            eng.close()


def test_load_decode_manifest_rejects_other_versions(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"version": 99}))
    with pytest.raises(MXNetError, match="decode manifest"):
        load_decode_manifest(str(bad))
    bad.write_text(json.dumps({"version": 2, "kind": "predictor"}))
    with pytest.raises(MXNetError, match="decode manifest"):
        load_decode_manifest(str(bad))


def test_export_and_later_slices_still_raise(twins):
    _, tnet = twins
    eng = DecodeEngine(tnet, device="cpu", num_slots=2, max_prompt_len=8,
                       page_tokens=8)
    try:
        with pytest.raises(MXNetError, match="graph layer"):
            eng.programs.export("/nonexistent/prefix")
        with pytest.raises(MXNetError, match="graph layer"):
            type(eng.programs).from_export("/nonexistent/prefix")
    finally:
        eng.close()


# -- the zero-steady-state-capture contract (test_decode.py:358) --------------
def test_no_program_built_after_warmup_64_ragged_clients(twins):
    """64 ragged clients on 8 threads against a warmed engine with paged KV,
    radix prefix sharing and K = 4: no program is built after warmup, and
    ``stats()`` and the serve counters add up."""
    _, tnet = twins
    eng = DecodeEngine(tnet, device="cpu", num_slots=8, max_len=MAX_LEN,
                       max_prompt_len=16, prefill_batch=4, page_tokens=8,
                       speculate_k=4, prefix_cache=True, max_queue=128)
    try:
        eng.warmup()
        built = eng.programs._captures
        assert built == 1 + 2 * 2 * 3    # decode + 2 families x 2 x 3
        c0 = {n: _counter(n) for n in ("serve.tokens_total",
                                       "serve.requests",
                                       "serve.prefix_hit_tokens")}
        ps = prompts(64, lo=1, hi=16, seed=9)
        shared = prompts(1, lo=9, hi=10, seed=77)[0]   # covers one page
        for i in range(0, 64, 2):
            ps[i] = shared + ps[i][:7]
        budgets = [1 + (i % 6) for i in range(64)]
        results = {}
        barrier = threading.Barrier(8 + 1)

        def client(cid):
            barrier.wait()
            for r in range(8):
                i = cid * 8 + r
                results[i] = eng.submit(
                    ps[i], max_new_tokens=budgets[i]).result(timeout=300)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(8)]
        for t in threads:
            t.start()
        barrier.wait()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        assert eng.programs._captures == built
        for i in (0, 17, 40, 63):
            naive = tnet.generate(ps[i], max_new_tokens=budgets[i],
                                  use_cache=False)[len(ps[i]):]
            assert_greedy_agree(tnet, ps[i], results[i], naive)
        st = eng.stats()
        total = sum(len(results[i]) for i in range(64))
        assert st["tokens"] == total == sum(budgets)
        assert st["completed"] == 64 and st["shed"] == 0
        assert _counter("serve.tokens_total") - c0["serve.tokens_total"] \
            == total
        assert _counter("serve.requests") - c0["serve.requests"] == 64
        assert st["prefix_hit_tokens"] > 0
        assert _counter("serve.prefix_hit_tokens") - \
            c0["serve.prefix_hit_tokens"] == st["prefix_hit_tokens"]
        assert st["ttft_ms_p50"] is not None
        assert st["tpot_ms_p99"] >= st["tpot_ms_p50"]
        assert 1.0 <= st["spec_accept_mean"] <= 4.0
        assert 0 <= st["kv_pages_live"] <= st["kv_pages"]
        assert st["page_starved"] == 0
        assert ttm.gauge("serve.slots_live").value == st["slots_live"] == 0
        assert ttm.gauge("mem.kv_cache_bytes").value == st["cache_bytes"]
        assert ttm.gauge("serve.kv_pages_live").value == \
            st["kv_pages_live"]
    finally:
        eng.close()


# -- the chaos harness, both packages -----------------------------------------
@pytest.fixture(params=["mxnet_tpu", "mxnet_tpu_torch"])
def chaos_pkg(request):
    """(chaos module, its package's ``fault.injected`` counter, its
    package's MXNetError)."""
    if request.param == "mxnet_tpu":
        from mxnet_tpu import telemetry as jtm
        from mxnet_tpu.base import MXNetError as error
        from mxnet_tpu.testing import chaos

        registry = jtm.REGISTRY
    else:
        chaos, registry, error = tchaos, ttm.REGISTRY, MXNetError
    chaos.clear()
    yield chaos, registry.counter("fault.injected"), error
    chaos.clear()


@pytest.fixture(autouse=True)
def _disarmed():
    tchaos.clear()
    yield
    tchaos.clear()


@pytest.mark.chaos
def test_chaos_env_name_mapping(chaos_pkg):
    chaos, _, _ = chaos_pkg
    assert chaos.env_name("ckpt.write.manifest") == \
        "MXTPU_FAULT_CKPT_WRITE_MANIFEST"
    assert chaos.env_name("decode.tick") == "MXTPU_FAULT_DECODE_TICK"


@pytest.mark.chaos
def test_chaos_unarmed_point_is_noop(chaos_pkg):
    chaos, _, _ = chaos_pkg
    assert chaos.fault_point("no.such.point") is False
    assert chaos.armed("no.such.point") is None


@pytest.mark.chaos
def test_chaos_inject_countdown_and_times(chaos_pkg):
    chaos, fired, _ = chaos_pkg
    n0 = fired.value
    chaos.inject("t.p", "raise", countdown=2, times=2)
    assert chaos.armed("t.p") == ("raise", 2, 2)
    assert chaos.fault_point("t.p") is False   # countdown 2 -> 1
    assert chaos.fault_point("t.p") is False   # countdown 1 -> 0
    with pytest.raises(chaos.FaultError):
        chaos.fault_point("t.p")               # fire 1/2
    with pytest.raises(chaos.FaultError):
        chaos.fault_point("t.p")               # fire 2/2, disarms
    assert chaos.fault_point("t.p") is False
    assert chaos.armed("t.p") is None
    assert fired.value - n0 == 2


@pytest.mark.chaos
def test_chaos_corrupt_and_flag_return_true(chaos_pkg):
    chaos, _, _ = chaos_pkg
    chaos.inject("t.c", "corrupt")
    assert chaos.fault_point("t.c") is True
    chaos.inject("t.f", "flag", times=2)
    assert chaos.fault_point("t.f") is True
    assert chaos.fault_point("t.f") is True
    assert chaos.fault_point("t.f") is False


@pytest.mark.chaos
def test_chaos_env_spec_parsing(chaos_pkg, monkeypatch):
    chaos, _, _ = chaos_pkg
    monkeypatch.setenv("MXTPU_FAULT_SOME_POINT", "raise:1:1")
    chaos.refresh()
    assert chaos.armed("some.point") == ("raise", 1, 1)
    assert chaos.fault_point("some.point") is False
    with pytest.raises(chaos.FaultError):
        chaos.fault_point("some.point")
    chaos.clear("some.point")


@pytest.mark.chaos
def test_chaos_unknown_action_rejected(chaos_pkg):
    chaos, _, error = chaos_pkg
    with pytest.raises(error, match="unknown fault action"):
        chaos.inject("t.x", "explode")


@pytest.mark.chaos
def test_chaos_clear_disarms_everything(chaos_pkg):
    chaos, _, _ = chaos_pkg
    chaos.inject("t.a", "raise")
    chaos.inject("t.b", "flag")
    chaos.clear()
    assert chaos.fault_point("t.a") is False
    assert chaos.fault_point("t.b") is False


@pytest.mark.chaos
def test_chaos_die_is_a_real_sigkill():
    """The port's ``die`` is a SIGKILL: no cleanup, no traceback."""
    import signal

    child = ("from mxnet_tpu_torch.testing import chaos\n"
             "chaos.inject('t.die', 'die')\n"
             "chaos.fault_point('t.die')\n"
             "print('SURVIVED')\n")
    proc = subprocess.run([sys.executable, "-c", child],
                          capture_output=True, text=True, timeout=300,
                          cwd=str(__import__("pathlib").Path(
                              __file__).resolve().parent.parent))
    assert proc.returncode == -signal.SIGKILL
    assert "SURVIVED" not in proc.stdout
    assert "[chaos] SIGKILL at fault point" in proc.stderr


# -- the engine's robustness layer (tests/test_chaos.py:149-220) --------------
def _small_engine(tnet, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("max_prompt_len", 8)
    kw.setdefault("prefill_batch", 2)
    kw.setdefault("page_tokens", 8)
    return DecodeEngine(tnet, device="cpu", **kw)


@pytest.mark.chaos
@pytest.mark.parametrize("point", ["decode.prefill", "decode.tick"])
def test_engine_transient_failure_retried(twins, point):
    """A program-run failure that clears within the retry budget (2) is
    invisible to clients and counted in ``serve.retries``."""
    _, tnet = twins
    eng = _small_engine(tnet)
    r0 = _counter("serve.retries")
    try:
        tchaos.inject(point, "raise", countdown=0, times=2)
        out = eng.submit([3, 1, 4], max_new_tokens=4).result(timeout=120)
        naive = tnet.generate([3, 1, 4], max_new_tokens=4,
                              use_cache=False)[3:]
        assert_greedy_agree(tnet, [3, 1, 4], out, naive)
        assert eng.healthy and eng.stats()["dead"] is False
        assert _counter("serve.retries") - r0 == 2
    finally:
        eng.close()


@pytest.mark.chaos
def test_engine_scheduler_crash_fails_all_streams(twins):
    """Retries exhausted: every stream raises EngineDeadError with the real
    cause, submit refuses, the health check fails and the crash counts."""
    _, tnet = twins
    eng = _small_engine(tnet)
    c0 = _counter("serve.scheduler_crashes")
    try:
        tchaos.inject("decode.tick", "raise", countdown=0, times=50)
        streams = [eng.submit([2, 7, 1], max_new_tokens=4),
                   eng.submit([5, 9], max_new_tokens=4)]
        for s in streams:
            with pytest.raises(EngineDeadError) as info:
                s.result(timeout=120)
            assert isinstance(info.value.__cause__, tchaos.FaultError)
        with pytest.raises(EngineDeadError):
            eng.submit([1, 2], max_new_tokens=2)
        assert not eng.healthy
        ok, why = eng._health()
        assert ok is False and "crashed" in why
        assert eng.stats()["dead"] is True
        assert _counter("serve.scheduler_crashes") - c0 == 1
    finally:
        eng.close()


def test_engine_drain_sheds_new_finishes_live(twins):
    """drain(): accepted work runs to completion while new submits shed;
    resume() reopens the engine."""
    _, tnet = twins
    eng = _small_engine(tnet)
    s0 = _counter("serve.shed_total")
    try:
        stream = eng.submit([4, 2], max_new_tokens=4)
        assert eng.drain(timeout=120) is True
        assert len(stream.result(timeout=1)) == 4
        assert eng.stats()["draining"] is True
        assert eng._health() == (True, {"slots_live": 0, "draining": True})
        with pytest.raises(ShedError, match="draining"):
            eng.submit([1], max_new_tokens=2)
        assert _counter("serve.shed_total") - s0 == 1
        eng.resume()
        out = eng.submit([1, 2, 3], max_new_tokens=3).result(timeout=120)
        assert len(out) == 3 and eng.stats()["draining"] is False
    finally:
        eng.close()


def test_out_of_memory_is_not_retried(twins):
    """A device OOM is not transient: the first one is the crash."""
    _, tnet = twins
    eng = _small_engine(tnet)
    r0 = _counter("serve.retries")

    def oom(*args):
        raise torch.cuda.OutOfMemoryError("injected out of memory")

    eng.programs._prefill = oom
    try:
        stream = eng.submit([1, 2, 3], max_new_tokens=2)
        with pytest.raises(EngineDeadError) as info:
            stream.result(timeout=60)
        assert isinstance(info.value.__cause__, torch.cuda.OutOfMemoryError)
        assert _counter("serve.retries") == r0
    finally:
        eng.close()


# -- on the card --------------------------------------------------------------
CARD_ENGINE = dict(num_slots=4, max_len=MAX_LEN, max_prompt_len=16,
                   prefill_batch=2, page_tokens=P, prefix_cache=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the programs capture CUDA graphs "
                    "of the CUDA kernels, which have no CPU mode)")
    return torch.device("cuda")


def _card_model(device, units=64, vocab=VOCAB):
    model = gpt_tiny(vocab_size=vocab, dropout=0.0, num_layers=L,
                     units=units, num_heads=H, max_length=MAX_LEN,
                     device=device)
    shapes = {n: tuple(p.shape) for n, p in model.collect_params().items()}
    model.load_dict(params_from_mxnet_tpu(numpy_weights(shapes, 31), model))
    return model


def _card_operands(progs, key, rng):
    """Operands of one run that write real pages (distinct per row)."""
    kind = key[0]
    rows = progs.num_slots if kind == "decode" else key[1]
    table = onp.full((rows, progs.table_width), progs.kv_pages, "int32")
    for r in range(rows):
        table[r, :3] = [3 * r, 3 * r + 1, 3 * r + 2]
    if kind == "decode":
        toks = rng.randint(1, VOCAB, size=(rows, key[1])).astype("int32")
        return [toks, rng.randint(0, 3 * P, size=rows).astype("int32"),
                table]
    toks = rng.randint(1, VOCAB, size=(rows, key[2])).astype("int32")
    valid = rng.randint(1, key[2] + 1, size=rows).astype("int32")
    if kind == "prefill":
        return [toks, valid, table]
    return [toks, valid, onp.full(rows, P, "int32"), table]


@pytest.mark.cuda
def test_captured_replays_bit_equal_the_eager_body(cuda):
    model = _card_model(cuda)
    eng = DecodeEngine(model, **CARD_ENGINE)
    try:
        eng.warmup()
        progs, cache = eng.programs, eng._cache
        rng = onp.random.RandomState(32)
        with torch.no_grad():
            cache.k.copy_(torch.randn_like(cache.k))
            cache.v.copy_(torch.randn_like(cache.v))
        for key in (("decode", 1), ("prefill", 2, 16),
                    ("prefill_ext", 2, 16)):
            datas = _card_operands(progs, key, rng)
            k0, v0 = cache.k.clone(), cache.v.clone()
            replays = progs._programs[key].replays
            toks, _, _ = progs.run(key, datas + [cache.k, cache.v])
            assert progs._programs[key].replays == replays + 1
            ka, va = cache.k.clone(), cache.v.clone()
            cache.k.copy_(k0)
            cache.v.copy_(v0)
            prog = progs._programs[key]
            with torch.inference_mode():
                prog.load(datas)
                want = prog.body(cache.k, cache.v).cpu()
            torch.cuda.synchronize()
            assert torch.equal(toks, want), key
            assert torch.equal(ka, cache.k) and torch.equal(va, cache.v), key
            assert not torch.equal(ka, k0), key    # the run wrote pages
    finally:
        eng.close()


@pytest.mark.cuda
def test_a_moved_pool_captures_anew(cuda):
    model = _card_model(cuda)
    eng = DecodeEngine(model, **CARD_ENGINE)
    try:
        eng.warmup()
        progs, cache = eng.programs, eng._cache
        n = progs._captures
        assert n == len(progs.keys()) == 1 + 2 * 2 * 2
        counts = progs.graph_stats()
        assert counts["prefill|2|16"]["captured_launches"]["flash_fwd"] == L
        assert counts["decode|1"]["captured_launches"]["layer_norm"] == \
            2 * L + 1
        datas = _card_operands(progs, ("decode", 1), onp.random.RandomState(3))
        k2, v2 = cache.k.clone(), cache.v.clone()
        a, _, _ = progs.run(("decode", 1), datas + [k2, v2])
        assert progs._captures == n + 1          # the warm call, then capture
        b, _, _ = progs.run(("decode", 1), datas + [k2, v2])
        assert progs._captures == n + 1          # a replay
        assert torch.equal(a, b)
    finally:
        eng.close()


@pytest.mark.cuda
def test_captures_stay_flat_under_ragged_traffic(cuda):
    model = _card_model(cuda)
    eng = DecodeEngine(model, speculate_k=4, max_queue=64, **CARD_ENGINE)
    try:
        eng.warmup()
        n = eng.programs._captures
        ps = prompts(24, lo=1, hi=16, seed=5)
        shared = [5, 9, 2, 8, 7, 3, 6, 4, 1]    # one full page and one token
        for i in range(0, 24, 2):
            ps[i] = shared + ps[i][:6]
        streams = [eng.submit(p, max_new_tokens=1 + i % 6)
                   for i, p in enumerate(ps)]
        outs = [s.result(timeout=300) for s in streams]
        assert eng.programs._captures == n
        for i in (0, 7, 22, 23):
            naive = model.generate(ps[i], max_new_tokens=1 + i % 6,
                                   use_cache=False)[len(ps[i]):]
            assert_greedy_agree(model, ps[i], outs[i], naive)
        st = eng.stats()
        assert st["completed"] == 24 and st["prefix_hit_tokens"] > 0
    finally:
        eng.close()


@pytest.mark.cuda
def test_the_graph_pool_is_shared(cuda):
    """Bytes the whole table's graphs hold in one shared pool, against the
    same captures each in a pool of its own (the allocator's segments of
    each pool, ``torch.cuda.memory_snapshot``)."""
    import gc

    def table_bytes(shared):
        model = _card_model(cuda, units=256, vocab=1000)
        eng = DecodeEngine(model, **dict(CARD_ENGINE, max_prompt_len=MAX_LEN))
        progs = eng.programs
        pools = set()
        for key in progs.keys():
            if not shared:
                progs._pool = None
            progs.ensure(key[0], *key[1:], pools=(eng._cache.k,
                                                  eng._cache.v))
            pools.add(tuple(progs._pool))
        torch.cuda.synchronize()
        held = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) in pools)
        assert not shared or held == progs.pool_bytes()
        n = len(progs.keys())
        eng.close()
        del eng, progs, model
        gc.collect()
        torch.cuda.empty_cache()
        return held, len(pools), n

    (shared, one, n), (separate, many, _) = table_bytes(True), \
        table_bytes(False)
    assert one == 1 and many == n == 1 + 2 * 4 * 2
    assert 0 < shared * 3 < separate, (shared, separate)
