"""PyTorch/CUDA port: the kernel tuning tier (``mxnet_tpu_torch.tune``)
against the JAX package's ``mxnet_tpu.tune``.

Keys, buckets and specs equal the reference's over a grid of shapes, dtypes
and flags. The resolve and cache cases of tests/test_tune.py run against
the port: default when tuning is off, a miss resolves to ``"xla"`` (the
library lowering) and moves the counters, override scoping, the save /
preload round trip, corrupt / stale / foreign files. Then what is the
port's own: the env accessors' legal set, the per-process memo that stands
in for the reference's trace (a key moves the counters once), the
candidate grid from the kernels' legal sets, and the discovery loop on a
``gpt_tiny`` ``DecodeEngine(device="cpu")``. On the CPU the tuner times the
plain versions (a mechanism check); the ``cuda``-marked cases time the
kernels on the card through CUDA graphs. The JAX package is imported
inside the tests that compare with it, so the ``cuda`` cases also run where
JAX is not installed.
"""
import json
import os

import numpy as onp
import pytest
import torch

from mxnet_tpu_torch import MXNetError, context
from mxnet_tpu_torch import telemetry as tm
from mxnet_tpu_torch import tune
from mxnet_tpu_torch.ops import cuda_kernels as tk


@pytest.fixture(autouse=True)
def clean_tuning(monkeypatch, tmp_path):
    # fresh tuning tier per test: in-process LRU and memo dropped, the
    # persistent file at a per-test tmp path, counters zeroed, env clean
    for var in ("MXTPU_TUNE", "MXTPU_FLASH_BLOCK_Q", "MXTPU_FLASH_BLOCK_K",
                "MXTPU_TUNE_TRIALS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("MXTPU_TUNE_CACHE", str(tmp_path / "tuning.json"))
    # the wrappers resolve only CUDA calls; these tests opt the CPU in to
    # drive the tier through the plain versions
    monkeypatch.setattr(tk, "_TUNED_DEVICES", ("cuda", "cpu"))
    tune.reset()
    tm.reset()
    yield
    tune.reset()
    tm.reset()


def _count(name):
    return tm.counter(name).value


# -- keys and specs: equal to the reference's ---------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("q_shape,tk_len", [
    ((1, 12, 5, 64), 5), ((2, 3, 48, 32), 80), ((4, 12, 512, 64), 512),
    ((8, 12, 1000, 64), 1024), ((3, 5, 7, 100), 333)])
def test_keys_equal_the_reference(q_shape, tk_len, dtype):
    from mxnet_tpu import tune as jtune

    k_shape = q_shape[:2] + (tk_len, q_shape[3])
    for causal in (False, True):
        for seg in (False, True):
            for kern in ("flash_fwd", "flash_bwd"):
                want = jtune.key_attention(kern, q_shape, k_shape, dtype,
                                           causal, seg)
                assert tune.key_attention(kern, q_shape, k_shape, dtype,
                                          causal, seg) == want
                assert tune.key_attention(
                    kern, torch.Size(q_shape), torch.Size(k_shape),
                    getattr(torch, dtype), causal, seg) == want
                spec = tune.attention_spec(kern, *q_shape[:3], tk_len,
                                           q_shape[3], dtype, causal, seg)
                jspec = jtune.attention_spec(kern, *q_shape[:3], tk_len,
                                             q_shape[3], dtype, causal, seg)
                assert spec == jspec
                assert tune.spec_key(spec) == jtune.spec_key(jspec)
                key = tune.spec_key(spec)
                assert tune.spec_from_key(key) == jtune.spec_from_key(key)
    rows = q_shape[0] * q_shape[2]
    for kern in ("layer_norm", "softmax"):
        want = jtune.key_rows(kern, rows, q_shape[3], dtype)
        assert tune.key_rows(kern, rows, q_shape[3], dtype) == want
        assert tune.key_rows(kern, rows, q_shape[3],
                             getattr(torch, dtype)) == want
        assert tune.spec_from_key(want) == jtune.spec_from_key(want)
    for n in (0, 1, 2, 3, 96, 128, 129, 50257):
        assert tune.bucket(n) == jtune.bucket(n)


@pytest.mark.parametrize("families", [
    ("flash_fwd", "layer_norm"), ("flash_bwd", "softmax"),
    ("flash_fwd", "flash_bwd", "layer_norm", "softmax")])
@pytest.mark.parametrize("seg", [False, True])
def test_ladder_specs_equal_the_reference(families, seg):
    from mxnet_tpu import tune as jtune

    args = ((1, 4, 8), (128, 512, 1024), 12, 64, 768)
    assert tune.ladder_specs(*args, seg=seg, families=families) == \
        jtune.ladder_specs(*args, seg=seg, families=families)


# -- the env accessors and the legal tiles ------------------------------------
def test_block_env_defaults_and_per_call_read(monkeypatch):
    assert tk.flash_block_q() == 32 and tk.flash_block_k() == 32
    monkeypatch.setenv("MXTPU_FLASH_BLOCK_Q", "64")
    monkeypatch.setenv("MXTPU_FLASH_BLOCK_K", "16")
    assert tk.flash_block_q() == 64 and tk.flash_block_k() == 16
    assert tk.FLASH_BLOCKS == (16, 32, 64)
    assert tk.ROW_BLOCKS == (1, 2, 4, 8, 16, 32)


@pytest.mark.parametrize("var,raw", [
    ("MXTPU_FLASH_BLOCK_Q", "100"),     # not a legal tile
    ("MXTPU_FLASH_BLOCK_Q", "8"),       # below the legal set
    ("MXTPU_FLASH_BLOCK_Q", "abc"),     # not an integer
    ("MXTPU_FLASH_BLOCK_K", "128"),     # above the legal set
    ("MXTPU_FLASH_BLOCK_K", "12x"),
])
def test_block_env_validation_names_the_var(monkeypatch, var, raw):
    monkeypatch.setenv(var, raw)
    fn = tk.flash_block_q if var.endswith("_Q") else tk.flash_block_k
    with pytest.raises(MXNetError, match=var):
        fn()


def test_candidates_come_from_the_legal_sets():
    spec = tune.attention_spec("flash_fwd", 1, 12, 128, 128, 64, seg=True)
    names = [n for n, _ in tune.candidates(spec, max_per_axis=2)]
    assert names == ["xla", "default", "q64k64", "q64k32", "q32k64"]
    assert [n for n, _ in tune.candidates(spec)] == [
        "xla", "default", "q64k64", "q64k32", "q64k16", "q32k64", "q32k16",
        "q16k64", "q16k32", "q16k16"]
    # a sequence shorter than every tile still gets the smallest
    short = tune.attention_spec("flash_bwd", 1, 2, 8, 8, 16)
    assert [c for _, c in tune.candidates(short)][2:] == [
        {"block_q": 16, "block_k": 16}]
    rows = tune.rows_spec("softmax", 3000, 768)
    assert tune.candidates(rows, max_per_axis=3) == [
        ("xla", "xla"), ("default", {"block_rows": 4}),
        ("r32", {"block_rows": 32}), ("r16", {"block_rows": 16}),
        ("r8", {"block_rows": 8})]
    assert tune.candidates(tune.rows_spec("layer_norm", 2, 768))[2:] == [
        ("r2", {"block_rows": 2}), ("r1", {"block_rows": 1})]


# -- the resolve tier ---------------------------------------------------------
def test_resolve_default_when_tuning_off():
    assert tune.resolve("flash_fwd", "flash_fwd|whatever") == "default"
    assert tune.missed() == []
    assert _count("tune.cache_misses") == 0


def test_miss_resolves_to_xla_with_counters_and_runs_the_plain_version_on_cpu(
        monkeypatch):
    monkeypatch.setenv("MXTPU_TUNE", "1")
    rng = onp.random.RandomState(0)
    x = torch.from_numpy(rng.randn(128, 96).astype("float32"))
    gamma, beta = torch.ones(96), torch.zeros(96)
    got = tk.fused_layer_norm(x, gamma, beta)
    assert _count("tune.cache_misses") == 1
    assert _count("tune.fallback_xla") == 1
    key = tune.key_rows("layer_norm", 128, 96, "float32")
    assert ("layer_norm", key) in tune.missed()
    # the library lowering is for CUDA tensors only: the CPU keeps the plain
    # version and counts no library call
    assert torch.equal(got, tk.layer_norm_plain(x, gamma, beta, 1e-5))
    assert tk.library_counts()["layer_norm"] == 0


def test_cpu_calls_resolve_nothing_without_the_opt_in(monkeypatch):
    monkeypatch.setenv("MXTPU_TUNE", "1")
    monkeypatch.setattr(tk, "_TUNED_DEVICES", ("cuda",))
    rng = onp.random.RandomState(1)
    x = torch.from_numpy(rng.randn(2, 2, 12, 16).astype("float32"))
    gamma, beta = torch.ones(16), torch.zeros(16)
    assert torch.equal(tk.fused_layer_norm(x, gamma, beta),
                       tk.layer_norm_plain(x, gamma, beta, 1e-5))
    assert torch.equal(tk.fused_softmax(x), tk.softmax_plain(x))
    xg = x.clone().requires_grad_()
    tk.flash_attention(xg, xg, xg, causal=True).sum().backward()
    assert tune.missed() == []
    assert all(v == 0 for n, v in tm.metrics().items()
               if n.startswith("tune."))
    # a pinned tile is still validated on the CPU
    with pytest.raises(MXNetError, match="block_rows=3"):
        tk.fused_softmax(x, block_rows=3)


def test_override_scoping_and_validation():
    with pytest.raises(ValueError, match="flash_fwd"):
        with tune.override("flash_fwd", {"block_q": 0}):
            pass
    with pytest.raises(ValueError):
        with tune.override("softmax", [128]):
            pass
    with tune.override("softmax", {"block_rows": 16}):
        with tune.override("softmax", "xla"):
            assert tune.resolve("softmax", "softmax|x") == "xla"
            assert tune.lookup("softmax", ("s",), lambda: "softmax|x") \
                == "xla"
        assert tune.resolve("softmax", "softmax|x") == {"block_rows": 16}
    assert tune.resolve("softmax", "softmax|x") == "default"


def test_memo_moves_the_counters_once_per_key(monkeypatch):
    monkeypatch.setenv("MXTPU_TUNE", "1")
    gamma, beta = torch.ones(64), torch.zeros(64)
    for rows in (100, 100, 128, 100):      # one bucket: rows128
        tk.fused_layer_norm(torch.randn(rows, 64), gamma, beta)
    assert _count("tune.cache_misses") == 1
    key = tune.key_rows("layer_norm", 128, 64, "float32")
    tune.record("layer_norm", key, {"block_rows": 8})   # clears the memo
    tk.fused_layer_norm(torch.randn(100, 64), gamma, beta)
    tk.fused_layer_norm(torch.randn(100, 64), gamma, beta)
    assert _count("tune.cache_hits") == 1
    assert tk._resolve_block_rows("layer_norm", 100, 64, torch.float32) == 8
    tune.reset()                                        # clears it too
    tk.fused_layer_norm(torch.randn(100, 64), gamma, beta)
    assert _count("tune.cache_misses") == 2
    # tuning off: nothing resolves, nothing moves
    monkeypatch.delenv("MXTPU_TUNE")
    tk.fused_layer_norm(torch.randn(100, 64), gamma, beta)
    assert _count("tune.cache_misses") == 2


def test_attention_resolves_forward_and_backward_separately(monkeypatch):
    monkeypatch.setenv("MXTPU_TUNE", "1")
    q = torch.randn(1, 2, 20, 16, requires_grad=True)
    # a forward miss takes the library lowering, whose backward is the
    # library's: flash_bwd is not asked (as the reference's _flash_bwd)
    tk.flash_attention(q, q, q, causal=True).sum().backward()
    assert [k for k, _ in tune.missed()] == ["flash_fwd"]
    # a tuned forward kernel: its backward resolves its own family, on the
    # caller's thread, only where autograd records the call
    fkey = tune.key_attention("flash_fwd", q.shape, q.shape, q.dtype, True,
                              False)
    tune.record("flash_fwd", fkey, {"block_q": 16, "block_k": 64})
    with torch.no_grad():
        tk.flash_attention(q, q, q, causal=True)
    assert tune.missed() == []
    tk.flash_attention(q, q, q, causal=True).sum().backward()
    assert [key for _, key in tune.missed()] == [
        fkey.replace("flash_fwd", "flash_bwd")]


# -- persistence -------------------------------------------------------------
def test_cache_roundtrip_fresh_process_no_remeasure(monkeypatch):
    monkeypatch.setenv("MXTPU_TUNE", "1")
    specs = [tune.rows_spec("layer_norm", 128, 128),
             tune.rows_spec("softmax", 128, 128),
             tune.attention_spec("flash_bwd", 1, 2, 32, 32, 16, seg=True)]
    res = tune.autotune(specs, trials=1, max_per_axis=1, device="cpu")
    assert [r["key"] for r in res] == [tune.spec_key(s) for s in specs]
    assert all(r["best_us"] <= r["default_us"] for r in res)
    meas = _count("tune.measurements")
    assert meas == sum(len(r["candidates"]) for r in res)
    path = tune.cache_path()
    with open(path) as fh:
        doc = json.load(fh)
    assert doc["version"] == tune.cache.SCHEMA_VERSION == 1
    assert doc["env_signature"] == context.env_signature()

    tune.reset()                                     # fresh-process sim
    assert tune.preload() == 3
    for s in specs:
        assert tune.resolve(s["kernel"], tune.spec_key(s)) != "default"
    assert _count("tune.measurements") == meas
    assert tune.missed() == []


def test_corrupt_cache_file_warns_and_retunes(monkeypatch):
    monkeypatch.setenv("MXTPU_TUNE", "1")
    with open(tune.cache_path(), "w") as fh:
        fh.write("{this is not json")
    with pytest.warns(RuntimeWarning, match="unreadable"):
        assert tune.preload() == 0
    assert _count("tune.cache_corrupt") == 1
    key = tune.key_rows("layer_norm", 128, 128, "float32")
    tune.record("layer_norm", key, {"block_rows": 16})
    tune.save()
    tune.reset()
    assert tune.preload() == 1
    assert tune.resolve("layer_norm", key) == {"block_rows": 16}


def _saved_doc(monkeypatch):
    monkeypatch.setenv("MXTPU_TUNE", "1")
    key = tune.key_rows("softmax", 128, 128, "float32")
    tune.record("softmax", key, {"block_rows": 32})
    path = tune.save()
    with open(path) as fh:
        return path, key, json.load(fh)


def test_stale_schema_version_skipped(monkeypatch):
    path, _, doc = _saved_doc(monkeypatch)
    doc["version"] = 99
    with open(path, "w") as fh:
        json.dump(doc, fh)
    tune.reset()
    with pytest.warns(RuntimeWarning, match="schema version"):
        assert tune.preload() == 0
    assert _count("tune.cache_corrupt") == 1


def test_foreign_env_signature_not_reused(monkeypatch):
    path, key, doc = _saved_doc(monkeypatch)
    doc["env_signature"] = "deadbeef0123"
    with open(path, "w") as fh:
        json.dump(doc, fh)
    tune.reset()
    with pytest.warns(RuntimeWarning, match="environment signature"):
        assert tune.preload() == 0
    assert tune.resolve("softmax", key) == "xla"


def test_corrupt_entry_skipped_good_entries_kept(monkeypatch):
    path, key, doc = _saved_doc(monkeypatch)
    doc["entries"]["layer_norm|rows128.d128.float32"] = {
        "config": {"block_rows": -4}}
    with open(path, "w") as fh:
        json.dump(doc, fh)
    tune.reset()
    with pytest.warns(RuntimeWarning, match="corrupt tuning-cache entry"):
        assert tune.preload() == 1
    assert tune.resolve("softmax", key) == {"block_rows": 32}


def test_cache_path_and_env_signature(monkeypatch, tmp_path):
    monkeypatch.setenv("MXTPU_TUNE_CACHE", "off")
    assert context.tuning_cache_path() is None
    monkeypatch.setenv("MXTPU_TUNE", "1")
    tune.record("softmax", "softmax|rows1.d1.float32", "xla")
    assert tune.save() is None                    # persistence disabled
    monkeypatch.delenv("MXTPU_TUNE_CACHE")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    path = context.tuning_cache_path()
    sig = context.env_signature()
    assert path == os.path.join(str(tmp_path),
                                f"mxtpu_torch_tune_{os.getuid()}", sig,
                                "tuning_cache.json")
    assert len(sig) == 16 and sig == context.env_signature()


def test_telemetry_registry_matches_the_reference_names():
    from mxnet_tpu import telemetry as jtm

    c = tm.counter("tune.cache_hits")
    assert c is tm.counter("tune.cache_hits")
    c.inc(2)
    tm.gauge("tune.entries").set(3)
    snap = tm.metrics()
    assert snap["tune.cache_hits"] == 2 and snap["tune.entries"] == 3.0
    with pytest.raises(MXNetError, match="already registered"):
        tm.gauge("tune.cache_hits")
    tm.reset()
    assert c.value == 0 and tm.counter("tune.cache_hits") is c
    # the tune tier registers the reference's counter names
    names = {n for n in tm.metrics() if n.startswith("tune.")}
    jnames = {n for n in jtm.metrics() if n.startswith("tune.")}
    assert {"tune.cache_hits", "tune.cache_misses", "tune.fallback_xla",
            "tune.cache_corrupt", "tune.measurements",
            "tune.entries"} <= names & jnames


# -- the discovery loop on a DecodeEngine -------------------------------------
def test_decode_engine_discovery_tune_preload_serve(monkeypatch):
    from mxnet_tpu_torch.gluon.model_zoo import gpt_tiny
    from mxnet_tpu_torch.serve.decode import DecodeEngine

    monkeypatch.setenv("MXTPU_TUNE", "1")
    torch.manual_seed(11)
    net = gpt_tiny(vocab_size=50, dropout=0.0, num_layers=1, units=32,
                   num_heads=2, max_length=32, device="cpu")

    def make_engine():
        return DecodeEngine(net, device="cpu", num_slots=2, max_len=32,
                            max_prompt_len=8, prefill_batch=2)

    eng = make_engine()
    eng.warmup()
    want = eng.submit([1, 2, 3], max_new_tokens=4).result(timeout=120)
    eng.close()
    worklist = tune.missed()
    assert {kern for kern, _ in worklist} == {"flash_fwd", "layer_norm"}
    res = tune.autotune([tune.spec_from_key(k) for _, k in worklist],
                        trials=1, max_per_axis=1, device="cpu")
    assert len(res) == len(worklist)

    tune.reset()                                  # a fresh process's view
    m0 = _count("tune.cache_misses")
    t0 = _count("tune.measurements")
    h0 = _count("tune.cache_hits")
    eng2 = make_engine()
    try:
        eng2.warmup()                             # preloads the winners
        assert _count("tune.cache_hits") >= h0 + len(worklist)
        assert _count("tune.cache_misses") == m0
        r0 = _count("tune.cache_hits")
        out = eng2.submit([1, 2, 3], max_new_tokens=4).result(timeout=120)
        assert out == want
        # steady state: every key is memoized, nothing resolves again
        assert _count("tune.cache_hits") == r0
        assert _count("tune.cache_misses") == m0
        assert _count("tune.measurements") == t0
    finally:
        eng2.close()


# -- on the card: the tuner times kernels through CUDA graphs -----------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the tuner times the CUDA kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_tune_one_on_card(cuda, monkeypatch):
    monkeypatch.setenv("MXTPU_TUNE", "1")
    for spec in (tune.rows_spec("softmax", 4096, 768),
                 tune.rows_spec("layer_norm", 2048, 768),
                 tune.attention_spec("flash_fwd", 1, 16, 512, 512, 64,
                                     seg=True),
                 tune.attention_spec("flash_bwd", 1, 16, 256, 256, 64)):
        tk.reset_launch_counts()
        res = tune.tune_one(spec, trials=2, max_per_axis=2)
        assert res["device"].startswith("cuda")
        assert 0 < res["best_us"] <= min(res["default_us"], res["xla_us"])
        assert tune.resolve(spec["kernel"], res["key"]) == res["config"]
        # every candidate ran: the library lowering and the kernels
        fam = spec["kernel"]
        assert tk.library_counts()[fam] > 0
        launched = {k[0] for k in tk.tile_counts()}
        assert launched >= ({"flash_bwd_dkv", "flash_bwd_dq"}
                            if fam == "flash_bwd" else {fam})
