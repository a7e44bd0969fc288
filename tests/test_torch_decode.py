"""PyTorch/CUDA port: the decode engine slice against the JAX package.

Host logic (allocators, paged cache tables, radix prefix cache, drafts)
runs the reference's own cases (tests/test_decode.py:83-228) against the
port's classes. The port's ``DecodeEngine(device="cpu", speculate_k=4,
prefix_cache=True)`` serves the same prompts as the JAX ``DecodeEngine``
over one set of weights; both streams, and the port's naive ``generate``,
agree up to the first near tie (top-2 margin < 1e-3). Also here: the
package's isolation from JAX (in a subprocess) and the no-silent-CPU rule.
"""
import ast
import pathlib
import subprocess
import sys
import time

import numpy as onp
import pytest
import torch

from torch_parity import MAX_LEN, assert_greedy_agree, prompts, twin_gpt

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.serve.decode import (DecodeEngine, KVCache,
                                          PageAllocator, PagedKVCache,
                                          RadixPrefixCache, SlotAllocator,
                                          accept_longest_prefix, make_draft)

PKG = pathlib.Path(__file__).resolve().parent.parent / "mxnet_tpu_torch"


# -- slot allocator / KV cache (reference cases) ------------------------------
def test_slot_alloc_free_reuse():
    alloc = SlotAllocator(3)
    sids = [alloc.alloc() for _ in range(3)]
    assert sorted(sids) == [0, 1, 2]
    assert alloc.alloc() is None          # full
    assert alloc.free_count == 0 and alloc.live == {0, 1, 2}
    alloc.free(sids[1])
    assert alloc.free_count == 1
    assert alloc.alloc() == sids[1]       # LIFO reuse of the freed slot
    with pytest.raises(MXNetError, match="double free"):
        alloc.free(7)
    with pytest.raises(MXNetError, match="at least one slot"):
        SlotAllocator(0)


def test_kv_cache_shape_and_rebind():
    cache = KVCache((2, 3, 4, 8, 5), "float32", device="cpu")
    assert cache.num_slots == 2 and cache.max_len == 8
    assert tuple(cache.k.shape) == (2, 3, 4, 8, 5)
    assert cache.nbytes == 2 * 3 * 4 * 8 * 5 * 4 * 2
    assert cache.occupancy() == 0.0
    k0 = cache.k
    cache.rebind(cache.k + 1, cache.v)
    assert cache.k is not k0
    with pytest.raises(MXNetError, match="cache shape"):
        KVCache((2, 3, 4), device="cpu")


def test_page_allocator_alloc_free_reuse_exhaustion():
    alloc = PageAllocator(4)
    got = alloc.alloc(3)
    assert len(got) == 3 and alloc.free_count == 1
    assert alloc.alloc(2) is None          # all-or-nothing: no partial grant
    assert alloc.free_count == 1           # the failed alloc took nothing
    one = alloc.alloc(1)
    assert alloc.alloc(1) is None and alloc.free_count == 0
    alloc.free(one + got[:1])
    assert alloc.free_count == 2 and len(alloc.live) == 2
    again = alloc.alloc(2)
    assert set(again) == set(one + got[:1])   # freed ids come back
    with pytest.raises(MXNetError, match="double free"):
        alloc.free(again[:1] + again[:1])
    with pytest.raises(MXNetError, match="at least one page"):
        PageAllocator(0)
    assert alloc.alloc(0) == []


def test_paged_kv_cache_tables_and_bytes():
    cache = PagedKVCache((6, 2, 4, 8, 5), "float32", num_slots=3,
                         max_len=16, device="cpu")
    assert cache.page_tokens == 8 and cache.pages_per_slot == 2
    assert cache.trash == 6
    assert cache.table.shape == (3, 3)     # W + 1 sentinel column
    assert (cache.table == 6).all()
    assert cache.nbytes == 6 * 2 * 4 * 8 * 5 * 4 * 2
    sid = cache.slots.alloc()
    cache.table[sid, :2] = cache.pages.alloc(2)
    cache.lengths[sid] = 9
    assert cache.pages_live() == 2
    cache.reset_row(sid)
    assert (cache.table[sid] == 6).all() and cache.lengths[sid] == 0
    with pytest.raises(MXNetError, match="pool shape"):
        PagedKVCache((6, 2, 4), num_slots=3, max_len=16, device="cpu")


# -- radix prefix cache (reference cases) -------------------------------------
def test_radix_insert_match_refcounts():
    tree = RadixPrefixCache(page_tokens=4)
    prompt = list(range(10, 21))            # 11 tokens = 2 full pages + 3
    h1, adopted = tree.insert(prompt, {0: 100, 1: 101})
    assert adopted == {0, 1}
    h2, adopted2 = tree.insert(prompt, {0: 200, 1: 201})
    assert adopted2 == set()
    m, pages, hm = tree.match(prompt[:9] + [99, 98])
    assert m == 8 and pages == [100, 101]
    m2, pages2, h3 = tree.match(prompt[:8])
    assert m2 == 4 and pages2 == [100]
    assert tree.evictable_pages() == 0
    assert tree.evict(2) == []
    for h in (h1, h2, hm, h3):
        tree.release(h)
    assert tree.evictable_pages() == 2
    freed = tree.evict(2)
    assert set(freed) == {100, 101}
    m3, pages3, _ = tree.match(prompt)
    assert m3 == 0 and pages3 == []
    with pytest.raises(MXNetError, match="full page"):
        tree.insert([1, 2, 3], {0: 7})


def test_radix_copy_on_write_divergence():
    tree = RadixPrefixCache(page_tokens=4)
    a = [1, 2, 3, 4, 5, 6, 7, 8, 9]
    h, _ = tree.insert(a, {0: 50, 1: 51})
    b = [1, 2, 3, 4, 5, 6, 99, 98, 97]
    m, pages, hb = tree.match(b)
    assert m == 4 and pages == [50]
    hb2, adopted = tree.insert(b, {0: 60, 1: 61})
    assert adopted == {1}
    m2, pages2, hc = tree.match(b[:8] + [42])
    assert m2 == 8 and pages2 == [50, 61]
    for hx in (h, hb, hb2, hc):
        tree.release(hx)
    st = tree.stats()
    assert st["pages"] == 3 and st["hits"] == 2
    freed = tree.evict(10)
    assert set(freed) == {50, 51, 61}


# -- speculative accept rule + drafts (reference cases) -----------------------
def test_accept_longest_prefix_edges():
    assert accept_longest_prefix([], [7]) == 1
    assert accept_longest_prefix([5, 6, 7], [5, 6, 7, 8]) == 4
    assert accept_longest_prefix([9, 6, 7], [5, 6, 7, 8]) == 1
    assert accept_longest_prefix([5, 6, 9], [5, 6, 7, 8]) == 3


def test_drafts():
    ng = make_draft("ngram")
    assert ng.propose([3, 4, 5, 9, 3, 4], 1) == [5]
    assert ng.propose([1, 2, 3, 1, 2], 2) == [3, 1]
    assert ng.propose([7], 3) == [7, 7, 7]
    assert make_draft("last").propose([1, 2, 3], 2) == [3, 3]
    with pytest.raises(MXNetError, match="unknown draft"):
        make_draft("bogus")


# -- the engine against the JAX engine and naive generate ---------------------
ENGINE = dict(num_slots=4, max_len=MAX_LEN, max_prompt_len=24,
              prefill_batch=4, page_tokens=8, speculate_k=4,
              prefix_cache=True)


@pytest.fixture(scope="module")
def twins():
    return twin_gpt(seed=11)


@pytest.fixture(scope="module")
def engines(twins):
    from mxnet_tpu.serve.decode import DecodeEngine as JaxDecodeEngine

    jnet, tnet = twins
    jeng = JaxDecodeEngine(jnet, cache_dir=False, **ENGINE)
    teng = DecodeEngine(tnet, device="cpu", **ENGINE)
    yield jeng, teng
    jeng.close()
    teng.close()


def _wait_first_token(stream, timeout=60):
    deadline = time.perf_counter() + timeout
    while not stream.tokens and time.perf_counter() < deadline:
        time.sleep(0.001)
    assert stream.tokens, "stream never produced a first token"


def test_engine_greedy_matches_jax_engine_and_naive(twins, engines):
    jnet, tnet = twins
    jeng, teng = engines
    ps = prompts(6, lo=1, hi=20, seed=3)
    budgets = [3 + (i % 4) * 2 for i in range(len(ps))]
    tstreams = [teng.submit(p, max_new_tokens=b) for p, b in zip(ps, budgets)]
    jstreams = [jeng.submit(p, max_new_tokens=b) for p, b in zip(ps, budgets)]
    for p, b, ts, js in zip(ps, budgets, tstreams, jstreams):
        got = ts.result(timeout=120)
        naive = tnet.generate(p, max_new_tokens=b, use_cache=False)[len(p):]
        assert_greedy_agree(tnet, p, got, naive)
        assert_greedy_agree(tnet, p, got, js.result(timeout=120))
    st = teng.stats()
    assert st["slots_live"] == 0 and st["pending"] == 0
    assert st["ticks"] > 0 and st["prefills"] >= 2
    assert st["speculate_k"] == 4 and st["spec_accept_mean"] >= 1.0


def test_engine_prefix_join_serves_shared_prompts(twins, engines):
    _, tnet = twins
    _, teng = engines
    rs = onp.random.RandomState(9)
    shared = [int(t) for t in rs.randint(1, 50, size=17)]  # 2 full pages
    first = shared + [3, 4]
    second = shared + [7]
    hits0 = teng.stats()["prefix_hit_tokens"]
    ext0 = teng.stats()["prefills_by_kind"]["prefill_ext"]
    s1 = teng.submit(first, max_new_tokens=6)
    _wait_first_token(s1)     # the tree holds a prompt once its prefill ran
    s2 = teng.submit(second, max_new_tokens=6)
    for p, s in ((first, s1), (second, s2)):
        naive = tnet.generate(p, max_new_tokens=6, use_cache=False)[len(p):]
        assert_greedy_agree(tnet, p, s.result(timeout=120), naive)
    st = teng.stats()
    assert st["prefix_hit_tokens"] - hits0 == 16
    assert st["prefills_by_kind"]["prefill_ext"] == ext0 + 1


def test_engine_truncation_validation_and_streaming(twins, engines):
    _, tnet = twins
    _, teng = engines
    stream = teng.submit([1, 2, 3, 4], max_new_tokens=100)
    out = stream.result(timeout=120)
    assert stream.truncated and len(out) == MAX_LEN - 4 + 1
    seen = []
    s = teng.submit([3, 1, 4, 1, 5], max_new_tokens=5, on_token=seen.append)
    assert list(s) == s.result(timeout=60) == seen
    with pytest.raises(MXNetError, match="empty prompt"):
        teng.submit([])
    with pytest.raises(MXNetError, match="max_prompt_len"):
        teng.submit(list(range(1, 40)))
    with pytest.raises(MXNetError, match="max_new_tokens"):
        teng.submit([1], max_new_tokens=0)


def test_engine_refuses_later_slices_and_missing_gpu(twins):
    _, tnet = twins
    for kw in ({"cache_dir": "/nonexistent"}, {"manifest": {}}, {"tp": 2}):
        with pytest.raises(MXNetError, match="later slice"):
            DecodeEngine(tnet, device="cpu", **kw)
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="GPU is required"):
            DecodeEngine(tnet)
    eng = DecodeEngine(tnet, device="cpu", num_slots=2, max_prompt_len=8,
                       page_tokens=8)
    assert sorted(eng.stats()["programs"]) == []
    eng.warmup()
    progs = eng.stats()["programs"]
    assert "decode|1" in progs and "prefill_ext|2|8" in progs
    # warmup ran every bucket with sentinel-only tables: nothing written
    assert not eng._cache.k.any() and not eng._cache.v.any()
    eng.close()
    with pytest.raises(MXNetError, match="closed"):
        eng.submit([1])


def test_engine_sheds_past_the_queue_budget_and_the_deadline(twins):
    from collections import deque

    from mxnet_tpu_torch.serve.decode import ShedError

    _, tnet = twins
    eng = DecodeEngine(tnet, device="cpu", num_slots=1, max_queue=2,
                       max_prompt_len=8, page_tokens=8)
    eng._start_worker = lambda: None      # hold the queue: no scheduler
    s1 = eng.submit([1, 2], max_new_tokens=2)
    s2 = eng.submit([3], max_new_tokens=2, deadline_ms=1)
    with pytest.raises(ShedError, match="queue at budget"):
        eng.submit([4])
    time.sleep(0.01)
    pending = deque()
    assert not eng._gather(pending) and list(pending) == [s1, s2]
    eng._expire(pending)
    assert list(pending) == [s1]
    with pytest.raises(ShedError, match="deadline expired"):
        s2.result(timeout=1)
    st = eng.stats()
    assert st["requests"] == 3 and st["shed"] == 2 and st["pending"] == 1


def test_engine_crash_fails_streams_with_the_cause(twins):
    _, tnet = twins
    eng = DecodeEngine(tnet, device="cpu", num_slots=2, max_prompt_len=8,
                       page_tokens=8)

    def boom(*args):
        raise RuntimeError("injected")

    eng.programs._prefill = boom
    stream = eng.submit([1, 2, 3], max_new_tokens=4)
    with pytest.raises(MXNetError, match="crashed") as info:
        stream.result(timeout=60)
    assert isinstance(info.value.__cause__, RuntimeError)
    assert not eng.healthy
    with pytest.raises(MXNetError, match="crashed"):
        eng.submit([1])


# -- the package stands alone ------------------------------------------------
def test_import_leaves_jax_and_the_jax_package_out():
    code = ("import sys, mxnet_tpu_torch, mxnet_tpu_torch.serve.decode, "
            "mxnet_tpu_torch.gluon.model_zoo\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'mxnet_tpu' or "
            "m.startswith('mxnet_tpu.'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(PKG.parent))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_source_file_imports_jax_or_the_jax_package():
    for path in PKG.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "mxnet_tpu", "jaxlib"), (path, n)
