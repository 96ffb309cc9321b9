"""The port's prefix cache (`kvcache.PrefixCachingAllocator`, the
executor's lookup / register, `infer.prefix_cache=true`): the
counterparts of tests/test_prefix_cache.py, on the CPU.

Full prompt pages are content-hashed and shared read-only between
requests, so a repeated prefix prefills only its tail. Held here: the
allocator's bookkeeping (attach, publish, free, evict, refcounts, the
LRU, collision checks), operation for operation equal to the JAX
allocator under random sequences; engine tokens equal to the uncached
engine's (exactly: shared pages hold the KV the uncached prefill
computes), immutability under decode churn, reclaim, hit tails on the
packed slab, the JAX engine's hits and tokens on the same f32 tree, a
DeepSeek engine, and a pool so small that preemption and LRU eviction
both fire.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from chitu_tpu.config import load_config as jload
from chitu_tpu.engine import Engine as JEngine
from chitu_tpu.kvcache.paged import PrefixCachingAllocator as JPrefix
from chitu_tpu.task import SampleParams as JSampleParams
from chitu_tpu_torch import SampleParams
from chitu_tpu_torch.config import load_config as tload
from chitu_tpu_torch.engine import Engine
from chitu_tpu_torch.kvcache import (
    NativeBackedPageAllocator,
    PrefixCachingAllocator,
)
from chitu_tpu_torch.models.llama import params_from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The engines here run many small ops; under the suite's parallel
    workers, each with a torch thread a core, an op's threads spend most
    of its time waiting on each other. One thread keeps these tests near
    their time in a process of their own."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jax_op_impl_auto():
    """Run each test with the JAX op_impl switch at "auto": a JAX test in
    the same worker may leave it at "pallas", and the JAX side of these
    tests would then reach a Pallas kernel outside interpret mode."""
    mod = importlib.import_module("chitu_tpu.ops.linear")
    old = mod._OP_IMPL
    mod._OP_IMPL = "auto"
    yield
    mod._OP_IMPL = old


PAGE = 16


# ---------------------------------------------------------------------------
# the allocator
# ---------------------------------------------------------------------------


def _alloc():
    return PrefixCachingAllocator(num_pages=8, page_size=PAGE)


def test_allocator_attach_publish_free():
    a = _alloc()
    prompt = list(range(40))  # 2 full pages + 8-token tail
    assert a.lookup("r1", prompt) == 0  # cold
    assert a.ensure("r1", len(prompt) + 1)
    pages_r1 = list(a.req_pages["r1"])
    a.register("r1", prompt)
    # r2 with the same prompt attaches the 2 full pages
    assert a.lookup("r2", prompt) == 2 * PAGE
    assert a.req_pages["r2"] == pages_r1[:2]
    assert a.hits == 2
    assert a.ensure("r2", len(prompt) + 1)
    assert a.req_pages["r2"][2] not in pages_r1  # r2's tail page is private
    a.free("r1")
    a.free("r2")
    # shared pages stay cached (evictable), privates return to the pool
    assert len(a.lru) == 2
    assert a.num_free() == 8  # free + evictable
    assert a.lookup("r3", prompt) == 2 * PAGE  # still cached


def test_allocator_divergent_prefix():
    a = _alloc()
    p1 = list(range(40))
    p2 = list(range(16)) + list(range(100, 124))  # shares page 0 only
    a.lookup("r1", p1)
    a.ensure("r1", 41)
    a.register("r1", p1)
    assert a.lookup("r2", p2) == PAGE
    assert a.ensure("r2", 41)
    a.register("r2", p2)  # p2's second full page under its own chain
    a.free("r1")
    a.free("r2")
    assert a.lookup("r3", p2) == 2 * PAGE


def test_allocator_eviction_under_pressure():
    a = _alloc()
    for i in range(3):  # 3 distinct 2-page prompts: 6 cached pages
        prompt = list(range(100 * i, 100 * i + 33))
        a.lookup(f"w{i}", prompt)
        assert a.ensure(f"w{i}", 34)
        a.register(f"w{i}", prompt)
        a.free(f"w{i}")
    assert len(a.lru) == 6
    # a new 7-page request evicts LRU entries and fits
    assert a.ensure("big", 7 * PAGE)
    assert len(a.req_pages["big"]) == 7
    a.free("big")
    assert a.num_free() == 8


def test_allocator_page_aligned_prompt():
    a = _alloc()
    prompt = list(range(32))  # exactly 2 pages: the last stays private
    a.lookup("r1", prompt)
    a.ensure("r1", 33)
    a.register("r1", prompt)
    assert a.lookup("r2", prompt) == PAGE


def test_lookup_rejects_hash_collisions():
    """Sharing verifies token content and parent linkage, never the chain
    hash alone."""
    a = PrefixCachingAllocator(num_pages=8, page_size=4)
    victim = list(range(100, 105))
    assert a.lookup("victim", victim) == 0
    assert a.ensure("victim", len(victim) + 1)
    a.register("victim", victim)
    a.free("victim")
    # forge a colliding chain entry: same entry, different tokens
    attacker = [1, 2, 3, 4, 9]
    a.entries[a._chain(attacker)[0]] = a.entries[a._chain(victim)[0]]
    assert a.lookup("attacker", attacker) == 0
    # a corrupted parent link stops the walk after page 1
    long_prompt = list(range(200, 210))
    assert a.ensure("p", len(long_prompt) + 1)
    a.register("p", long_prompt)
    a.free("p")
    chain = a._chain(long_prompt)
    pg, toks, _ = a.entries[chain[1]]
    a.entries[chain[1]] = (pg, toks, 999)
    assert a.lookup("q", long_prompt) == 4
    a.free("q")


def test_deferred_request_still_hits_cache_on_retry():
    a = PrefixCachingAllocator(num_pages=3, page_size=4)
    prompt = list(range(50, 59))  # two full pages + tail: 3 pages
    assert a.lookup("twin", prompt) == 0
    assert a.ensure("twin", len(prompt) + 1)
    assert a.lookup("cold", prompt) == 0
    assert not a.ensure("cold", len(prompt) + 1)  # deferred
    a.register("twin", prompt)
    a.free("twin")
    assert a.lookup("cold", prompt) == 8  # the retry attaches the prefix


_PROMPTS = [
    list(range(10, 27)),  # A: 4 full pages of 4 + 1
    list(range(10, 22)) + [90, 91, 92],  # A's first 3 pages, other tail
    list(range(10, 18)) + list(range(60, 70)),  # A's first 2 pages
    list(range(30, 39)),  # B
    list(range(30, 38)) + [5, 5, 5, 5, 5],  # B's first 2 pages
    list(range(10, 26)),  # A page-aligned: its 4th page stays private
]


@settings(max_examples=40, deadline=None)
@given(st.lists(
    st.tuples(st.integers(0, 3), st.integers(0, 3),
              st.integers(0, len(_PROMPTS) - 1), st.integers(1, 12)),
    min_size=1, max_size=40,
))
def test_allocator_lockstep_with_jax(ops):
    """Random sequences of admissions (lookup, then ensure, the pinned
    pages released when it fails, as the executor does), growth, register
    and free, applied to the port's and the JAX allocator in lockstep on a
    12-page pool: equal return values, page lists, hits, misses, free
    counts, cache entries, LRU order and block tables after every step."""
    t, j = PrefixCachingAllocator(12, 4), JPrefix(12, 4)
    rids = [f"r{i}" for i in range(4)]
    prompt_of = {}
    for op, r, p, d in ops:
        rid = rids[r]
        if op == 0:  # admit
            prompt_of.setdefault(rid, _PROMPTS[p])
            pr = prompt_of[rid]
            out = []
            for a in (t, j):
                got = a.lookup(rid, pr)
                ok = a.ensure(rid, len(pr) + 1)
                if not ok and got:
                    a.free(rid)
                out.append((got, ok))
            assert out[0] == out[1]
        elif op == 1:  # grow
            n = len(t.req_pages.get(rid, [])) * 4 + d
            assert t.ensure(rid, n) == j.ensure(rid, n)
        elif op == 2 and rid in prompt_of:  # publish
            t.register(rid, prompt_of[rid])
            j.register(rid, prompt_of[rid])
        elif op == 3:  # finish
            t.free(rid)
            j.free(rid)
            prompt_of.pop(rid, None)
        assert t.req_pages == j.req_pages
        assert (t.hits, t.misses, t.num_free()) == (j.hits, j.misses, j.num_free())
        assert t.entries == j.entries and list(t.lru) == list(j.lru)
        assert t.refcount == j.refcount
        np.testing.assert_array_equal(t.block_table(rids, 8),
                                      j.block_table(rids, 8))


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

TINY = [
    "models=micro-llama-debug", "infer.max_seq_len=128", "infer.max_reqs=4",
    "infer.page_size=16", "request.max_new_tokens=8",
    "infer.stop_with_eos=false",
]
PC = ["infer.prefix_cache=true"]


@pytest.fixture(scope="module")
def engines():
    """(port uncached, port cached, JAX cached, port factory), all on the
    JAX engine's own weights in f32."""
    jeng = JEngine(jload(overrides=TINY + PC))
    tree = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jeng.params)
    jeng.params = jeng.executor.params = tree
    tree = params_from_numpy(jax.tree_util.tree_map(np.asarray, tree))

    def port(*extra):
        return Engine(tload(overrides=TINY + list(extra)), device="cpu",
                      params=tree)

    return port(), port(*PC), jeng, port


def _prompt_tokens(seed, n):
    return np.random.default_rng(seed).integers(300, 500, n).tolist()


def _gen(e, toks, n=6):
    req = e.submit("", SampleParams(temperature=0.0, max_new_tokens=n),
                   prompt_tokens=toks)
    e.run_until_complete()
    return list(req.async_stream.tokens)


def _burst(e, prompts, n=5, params=SampleParams):
    reqs = [e.submit("", params(temperature=0.0, max_new_tokens=n),
                     prompt_tokens=p) for p in prompts]
    e.run_until_complete()
    return [list(r.async_stream.tokens) for r in reqs]


def test_engine_tokens_match_uncached(engines):
    base, eng, _, _ = engines
    assert isinstance(eng.cache.allocator, PrefixCachingAllocator)
    assert isinstance(base.cache.allocator, NativeBackedPageAllocator)
    prompt = _prompt_tokens(0, 40)
    hits0 = eng.cache.allocator.hits
    want = _gen(base, prompt)
    first = _gen(eng, prompt)
    assert eng.cache.allocator.hits == hits0  # cold
    second = _gen(eng, prompt)
    assert eng.cache.allocator.hits == hits0 + 2  # 2 full pages reused
    assert first == want and second == want


def test_engine_shared_pages_survive_decode_churn(engines):
    base, eng, _, _ = engines
    prompt = _prompt_tokens(1, 45)
    _gen(eng, prompt)  # seed the cache
    for tail in (_prompt_tokens(2, 7), _prompt_tokens(3, 7),
                 _prompt_tokens(2, 7)):
        assert _gen(eng, prompt + tail) == _gen(base, prompt + tail)


def test_engine_concurrent_sharers_and_reclaim(engines):
    _, eng, _, _ = engines
    prompt = _prompt_tokens(4, 40)
    free0 = eng.cache.allocator.num_free()
    outs = _burst(eng, [prompt] * 4, n=4)
    assert len(eng.pool) == 0
    assert all(o == outs[0] for o in outs)
    # everything reclaimable (cached pages count as free)
    assert eng.cache.allocator.num_free() == free0 == eng.cache.num_pages


def test_prefix_hits_stay_on_packed_prefill(engines, monkeypatch):
    """Hit tails prefill through the packed slab as mid-context segments
    (B2 from block_qstart > 0), not one request at a time; a lone warm
    prompt with nothing in flight takes `_prefill_one` from its cached
    length (B5 at q_pos > 0). Tokens equal the uncached engine's."""
    base, eng, _, _ = engines
    shared = _prompt_tokens(3, 32)
    prompts = [shared + _prompt_tokens(9 + i, 7) for i in range(3)]
    lone = shared + _prompt_tokens(20, 5)
    want, want_lone = _burst(base, prompts), _gen(base, lone)
    _burst(eng, prompts)  # cold for this prefix: publishes the pages
    hits0 = eng.cache.allocator.hits

    calls = []
    ex_type = type(eng.executor)
    orig_one, orig_packed = ex_type._prefill_one, ex_type._prefill_packed_step
    starts = []

    def spy_one(self, t, tokens=None):
        calls.append((t.task_id, t.prefilled_len))
        return orig_one(self, t, tokens)

    def spy_packed(self, tasks_g, piggyback=None):
        starts.extend(t.prefilled_len for t in tasks_g)
        return orig_packed(self, tasks_g, piggyback)

    monkeypatch.setattr(ex_type, "_prefill_one", spy_one)
    monkeypatch.setattr(ex_type, "_prefill_packed_step", spy_packed)
    assert _burst(eng, prompts) == want  # warm: every row hits
    assert eng.cache.allocator.hits == hits0 + 6
    assert not calls, f"prefix-hit rows left the packed prefill: {calls}"
    assert starts == [32, 32, 32]
    # a lone warm prompt: the chunked path from the cached length
    assert _gen(eng, lone) == want_lone
    assert [s for _, s in calls] == [32]


def test_prefix_cache_matches_jax_engine(engines):
    """A cold and a warm burst of three prompts on one 48-token prefix in
    the port's and the JAX package's cached engines: equal hits, misses
    and greedy tokens."""
    _, _, jeng, port = engines
    eng = port(*PC)
    shared = _prompt_tokens(30, 48)
    prompts = [shared + _prompt_tokens(31 + i, 5 + 6 * i) for i in range(3)]
    for _ in range(2):
        got = _burst(eng, prompts)
        want = _burst(jeng, prompts, params=JSampleParams)
        assert got == want
        assert (eng.cache.allocator.hits, eng.cache.allocator.misses) == (
            jeng.cache.allocator.hits, jeng.cache.allocator.misses)
    # the warm burst: 3 pages each (the longest prompt's 4th page was
    # published under its own cold page 3, so its parent check stops it)
    assert eng.cache.allocator.hits == 9


def test_prefix_cache_under_pool_pressure(engines, monkeypatch):
    """A cached engine at kv_pool_frac 0.3 (10 pages for four requests of
    99 tokens, 7 pages each, 2 of them shared), with the LRU full of
    other prompts' pages: preemption and LRU eviction both fire, every
    request completes, and the tokens equal the roomy uncached engine's."""
    base, _, _, port = engines
    tight = port(*PC, "infer.kv_pool_frac=0.3", "infer.decode_window=4")
    alloc = tight.cache.allocator
    assert alloc.num_pages == 10
    counts = {"preempt": 0, "evict": 0}
    real_preempt, real_evict = tight.executor.preempt, alloc._evict_one

    def preempt(t):
        counts["preempt"] += 1
        real_preempt(t)

    def evict():
        ok = real_evict()
        counts["evict"] += ok
        return ok

    monkeypatch.setattr(tight.executor, "preempt", preempt)
    monkeypatch.setattr(alloc, "_evict_one", evict)
    shared = _prompt_tokens(40, 36)
    prompts = [shared + [300 + i, 301, 302 + i] for i in range(4)]
    want = _burst(base, prompts, n=60)
    # stale entries (two other prompts' 6 pages sit in the LRU), then the
    # shared prefix's pages
    _burst(tight, [_prompt_tokens(41, 50), _prompt_tokens(42, 50)], n=2)
    _burst(tight, prompts[:1], n=2)
    got = _burst(tight, prompts, n=60)
    assert got == want
    assert counts["preempt"] > 0 and counts["evict"] > 0
    assert alloc.num_free() == alloc.num_pages and len(tight.pool) == 0


def test_non_paged_cache_disables_prefix_cache():
    eng = Engine(tload(overrides=TINY + PC + ["infer.cache_type=dense"]),
                 device="cpu")
    assert not hasattr(eng.cache.allocator, "lookup")
    assert len(_gen(eng, _prompt_tokens(5, 40), 3)) == 3


def test_deepseek_prefix_cache_matches_uncached():
    """The prefix cache is model-agnostic: a tiny DeepSeek engine's warm
    burst hits and its tails run the latent packed prefill from
    block_qstart > 0; tokens equal the uncached engine's."""
    ds = ["models=tiny-deepseek-debug", "models.n_layers=2"] + TINY[1:]
    plain = Engine(tload(overrides=ds), device="cpu")
    eng = Engine(tload(overrides=ds + PC), device="cpu")
    shared = _prompt_tokens(50, 32)
    prompts = [shared + _prompt_tokens(51 + i, 4 + 3 * i) for i in range(3)]
    want = _burst(plain, prompts)
    assert _burst(eng, prompts) == want
    assert _burst(eng, prompts) == want
    assert eng.cache.allocator.hits == 6
    assert eng.cache.allocator.num_free() == eng.cache.num_pages


def test_serve_reports_prefix_hits_after_spec_warmup():
    """The server with both on: warmup runs its greedy burst on the
    windowed path (calibrating the dispatch cost), then a spec burst, and
    leaves spec decode on; /status reports the prefix cache's real hits
    after a repeated prompt."""
    import dataclasses

    import requests

    from chitu_tpu_torch.serve import BackgroundServer

    cfg = tload(overrides=TINY + PC + ["infer.spec_decode=ngram"])
    cfg = dataclasses.replace(cfg, serve=dataclasses.replace(cfg.serve, port=0))
    srv = BackgroundServer(cfg, warmup=True, device="cpu")
    base = f"http://127.0.0.1:{srv.start()}"
    try:
        ex = srv.ctx.engine.executor
        assert ex.spec_enabled and ex._spec_stats[1] > 0
        assert ex._kappa_src == "calibrated"
        body = {"messages": "a repeated prompt " * 4, "temperature": 0.0,
                "max_tokens": 4, "stream": False}
        for _ in range(2):
            r = requests.post(f"{base}/v1/chat/completions", json=body,
                              timeout=120)
            assert r.status_code == 200
        st = requests.get(f"{base}/status").json()["prefix_cache"]
        assert st["page_hits"] >= 4 and st["cached_pages"] > 0
    finally:
        srv.stop()
