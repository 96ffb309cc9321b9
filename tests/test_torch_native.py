"""The port's native page allocator (`native.py` over the port's own
`csrc/hostops.cpp`, built by g++) and the allocator switch, then
preemption, spec decode near max_seq_len and `kv_pool_frac` on the port's
engine: the counterparts of tests/test_native.py and of
tests/test_engine.py's preemption, spec-tail and under-provisioned-pool
tests, on the CPU.

Under KV pressure the port's greedy tokens equal the JAX engine's roomy
run on the same f32 tree, with the native and with the Python allocator.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chitu_tpu import native as jnative
from chitu_tpu.config import load_config as jload
from chitu_tpu.engine import Engine as JEngine
from chitu_tpu.task import SampleParams as JSampleParams
from chitu_tpu_torch import SampleParams, native
from chitu_tpu_torch.config import load_config as tload
from chitu_tpu_torch.engine import Engine
from chitu_tpu_torch.kvcache import (
    NativeBackedPageAllocator,
    PageAllocator,
    PagedKVCache,
    PrefixCachingAllocator,
)
from chitu_tpu_torch.models.llama import params_from_numpy
from chitu_tpu_torch.ops import cuda_build


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


# ---------------------------------------------------------------------------
# the native allocator
# ---------------------------------------------------------------------------


def test_native_matches_python_and_jax_native_allocators():
    """One sequence of grows, a failed grow and releases on the port's
    native allocator, the JAX package's, and the Python allocator: equal
    results, free counts and block tables (the same free-list order)."""
    py = PageAllocator(num_pages=16, page_size=8)
    nt = native.NativePageAllocator(16, 8, max_slots=4)
    jn = jnative.NativePageAllocator(16, 8, max_slots=4)
    assert nt.num_free() == py.num_free() == jn.num_free() == 16
    for slot, n in ((0, 20), (1, 9), (0, 33), (2, 200), (3, 8)):
        want = py.ensure(f"r{slot}", n)
        assert nt.ensure(slot, n) == jn.ensure(slot, n) == want
        assert nt.num_free() == jn.num_free() == py.num_free()
    assert nt.pages_of(0) == len(py.req_pages["r0"]) == 5
    assert nt.pages_of(2) == 0  # the failed grow rolled back
    bt = py.block_table(["r0", "r1", "missing", "r3"], 6)
    np.testing.assert_array_equal(nt.block_table([0, 1, -1, 3], 6), bt)
    np.testing.assert_array_equal(jn.block_table([0, 1, -1, 3], 6), bt)
    py.free("r0")
    nt.release(0)
    jn.release(0)
    assert nt.num_free() == jn.num_free() == py.num_free() == 16 - 3
    assert nt.ensure(2, 40) and py.ensure("r2", 40)
    np.testing.assert_array_equal(nt.block_table([2], 6),
                                  py.block_table(["r2"], 6))


def test_native_exhaustion():
    nt = native.NativePageAllocator(2, 8, max_slots=2)
    assert nt.ensure(0, 16)
    assert not nt.ensure(1, 8)
    nt.release(0)
    assert nt.ensure(1, 8)
    assert not nt.ensure(5, 8)  # an out-of-range slot fails cleanly


def test_native_backed_gives_back_handles():
    """A request whose first ensure fails keeps no handle, so deferred
    requests cannot exhaust the handles while pages are free."""
    a = NativeBackedPageAllocator(num_pages=4, page_size=8, max_slots=2)
    assert a.ensure("big", 24)
    for i in range(5):
        assert not a.ensure(f"deferred{i}", 40)
    assert a.ensure("small", 8)  # the second handle is still free
    assert not a.ensure("third", 8)  # both handles held
    a.free("big")
    assert a.ensure("third", 8) and a.num_free() == 2
    bt = a.block_table(["small", "gone", "third"], 3)
    assert (bt[1] == -1).all() and (bt[:, 0] >= 0).sum() == 2


@pytest.mark.parametrize(
    "prefix_cache,max_slots,env,want",
    [
        (True, 4, None, PrefixCachingAllocator),
        (False, 4, None, NativeBackedPageAllocator),
        (False, 0, None, PageAllocator),
        (False, 4, "0", PageAllocator),
        (True, 4, "0", PrefixCachingAllocator),
    ],
)
def test_make_allocator_choice(monkeypatch, prefix_cache, max_slots, env,
                               want):
    """The JAX order: prefix cache first, then native when the engine gives
    max_slots, then Python without it or under CHITU_TPU_NATIVE=0."""
    if env is None:
        monkeypatch.delenv("CHITU_TPU_NATIVE", raising=False)
    else:
        monkeypatch.setenv("CHITU_TPU_NATIVE", env)
    cache = PagedKVCache(1, 6, 8, 1, 32, max_slots=max_slots,
                         prefix_cache=prefix_cache)
    assert type(cache.allocator) is want


def test_failed_build_raises(tmp_path, monkeypatch):
    """No silent fallback: a hostops source that does not compile raises
    with the compiler's output, and only CHITU_TPU_NATIVE=0 picks the
    Python allocator (without building)."""
    (tmp_path / "hostops.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(cuda_build, "CSRC", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.delenv("CHITU_TPU_NATIVE", raising=False)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*\n.*error"):
        PagedKVCache(1, 6, 8, 1, 32, max_slots=4)
    monkeypatch.setenv("CHITU_TPU_NATIVE", "0")
    assert type(PagedKVCache(1, 6, 8, 1, 32, max_slots=4).allocator) is (
        PageAllocator)
    assert not list((tmp_path / "build").glob("hostops-*.so"))


# ---------------------------------------------------------------------------
# engines under KV pressure
# ---------------------------------------------------------------------------

TINY = [
    "models=micro-llama-debug", "infer.max_seq_len=128", "infer.max_reqs=4",
    "infer.page_size=16", "request.max_new_tokens=8",
    "infer.stop_with_eos=false",
]
PREEMPT_PROMPTS = [[300 + i, 301, 302, 303 + i] for i in range(3)]
FRAC_PROMPTS = [[300 + i, 301, 302, 303 + i] for i in range(4)]
FRAC = ["infer.max_seq_len=64", "infer.decode_window=4"]


@pytest.fixture(scope="module")
def roomy():
    """The JAX engine's roomy greedy runs of both prompt sets (24 and 44
    new tokens, one request at a time), and its f32 tree for the port."""
    jeng = JEngine(jload(overrides=TINY))
    tree = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jeng.params)
    jeng.params = jeng.executor.params = tree
    runs = {}
    for key, prompts, n in (("preempt", PREEMPT_PROMPTS, 24),
                            ("frac", FRAC_PROMPTS, 44)):
        runs[key] = []
        for pr in prompts:
            r = jeng.submit("", JSampleParams(temperature=0.0, max_new_tokens=n),
                            prompt_tokens=pr)
            jeng.run_until_complete()
            runs[key].append(list(r.async_stream.tokens))
    return runs, params_from_numpy(jax.tree_util.tree_map(np.asarray, tree))


def _port(tree, monkeypatch, allocator, *extra):
    if allocator == "python":
        monkeypatch.setenv("CHITU_TPU_NATIVE", "0")
    else:
        monkeypatch.delenv("CHITU_TPU_NATIVE", raising=False)
    eng = Engine(tload(overrides=TINY + list(extra)), device="cpu",
                 params=tree)
    want = NativeBackedPageAllocator if allocator == "native" else PageAllocator
    assert type(eng.cache.allocator) is want
    return eng


def _preempt_spy(eng, monkeypatch):
    calls = []
    real = eng.executor.preempt

    def preempt(t):
        calls.append(t.task_id)
        real(t)

    monkeypatch.setattr(eng.executor, "preempt", preempt)
    return calls


@pytest.mark.parametrize("allocator", ["native", "python"])
def test_preemption_under_kv_pressure(roomy, monkeypatch, allocator):
    """Three requests of 4 + 24 tokens (2 pages each) in a 4-page pool:
    when the rows cross their first page together the newest is preempted
    (pages freed, context rebuilt later), and every request still
    finishes with the JAX engine's unpressured greedy tokens. (At 5
    pages, the JAX test's pool, the third row only waits: a row is
    preempted only for an older one.)"""
    runs, tree = roomy
    tight = _port(tree, monkeypatch, allocator, "infer.max_seq_len=64",
                  "infer.decode_window=4")
    tight.cache.allocator = (
        NativeBackedPageAllocator(4, 16, 4) if allocator == "native"
        else PageAllocator(4, 16)
    )
    calls = _preempt_spy(tight, monkeypatch)
    p = SampleParams(temperature=0.0, max_new_tokens=24)
    reqs = [tight.submit("", p, prompt_tokens=pr) for pr in PREEMPT_PROMPTS]
    tight.run_until_complete(max_steps=2000)
    assert [list(r.async_stream.tokens) for r in reqs] == runs["preempt"]
    assert calls, "the 4-page pool never preempted"
    assert tight.cache.allocator.num_free() == 4


@pytest.mark.parametrize("allocator", ["native", "python"])
def test_kv_pool_frac_underprovisions_and_still_serves(roomy, monkeypatch,
                                                       allocator):
    """infer.kv_pool_frac=0.3: a 6-page pool for four requests that grow
    to 3 pages each; admission reserves 1, so residents outgrow the pool
    mid-decode, preemption fires, and every request completes with the
    JAX engine's roomy tokens."""
    runs, tree = roomy
    tight = _port(tree, monkeypatch, allocator, *FRAC,
                  "infer.kv_pool_frac=0.3")
    assert tight.cache.num_pages == 6
    calls = _preempt_spy(tight, monkeypatch)
    p = SampleParams(temperature=0.0, max_new_tokens=44)
    reqs = [tight.submit("", p, prompt_tokens=pr) for pr in FRAC_PROMPTS]
    tight.run_until_complete(max_steps=4000)
    assert [list(r.async_stream.tokens) for r in reqs] == runs["frac"]
    assert calls, "the under-provisioned pool never preempted"
    assert tight.cache.allocator.num_free() == 6 and len(tight.pool) == 0


def test_spec_decode_completes_near_max_seq_len(roomy, monkeypatch):
    """Rows too close to max_seq_len for K+1 verify columns take the
    windowed path and still finish (a spec-only branch would spin)."""
    _, tree = roomy
    eng = _port(tree, monkeypatch, "native", "infer.spec_decode=ngram",
                "infer.spec_k=4")
    prompt = list(range(5, 5 + 122))  # max_seq_len 128: 6 tokens of room
    r = eng.submit("", SampleParams(temperature=0.0, max_new_tokens=5),
                   prompt_tokens=prompt)
    steps = 0
    while len(eng.pool) and steps < 200:
        eng.step()
        steps += 1
    assert steps < 200, "engine spun without progress"
    assert len(r.async_stream.tokens) == 5
    assert eng.cache.allocator.num_free() == eng.cache.num_pages
