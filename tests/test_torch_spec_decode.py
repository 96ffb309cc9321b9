"""N-gram speculative decoding in the port (`infer.spec_decode=ngram`):
the counterparts of tests/test_spec_decode.py, on the CPU.

Speculative greedy output is IDENTICAL to plain greedy output: drafts
change how many tokens one verify forward yields, never which. Held here:
the host proposer and the spec window's vectorized drafter (equal on
every context), `verify_draft` against the JAX model's on the same tree
and pool, the port's spec tokens against its plain decode and against the
JAX spec engine on the same f32 tree, budget and EOS truncation, the
fallback of sampled requests, a concurrent batch, a row that runs past
max_seq_len beside a live one, spec decode with the prefix cache on, and
DeepSeek (no `verify_draft`) serving through windows.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chitu_tpu.config import load_config as jload
from chitu_tpu.engine import Engine as JEngine
from chitu_tpu.models import build_model as jbuild
from chitu_tpu.task import SampleParams as JSampleParams
from chitu_tpu_torch import SampleParams
from chitu_tpu_torch.config import load_config as tload
from chitu_tpu_torch.engine import Engine
import chitu_tpu_torch.executor as ex_mod
from chitu_tpu_torch.executor import _draft, _ngram_propose
from chitu_tpu_torch.models import build_model as tbuild
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


TINY = [
    "models=micro-llama-debug", "infer.max_seq_len=128", "infer.max_reqs=4",
    "infer.page_size=16", "request.max_new_tokens=8",
    "infer.stop_with_eos=false",
]
SPEC = ["infer.spec_decode=ngram", "infer.spec_k=3"]


# ---------------------------------------------------------------------------
# the drafters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "ctx,k,want",
    [
        # trailing bigram (7, 8) occurred earlier; its continuation
        ([1, 7, 8, 9, 10, 11, 2, 3, 7, 8], 3, [9, 10, 11]),
        # no earlier occurrence: repeat the last token
        ([1, 2, 3, 4], 2, [4, 4]),
        # short context
        ([5], 3, [5, 5, 5]),
        # a continuation shorter than k pads with its last token
        ([7, 8, 9, 1, 7, 8], 4, [9, 1, 7, 8]),
    ],
)
def test_ngram_proposer(ctx, k, want):
    assert _ngram_propose(ctx, k) == want


@pytest.mark.parametrize("k", [1, 3, 4])
def test_device_drafter_matches_proposer(k):
    """The spec window's drafter over a padded [B, L] buffer equals the
    host proposer on every row: contexts of length 1 and 2, contexts with
    no repeated bigram, matches whose continuation runs into the
    context's end, several matches (the latest wins), and garbage past
    each row's length."""
    rng = np.random.default_rng(k)
    L = 48
    ctxs = [[5], [5, 6], [3, 3], [1, 2, 3, 4], [7, 8, 9, 1, 7, 8],
            [7, 8, 7, 8], [4, 4, 4, 4, 4]]
    for _ in range(120):
        n = int(rng.integers(1, L + 1))
        vocab = int(rng.choice([3, 5, 50]))  # small alphabets repeat bigrams
        ctxs.append(rng.integers(0, vocab, n).tolist())
    buf = rng.integers(0, 7, (len(ctxs), L)).astype(np.int32)
    for i, c in enumerate(ctxs):
        buf[i, : len(c)] = c
    got = _draft(
        torch.from_numpy(buf),
        torch.tensor([len(c) for c in ctxs], dtype=torch.int32), k,
    ).numpy()
    for i, c in enumerate(ctxs):
        assert got[i].tolist() == _ngram_propose(c, k), (c, got[i])


# ---------------------------------------------------------------------------
# verify_draft against the JAX model's
# ---------------------------------------------------------------------------

PAGE = 16
OVR = [
    "models=micro-llama-debug", "models.n_layers=2", "models.dim=256",
    "models.n_heads=4", "models.n_kv_heads=2", "models.head_dim=128",
    "models.inter_dim=512", "models.vocab_size=512",
    "infer.max_seq_len=128", "infer.page_size=16", "infer.max_reqs=4",
]


@pytest.mark.parametrize("impl,tol", [("xla", 1e-4), ("pallas", 5e-3)])
def test_verify_draft_matches_jax(impl, tol):
    """Three rows of K1 = 5 tokens (one row invalid) at contexts of 17,
    40 and 5 tokens over a pool of random context rows: the logits of
    every valid row and the pool after the call equal the JAX model's
    (xla: the jnp oracle, f32 on both sides; pallas: its kernels
    interpreted, which round q, K/V and probabilities to bf16), and so do
    the greedy tokens against the oracle (the port's are the argmax of its
    own logits in both cases)."""
    jcfg, tcfg = jload(overrides=OVR), tload(overrides=OVR)
    jm = jbuild(jcfg.models, jcfg)
    params = jm.init_params(jax.random.PRNGKey(2), jnp.float32)
    tm = tbuild(tcfg.models, tcfg, device="cpu")
    tm.load_params(params_from_numpy(jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.default_rng(5)
    pool = rng.standard_normal((2, 16, PAGE, 2 * 2 * 128)).astype(np.float32)
    B, K1, MP = 3, 5, 8
    tokens = rng.integers(1, 512, (B, K1)).astype(np.int32)
    seq_lens = np.array([17, 40, 5], np.int32)
    valid = np.array([True, True, False])
    bts = np.full((B, MP), -1, np.int32)
    bts[0, :2], bts[1, :3], bts[2, :1] = [3, 9], [0, 5, 12], [7]

    caught = {}

    def spy(name, fn):
        def run(*a):
            out = fn(*a)
            caught[name] = np.asarray(out)
            return out
        return run

    jm._logits = spy("jax", jm._logits)
    tm._logits = spy("torch", tm._logits)
    jg, jcache = jm.verify_draft(
        params, {"kv": jnp.asarray(pool)}, jnp.asarray(tokens),
        jnp.asarray(seq_lens), jnp.asarray(bts), jnp.asarray(valid), PAGE,
        attn_impl=impl,
    )
    tcache = {"kv": torch.from_numpy(pool.copy())}
    tg, _ = tm.verify_draft(
        tcache, *map(torch.from_numpy, (tokens, seq_lens, bts, valid)), PAGE
    )
    rows = np.repeat(valid, K1)
    np.testing.assert_allclose(caught["torch"][rows], caught["jax"][rows],
                               atol=tol, rtol=tol)
    assert tg.dtype == torch.int32 and tg.shape == (B, K1)
    np.testing.assert_array_equal(
        tg.numpy().reshape(-1), caught["torch"].argmax(-1))
    if impl == "xla":
        # the bf16 rounding of the interpreted kernels can flip a near tie
        np.testing.assert_array_equal(tg.numpy()[valid], np.asarray(jg)[valid])
    np.testing.assert_allclose(tcache["kv"].numpy(), np.asarray(jcache["kv"]),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# engines: the port's spec decode against its plain decode and the JAX spec
# engine, on one f32 tree
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    """(port plain, port spec, JAX spec), all on the JAX spec engine's
    own weights in f32."""
    jeng = JEngine(jload(overrides=TINY + SPEC))
    tree = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jeng.params)
    jeng.params = jeng.executor.params = tree
    tree = params_from_numpy(jax.tree_util.tree_map(np.asarray, tree))

    def port(*extra):
        return Engine(tload(overrides=TINY + list(extra)), device="cpu",
                      params=tree)

    return port(), port(*SPEC), jeng, port


def _gen(e, prompt_tokens, n_new, temp=0.0):
    req = e.submit(
        "", SampleParams(temperature=temp, max_new_tokens=n_new),
        prompt_tokens=prompt_tokens,
    )
    e.run_until_complete()
    return list(req.async_stream.tokens)


REPETITIVE = ([311, 412, 313, 414] * 6)[:24]


def test_spec_matches_plain_greedy_repetitive(engines):
    base, spec, _, _ = engines
    # greedy decode of a random-weight model loops, so n-gram drafts hit
    # often: the high-acceptance regime
    want = _gen(base, REPETITIVE, 16)
    before = list(spec.executor._spec_stats)
    got = _gen(spec, REPETITIVE, 16)
    assert got == want
    tok = spec.executor._spec_stats[0] - before[0]
    rounds = spec.executor._spec_stats[1] - before[1]
    assert rounds > 0
    assert tok / rounds > 1.5  # acceptance beats 1 token a round


def test_spec_matches_plain_greedy_random(engines):
    base, spec, _, _ = engines
    prompt = np.random.default_rng(7).integers(300, 500, 30).tolist()
    assert _gen(spec, prompt, 12) == _gen(base, prompt, 12)


def test_spec_tokens_match_jax_spec_engine(engines):
    """A burst of a looping and two random prompts, submitted together to
    the port's and the JAX package's spec engines on the same weights."""
    _, spec, jeng, _ = engines
    rng = np.random.default_rng(3)
    prompts = [REPETITIVE] + [rng.integers(300, 500, n).tolist()
                              for n in (30, 9)]
    jr = [jeng.submit("", JSampleParams(temperature=0.0, max_new_tokens=12),
                      prompt_tokens=p) for p in prompts]
    tr = [spec.submit("", SampleParams(temperature=0.0, max_new_tokens=12),
                      prompt_tokens=p) for p in prompts]
    jeng.run_until_complete()
    spec.run_until_complete()
    want = [list(r.async_stream.tokens) for r in jr]
    got = [list(r.async_stream.tokens) for r in tr]
    assert all(len(t) == 12 for t in got)
    assert got == want


def test_spec_budget_exact(engines):
    _, spec, _, _ = engines
    out = _gen(spec, ([321, 422] * 8)[:16], 7)
    assert len(out) == 7  # burst acceptance must not overshoot the budget


def test_spec_eos_truncation(engines):
    """stop_with_eos on: a stop token inside an accepted burst ends the
    stream there, as plain decode does."""
    port = engines[3]
    eb = port("infer.stop_with_eos=true")
    es = port("infer.stop_with_eos=true", *SPEC)
    for seed in range(3):
        prompt = np.random.default_rng(seed).integers(250, 260, 20).tolist()
        assert _gen(es, prompt, 12) == _gen(eb, prompt, 12)


def test_spec_falls_back_for_sampled(engines):
    _, spec, _, _ = engines
    # a sampled request takes the windowed path (stats unchanged)
    before = list(spec.executor._spec_stats)
    out = _gen(spec, [301, 302, 303] * 4, 6, temp=0.9)
    assert len(out) == 6
    assert spec.executor._spec_stats == before


def test_spec_concurrent_batch(engines):
    base, spec, _, _ = engines
    p = SampleParams(temperature=0.0, max_new_tokens=8)
    prompts = [([330 + i, 440 + i] * 10)[:20] for i in range(4)]
    want = [_gen(base, pr, 8) for pr in prompts]
    reqs = [spec.submit("", p, prompt_tokens=pr) for pr in prompts]
    spec.run_until_complete()
    assert [list(r.async_stream.tokens) for r in reqs] == want
    assert spec.cache.allocator.num_free() == spec.cache.num_pages
    assert len(spec.pool) == 0


def test_spec_with_prefix_cache(engines):
    """Both on: a shared 32-token prefix is hit, the tails verify in spec
    rounds, and the tokens equal plain decode's."""
    base, _, _, port = engines
    eng = port("infer.prefix_cache=true", *SPEC)
    shared = ([311, 412, 313, 414] * 8)[:32]
    prompts = [shared + [320 + i, 321, 322] for i in range(3)]
    want = [_gen(base, pr, 10) for pr in prompts]
    got = [_gen(eng, pr, 10) for pr in prompts]
    assert got == want
    assert eng.cache.allocator.hits == 4  # two pages, two warm requests
    assert eng.executor._spec_stats[1] > 0
    assert eng.cache.allocator.num_free() == eng.cache.num_pages


def test_spec_row_past_max_seq_len_beside_a_live_row(engines, monkeypatch):
    """max_seq_len 64, two looping streams that run to it: the first row's
    pages are capped at 64, it is live at 64 - K, accepts every draft plus
    the bonus (clen 65, one past the context buffer) and latches done while
    the second row is still live. The next round drafts for both; the done
    row's gathers stay inside the buffer, and both streams equal plain
    decode's, cut at max_seq_len."""
    port = engines[3]
    base = port("infer.max_seq_len=64")
    spec = port("infer.max_seq_len=64", *SPEC)
    past = []
    real = ex_mod._draft

    def draft(buf, clen, k):
        past.append(int(clen.max()) > buf.shape[1])
        return real(buf, clen, k)

    monkeypatch.setattr(ex_mod, "_draft", draft)
    prompts = [REPETITIVE[:16], [330, 440] * 4]
    want = [_gen(base, pr, 64) for pr in prompts]
    p = SampleParams(temperature=0.0, max_new_tokens=64)
    reqs = [spec.submit("", p, prompt_tokens=pr) for pr in prompts]
    spec.run_until_complete(max_steps=500)
    assert any(past), "no row ran past the buffer beside a live row"
    assert [list(r.async_stream.tokens) for r in reqs] == want
    assert spec.cache.allocator.num_free() == spec.cache.num_pages


def test_deepseek_spec_serves_through_windows():
    """DeepSeek has no `verify_draft`: with spec_decode=ngram it decodes in
    windows (no verify round) and its tokens equal the engine's without."""
    ds = ["models=tiny-deepseek-debug", "models.n_layers=2"] + TINY[1:]
    plain = Engine(tload(overrides=ds), device="cpu")
    spec = Engine(tload(overrides=ds + SPEC), device="cpu")
    prompt = ([311, 412, 313, 414] * 5)[:20]
    assert _gen(spec, prompt, 8) == _gen(plain, prompt, 8)
    assert spec.executor._spec_stats == [0, 0]
