"""Data parallelism of the port with the ring KV pool and ring prefill,
on the CPU. The counterparts of tests/test_ring_kv.py,
tests/test_ring_attention.py and tests/test_parallel.py:45
(`test_dp2_tp4_batch`).

Op level, in one process: the port's per-rank functions run for each of
4 stripes of a pool and are combined by the plain combine
(`attention_ring.combine_parts`), or, for ring attention, passed around
a ring simulated in the process; held against the JAX package's
shard_map ops on 4 virtual CPU devices (1e-4, appends bit-equal) and
the replicated jnp oracle. The split decode's partials mode in plain
PyTorch equals the unmasked split decode on unmasked tables, and merged
over the stripes' masked tables it equals the whole-pool decode.

Engine level, four worlds of `tests/torch_tp_world.py` ranks started
together (dp 2 over 2 ranks; dp 2 x tp 2, dp 2 x pp 2 and dp 4 over 4
each; gloo over `file://` rendezvous), on f32 trees drawn by the JAX models: greedy
tokens equal the port's one-rank engine's and the JAX one-device
engine's; each rank's pool bytes are total / dp under the ring pool and
total (/ tp, / pp) without it. Covered: dp 2 ring KV with chunked
prefill and a burst, ring prefill of whole prompts (Llama and Mixtral),
Mixtral's and DeepSeek's ring pools with the MoE token split, dp without a ring
(the replicated batch, as `test_dp2_tp4_batch`), dp 2 x tp 2 and dp 2 x
pp 2 ring KV, ring prefill at dp 2 x pp 2 (since slice 18), and four
replicas (ring KV, ring prefill); a perplexity
measured by rank 0 of the dp 2 (Llama, DeepSeek) and dp 2 x pp 2 worlds
equals the one-rank engine's.
"""

import functools
import logging
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chitu_tpu.ops import attention as jattn
from chitu_tpu.ops import attention_ring as jring
from chitu_tpu.parallel import make_mesh
from chitu_tpu.parallel.ring import ring_attention as jring_attention
from chitu_tpu_torch import SampleParams, evals, load_config
from chitu_tpu_torch.engine import Engine
from chitu_tpu_torch.ops import attention as tattn
from chitu_tpu_torch.ops import attention_kernels as tk
from chitu_tpu_torch.ops import attention_ring as tring
from chitu_tpu_torch.parallel import ring as tring_prefill
from chitu_tpu_torch.utils import get_logger

from test_torch_tp import (  # noqa: F401
    _jax_op_impl_auto,
    _jax_tokens,
    _join,
    _one_torch_thread,
    _port,
    _port_tokens,
    _spawn,
    _tree,
)
import test_torch_ep as ep
from test_torch_ep import DEEPSEEK, MIXTRAL
from torch_tp_world import save_tree

NEEDS4 = pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 devices")
TOL = 1e-4


def _mesh4():
    return make_mesh(dp=4, devices=jax.devices()[:4])


def _stripes(pool, n=4):
    """The n ranks' local pools of a global pool [L, P, page, M]."""
    pl = pool.shape[1] // n
    return [pool[:, r * pl:(r + 1) * pl].clone() for r in range(n)]


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(np.asarray(a, np.float32) if dtype else a))
    return t if dtype is None else t.to(dtype)


def _decode_inputs(seed=0):
    """The JAX ring tests' decode geometry: 8 pages of 16 striped over 4
    (2 a stripe), rows whose pages fall on several stripes, a padding
    column (-1), GQA 4 / 2."""
    L, P, page, KV, D, H, B = 2, 8, 16, 2, 32, 4, 3
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal((L, P, page, 2 * KV * D)).astype(np.float32)
    pool = np.asarray(jnp.asarray(pool).astype(jnp.bfloat16).astype(jnp.float32))
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    bt = np.asarray([[0, 3, 5, -1], [1, 2, -1, -1], [4, 6, 7, 2]], np.int32)
    seq = np.asarray([40, 17, 33], np.int32)
    return dict(L=L, P=P, page=page, KV=KV, D=D, H=H, B=B, pool=pool, q=q,
                bt=bt, seq=seq)


@NEEDS4
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (24, 0.0), (0, 8.0),
                                            (24, 8.0)])
def test_ring_decode_matches_jax_and_oracle(window, softcap):
    g = _decode_inputs()
    jpool = jnp.asarray(g["pool"]).astype(jnp.bfloat16)
    args = (jnp.int32(1), jnp.asarray(g["bt"]), jnp.asarray(g["seq"]),
            g["page"], g["KV"], g["D"], True)
    want_ring = jring.attend_decode_ring(
        jnp.asarray(g["q"]), jpool, *args, mesh=_mesh4(), window=window,
        softcap=softcap)
    want_oracle = jattn.attend_decode(
        jnp.asarray(g["q"]), jpool, *args, impl="xla", window=window,
        softcap=softcap)
    pool = _t(g["pool"], torch.bfloat16)
    parts = [tring.decode_ring_partials(
        _t(g["q"]), s, 1, _t(g["bt"]), _t(g["seq"]), g["page"], g["KV"],
        g["D"], True, None, window, softcap, idx=r)
        for r, s in enumerate(_stripes(pool))]
    got = tring.combine_parts(parts).reshape(g["B"], g["H"], g["D"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ring), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_oracle), atol=TOL,
                               rtol=TOL)
    # one stripe alone combined by itself is its own normalized partial
    m, l, acc = parts[0]
    one = tring._combine(m, l, acc, None)
    torch.testing.assert_close(one, acc / l.clamp_min(1e-30)[..., None])


@NEEDS4
def test_ring_appends_are_owner_writes():
    """append_decode_ring and append_prefill_ring through each stripe's
    local table: the stripes joined equal the JAX shard_map appends and
    the plain appends on the whole pool, bit for bit."""
    L, P, page, KV, D, B = 1, 8, 16, 2, 32, 2
    M = 2 * KV * D
    rng = np.random.default_rng(3)
    k = rng.standard_normal((B, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, KV, D)).astype(np.float32)
    bt = np.asarray([[2, 5, -1, -1], [7, 1, 3, -1]], np.int32)
    seq = np.asarray([17, 35], np.int32)
    valid = np.asarray([True, True])
    jpool = jnp.zeros((L, P, page, M), jnp.bfloat16)
    want = jring.append_decode_ring(
        jpool, jnp.int32(0), jnp.asarray(k).astype(jnp.bfloat16),
        jnp.asarray(v).astype(jnp.bfloat16), jnp.asarray(bt),
        jnp.asarray(seq), jnp.asarray(valid), page, _mesh4())
    stripes = _stripes(torch.zeros((L, P, page, M), dtype=torch.bfloat16))
    kt, vt = _t(k, torch.bfloat16), _t(v, torch.bfloat16)
    for r, s in enumerate(stripes):
        tring.append_decode_ring(s, 0, kt, vt, _t(bt), _t(seq), _t(valid),
                                 page, idx=r)
    got = torch.cat(stripes, dim=1)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    whole = torch.zeros((L, P, page, M), dtype=torch.bfloat16)
    tattn.append_decode(whole, 0, kt, vt, _t(bt), _t(seq), _t(valid), page)
    assert torch.equal(got, whole)

    # a prefill chunk of 20 rows at positions 12..31 over pages 2 and 5
    T = 24
    kp = rng.standard_normal((T, KV, D)).astype(np.float32)
    vp = rng.standard_normal((T, KV, D)).astype(np.float32)
    pos = np.arange(12, 12 + T, dtype=np.int32)
    want = jring.append_prefill_ring(
        jpool, jnp.int32(0), jnp.asarray(kp).astype(jnp.bfloat16),
        jnp.asarray(vp).astype(jnp.bfloat16), jnp.asarray(bt[0]),
        jnp.asarray(pos), 20, page, _mesh4())
    stripes = _stripes(torch.zeros((L, P, page, M), dtype=torch.bfloat16))
    for r, s in enumerate(stripes):
        tring.append_prefill_ring(s, 0, _t(kp, torch.bfloat16),
                                  _t(vp, torch.bfloat16), _t(bt[0]), _t(pos),
                                  20, page, idx=r)
    got = torch.cat(stripes, dim=1)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@NEEDS4
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (12, 5.0)])
def test_ring_prefill_chunk_matches_jax(window, softcap):
    """A chunk of 20 queries at positions 20..39 against a context of 40
    on pages striped over 4 (the chunked prefill of the ring pool)."""
    g = _decode_inputs(seed=4)
    T, start, total = 24, 20, 40
    rng = np.random.default_rng(5)
    q = rng.standard_normal((T, g["H"], g["D"])).astype(np.float32)
    bt = np.asarray([7, 0, 5, -1], np.int32)
    pos = np.where(np.arange(T) < total - start, np.arange(T) + start, 0)
    pos = pos.astype(np.int32)
    jpool = jnp.asarray(g["pool"]).astype(jnp.bfloat16)
    args = (jnp.int32(0), jnp.asarray(bt), jnp.asarray(pos), jnp.int32(total),
            g["page"], g["KV"], g["D"], True)
    want = jring.attend_prefill_ring(jnp.asarray(q), jpool, *args,
                                     mesh=_mesh4(), window=window,
                                     softcap=softcap)
    oracle = jattn.attend_prefill(jnp.asarray(q), jpool, *args, impl="xla",
                                  window=window, softcap=softcap)
    pool = _t(g["pool"], torch.bfloat16)
    parts = [tring.prefill_ring_partials(
        _t(q), s, 0, _t(bt), _t(pos), total, g["page"], g["KV"], g["D"],
        True, None, window, softcap, idx=r, q_tile=7)
        for r, s in enumerate(_stripes(pool))]
    got = tring.combine_parts(parts).reshape(T, g["H"], g["D"]).numpy()
    n = total - start
    np.testing.assert_allclose(got[:n], np.asarray(want)[:n], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got[:n], np.asarray(oracle)[:n], atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("window,softcap,fp8", [(0, 0.0, False), (12, 5.0, False),
                                                (0, 0.0, True)])
def test_fresh_chunk_equals_ring_prefill(window, softcap, fp8):
    """A chunk that starts its sequence attends its own rows on every rank
    (`attend_prefill_fresh`, no exchange): the ring prefill's result over
    the 4 stripes after the owner-write appends (an e4m3 pool read back
    through its encoding)."""
    g = _decode_inputs(seed=6)
    T, n = 24, 21
    rng = np.random.default_rng(6)
    q, k, v = (_t(rng.standard_normal((T, h, g["D"])), torch.float32)
               for h in (g["H"], g["KV"], g["KV"]))
    bt = torch.tensor([6, 1, 4, -1], dtype=torch.int32)
    pos = torch.arange(T, dtype=torch.int32)
    q_pos = torch.where(pos < n, pos, torch.zeros_like(pos))
    dtype = torch.int8 if fp8 else torch.bfloat16
    stripes = _stripes(torch.zeros((1, g["P"], g["page"], 2 * g["KV"] * g["D"]),
                                   dtype=dtype))
    for r, s in enumerate(stripes):
        tring.append_prefill_ring(s, 0, k, v, bt, pos, n, g["page"], idx=r)
    parts = [tring.prefill_ring_partials(
        q, s, 0, bt, q_pos, n, g["page"], g["KV"], g["D"], True, None, window,
        softcap, idx=r) for r, s in enumerate(stripes)]
    want = tring.combine_parts(parts).reshape(T, g["H"], g["D"])
    got = tring.attend_prefill_fresh(q, k, v, q_pos, n, dtype, None, window,
                                     softcap)
    torch.testing.assert_close(got[:n], want[:n], atol=TOL, rtol=TOL)


class _SimRing:
    """A dp group of n replicas simulated in one process for
    `ring_attention`: rank `rank`'s `pass_on` hands it the slice its
    predecessor holds at that step (the packed buffers of every rank,
    given up front)."""

    def __init__(self, bufs, rank):
        self.size, self.rank, self.bufs, self.step = len(bufs), rank, bufs, 0

    def pass_on(self, held, incoming):
        self.step += 1
        incoming.copy_(self.bufs[(self.rank - self.step) % self.size])
        return incoming


@NEEDS4
@pytest.mark.parametrize("KV,H,n", [(4, 8, 64), (2, 2, 64), (4, 4, 40)])
def test_ring_attention_matches_jax(KV, H, n):
    """The port's ring attention on each of 4 slices, the ring simulated
    in process, against the JAX shard_map ring and the causal oracle;
    n < 64 leaves padding rows (pos -1) that attend nothing and are
    attended by nothing. Every slice reaches each rank's `on_block`, its
    own first."""
    from jax.sharding import Mesh

    from chitu_tpu.models.common import grouped_attention

    T, D = 64, 64
    rng = np.random.default_rng(KV * 10 + H)
    q, k, v = (rng.standard_normal((T, h, D)).astype(np.float32) * 0.5
               for h in (H, KV, KV))
    pos = np.where(np.arange(T) < n, np.arange(T), -1).astype(np.int32)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(4), ("sp",))
    want = np.asarray(jring_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(pos), mesh,
                                      axis="sp"))
    cols = np.arange(n)[None, :]
    oracle = np.asarray(grouped_attention(
        jnp.asarray(q[:n]), jnp.asarray(k[:n]), jnp.asarray(v[:n]),
        jnp.asarray(cols <= np.arange(n)[:, None])))
    Tl = T // 4
    sl = [slice(r * Tl, (r + 1) * Tl) for r in range(4)]
    bufs = [tring_prefill._pack(_t(k[s]), _t(v[s]), _t(pos[s])) for s in sl]
    got, seen = [], []
    for r in range(4):
        blocks = []
        out = tring_prefill.ring_attention(
            _t(q[sl[r]]), _t(k[sl[r]]), _t(v[sl[r]]), _t(pos[sl[r]]),
            _SimRing(bufs, r),
            on_block=lambda kb, vb, pb: blocks.append(int(pb.max())))
        got.append(out.numpy())
        seen.append(blocks)
    got = np.concatenate(got)
    np.testing.assert_allclose(got[:n], want[:n], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got[:n], oracle, atol=TOL, rtol=TOL)
    last = [int(pos[s].max()) for s in sl]
    for r in range(4):
        assert seen[r] == [last[(r - i) % 4] for i in range(4)]


def test_masked_partials_plain_equals_unmasked():
    """The plain partials mode of the split decode: on an unmasked table,
    merged, it equals the unmasked split decode (`attend_decode_split_plain`,
    the same S and chunk); on the stripes' local tables (other stripes'
    pages masked), its partials joined over the stripes and merged equal
    the whole pool's decode; an all-masked row merges to 0."""
    g = _decode_inputs(seed=7)
    pool = _t(g["pool"], torch.bfloat16)
    q = _t(g["q"], torch.bfloat16)
    bt = torch.tensor([[0, 3, 5, 1], [1, 2, 6, 4], [4, 6, 7, 2]], dtype=torch.int32)
    seq = _t(g["seq"])
    kw = dict(kv_heads=g["KV"], head_dim=g["D"])
    S, chunk = 2, 32
    o, ml = tk.attend_decode_partials_plain(
        q, pool, 1, None, None, bt, seq, None, g["page"], fused=False, S=S,
        chunk=chunk, **kw)
    assert o.shape == (g["B"], g["KV"], S, g["H"] // g["KV"], g["D"])
    got = tk.decode_merge(o, ml)
    want = tk.attend_decode_split_plain(q, pool, 1, bt, seq, g["page"],
                                        g["KV"], g["D"], S, chunk)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    # the 4 stripes' masked partials, joined on the split axis
    pl = g["P"] // 4
    parts = []
    for r, s in enumerate(_stripes(pool)):
        lbt = tring.ring_local_block_table(bt, pl, r)
        parts.append(tk.attend_decode_partials_plain(
            q, s, 1, None, None, lbt, seq, None, g["page"], fused=False,
            **kw))
    o = torch.cat([p[0] for p in parts], dim=2)
    ml = torch.cat([p[1] for p in parts], dim=2)
    merged = tk.decode_merge(o, ml, torch.float32)
    whole = tattn.attend_decode(q.float(), pool, 1, bt, seq, g["page"],
                                g["KV"], g["D"])
    torch.testing.assert_close(merged, whole, atol=TOL, rtol=TOL)
    none = torch.full_like(bt, -1)
    o, ml = tk.attend_decode_partials_plain(
        q, pool, 1, None, None, none, seq, None, g["page"], fused=False, **kw)
    assert torch.equal(tk.decode_merge(o, ml).float(),
                       torch.zeros((g["B"], g["H"], g["D"])))


def test_fused_partials_append_only_owned_pages():
    """The fused partials mode on a local table appends a row's new token
    only where its page is the rank's own, and counts it only there."""
    g = _decode_inputs(seed=9)
    pool = _t(g["pool"], torch.bfloat16)
    q = _t(g["q"], torch.bfloat16)
    rng = np.random.default_rng(9)
    k = _t(rng.standard_normal((g["B"], g["KV"], g["D"])), torch.bfloat16)
    v = _t(rng.standard_normal((g["B"], g["KV"], g["D"])), torch.bfloat16)
    bt = _t(g["bt"])
    seq = _t(g["seq"])
    valid = torch.ones((g["B"],), dtype=torch.bool)
    whole = pool.clone()
    want = tk.attend_decode_fused_plain(q.float(), whole, 1, k, v, bt, seq,
                                        valid, g["page"], g["KV"], g["D"])
    stripes = _stripes(pool)
    pl = g["P"] // 4
    parts = [tk.attend_decode_partials_plain(
        q, s, 1, k, v, tring.ring_local_block_table(bt, pl, r), seq, valid,
        g["page"], g["KV"], g["D"]) for r, s in enumerate(stripes)]
    assert torch.equal(torch.cat(stripes, dim=1), whole)
    merged = tk.decode_merge(torch.cat([p[0] for p in parts], 2),
                             torch.cat([p[1] for p in parts], 2), torch.float32)
    torch.testing.assert_close(merged, want, atol=TOL, rtol=TOL)


class _Stacked:
    """The dp group of n stripes run one after another in one process:
    `gather` keeps the stripe's payload and answers with every stripe's,
    as the last pass kept them (zeros for a stripe not yet seen)."""

    def __init__(self, rank, payloads, n):
        self.rank, self.payloads, self.n = rank, payloads, n

    def gather(self, x):
        self.payloads[self.rank] = x.clone()
        return torch.stack([self.payloads.get(r, torch.zeros_like(x))
                            for r in range(self.n)])


def test_ring_decode_merges_every_split_of_every_rank():
    """The split layout's ring decode (`attend_decode_fused_ring`) gathers
    each rank's raw split partials [B, KV, S, G, D + 2] and merges the
    dp x S splits in one decode merge: at S = 2 a stripe it equals the
    whole pool's fused decode on every rank, and each rank appends only
    the rows of its own pages."""
    g = _decode_inputs(seed=11)
    pool = _t(g["pool"], torch.bfloat16)
    q = _t(g["q"], torch.float32)
    rng = np.random.default_rng(11)
    k, v = (_t(rng.standard_normal((g["B"], g["KV"], g["D"])), torch.bfloat16)
            for _ in range(2))
    bt, seq = _t(g["bt"]), _t(g["seq"])
    valid = torch.ones((g["B"],), dtype=torch.bool)
    whole = pool.clone()
    want = tk.attend_decode_fused_plain(q, whole, 1, k, v, bt, seq, valid,
                                        g["page"], g["KV"], g["D"])
    S = 2
    attn = types.SimpleNamespace(
        attend_decode_partials=functools.partial(
            tk.attend_decode_partials_plain, S=S, chunk=32),
        decode_merge=tk.decode_merge)
    stripes, payloads = _stripes(pool), {}

    def run(pools):
        return [tring.attend_decode_fused_ring(
            attn, q, p, 1, k, v, bt, seq, valid, g["page"], g["KV"], g["D"],
            group=_Stacked(r, payloads, len(pools)))
            for r, p in enumerate(pools)]

    run([s.clone() for s in stripes])  # every stripe's payload, kept
    outs = run(stripes)
    G = g["H"] // g["KV"]
    assert payloads[0].shape == (g["B"], g["KV"], S, G, g["D"] + 2)
    for out in outs:
        torch.testing.assert_close(out, want, atol=TOL, rtol=TOL)
    assert torch.equal(torch.cat(stripes, dim=1), whole)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_dp_configurations_serve_or_refuse_as_jax():
    """One process: dp_size=2 asks for its ranks; ring_kv and ring_prefill
    at dp 1 serve the default tokens (ring_kv with the JAX engine's
    warning); the JAX engine's ring ValueErrors."""
    base = ["models=micro-llama-debug", "infer.max_seq_len=128",
            "infer.max_reqs=4", "infer.page_size=16"]
    with pytest.raises(ValueError, match="num_processes=2"):
        Engine(load_config(overrides=base + ["infer.dp_size=2"]), device="cpu")
    greedy = SampleParams(temperature=0.0, max_new_tokens=6)
    want = Engine(load_config(overrides=base), device="cpu").generate(
        "hello", greedy)
    log = get_logger()
    for ovr in ("infer.ring_kv=true", "infer.ring_prefill=true"):
        rec = _Records()
        log.addHandler(rec)
        try:
            eng = Engine(load_config(overrides=base + [ovr]), device="cpu")
        finally:
            log.removeHandler(rec)
        assert eng.generate("hello", greedy) == want
        assert eng.executor.ring_kv_axis == ""
        warned = "ring_kv requested but dp_size <= 1; disabled" in rec.lines
        assert warned == (ovr == "infer.ring_kv=true")
    for ovr, match in (
            (["infer.ring_prefill=true"], "both ride the 'dp' axis"),
            (["infer.pp_size=3", "models.n_layers=2"], "n_layers divisible")):
        cfg = load_config(overrides=base + ["infer.dp_size=2",
                                            "infer.ring_kv=true"] + ovr)
        with pytest.raises(ValueError, match=match):
            Engine(cfg, device="cpu")


# ---------------------------------------------------------------------------
# engine level: gloo worlds
# ---------------------------------------------------------------------------

rng = np.random.default_rng(16)
PROMPTS = [rng.integers(1, 512, n).tolist() for n in (9, 40, 21, 33)]
NEW = [6, 6, 6, 6]
LONG = rng.integers(1, 512, 70).tolist()  # 5 chunks of 16
RP = [rng.integers(1, 512, n).tolist() for n in (61, 19)]  # whole-prompt rings
DP2 = ["infer.dp_size=2"]
PP2 = ["infer.pp_size=2"]
RKV = DP2 + ["infer.ring_kv=true"]
CHUNK = ["infer.prefill_chunk=16"]
RP_MIX = [rng.integers(1, 1024, n).tolist() for n in (37, 20)]
PPL = dict(tokens=rng.integers(1, 512, 60).tolist(), window=32, stride=20)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The three worlds' results beside their references: the JAX
    one-device engine's tokens and the port's one-rank engine's."""
    from test_torch_tp import BASE

    jm, U = _tree(["infer.merge_qkv_gate_up=off"])
    mix_tree = ep._jax_tree(MIXTRAL, 7)
    ds_tree = ep._jax_tree(DEEPSEEK, 8)
    d2, dtp, dpp, d4 = (tmp_path_factory.mktemp(n)
                        for n in ("dp2", "dp2tp2", "dp2pp2", "dp4"))
    paths = {}
    for k, t in (("U", U), ("mix", mix_tree), ("ds", ds_tree)):
        paths[k] = str(d2 / f"{k}.npz")
        save_tree(t, paths[k])
    off = ["infer.merge_qkv_gate_up=off"]
    sc2 = [
        dict(name="ring_kv", overrides=BASE + off + RKV + CHUNK,
             tree=paths["U"], prompts=PROMPTS + [LONG], new=NEW + [6],
             ppl=PPL),
        dict(name="ring_prefill", overrides=BASE + off + DP2 + [
            "infer.ring_prefill=true", "infer.prefill_chunk=128"],
            tree=paths["U"], prompts=RP, new=[6, 6], one_by_one=True),
        dict(name="replicas", overrides=BASE + off + DP2, tree=paths["U"],
             prompts=PROMPTS, new=NEW),
        dict(name="ds_ring_kv", overrides=DEEPSEEK + RKV, tree=paths["ds"],
             prompts=ep.PROMPTS, new=ep.NEW, nocap=True, ppl=PPL),
        dict(name="mix_ring_kv", overrides=MIXTRAL + RKV, tree=paths["mix"],
             prompts=ep.PROMPTS, new=ep.NEW, nocap=True),
        dict(name="mix_ring_prefill", overrides=MIXTRAL + DP2 + [
            "infer.ring_prefill=true", "infer.prefill_chunk=128"],
            tree=paths["mix"], prompts=RP_MIX, new=[5, 5], one_by_one=True,
            nocap=True),
    ]
    stp = [dict(name="ring_kv_tp2", overrides=BASE + off + RKV + CHUNK + [
        "infer.tp_size=2"], tree=paths["U"], prompts=PROMPTS, new=NEW)]
    spp = [dict(name="ring_kv_pp2", overrides=BASE + off + RKV + [
        "infer.pp_size=2"], tree=paths["U"], prompts=PROMPTS, new=NEW,
        ppl=PPL),
        dict(name="ring_prefill_pp2", overrides=BASE + off + DP2 + PP2 + [
            "infer.ring_prefill=true", "infer.prefill_chunk=128"],
            tree=paths["U"], prompts=RP, new=[6, 6], one_by_one=True)]
    dp4 = ["infer.dp_size=4"]
    s4 = [dict(name="ring_kv_dp4", overrides=BASE + off + dp4 + CHUNK + [
              "infer.ring_kv=true"], tree=paths["U"], prompts=PROMPTS, new=NEW),
          dict(name="ring_prefill_dp4", overrides=BASE + off + dp4 + [
              "infer.ring_prefill=true", "infer.prefill_chunk=128"],
              tree=paths["U"], prompts=RP, new=[6, 6], one_by_one=True)]
    t0 = time.time()
    p2 = _spawn(str(d2), 2, sc2, env_rendezvous=False)
    ptp = _spawn(str(dtp), 4, stp, env_rendezvous=True)
    ppp = _spawn(str(dpp), 4, spp, env_rendezvous=False)
    p4 = _spawn(str(d4), 4, s4, env_rendezvous=False)
    try:
        ref = dict(jax=_jax_tokens(off, U, PROMPTS, NEW),
                   jax_long=_jax_tokens(off + CHUNK, U, PROMPTS + [LONG],
                                        NEW + [6]),
                   jax_rp=_jax_tokens(off, U, RP, [6, 6]),
                   jax_rp_pp2=_jax_tokens(off + DP2 + PP2 + [
                       "infer.ring_prefill=true", "infer.prefill_chunk=128"],
                       U, RP, [6, 6]))
        one = _port(off, U)
        ref["port"] = _port_tokens(one, PROMPTS, NEW)
        ref["pool"] = one.cache.bytes()
        ref["ppl"] = evals.perplexity_from_tokens(one, **PPL)
        ref["port_long"] = _port_tokens(_port(off + CHUNK, U), PROMPTS + [LONG],
                                        NEW + [6])
        ref["port_rp"] = _port_tokens(_port(off + ["infer.prefill_chunk=128"], U),
                                      RP, [6, 6], one_by_one=True)
        ref["jax_ds"] = ep._jax_tokens(DEEPSEEK, ds_tree)
        ref["jax_mix"] = ep._jax_tokens(MIXTRAL, mix_tree)
        mix = ep._port(MIXTRAL, mix_tree)
        ref["mix_kv"], ref["mix_pool"] = ep._tokens(mix), mix.cache.bytes()
        ds = ep._port(DEEPSEEK, ds_tree)
        ref["ds"], ref["ds_pool"] = ep._tokens(ds), ds.cache.bytes()
        ref["ds_ppl"] = evals.perplexity_from_tokens(ds, **PPL)
        ref["mix"] = _port_tokens(
            ep._port(MIXTRAL + ["infer.prefill_chunk=128"], mix_tree), RP_MIX,
            [5, 5], one_by_one=True)
    finally:
        out = dict(dp2=_join(str(d2), p2), tp=_join(str(dtp), ptp),
                   pp=_join(str(dpp), ppp), dp4=_join(str(d4), p4))
    out["ref"] = ref
    out["seconds"] = time.time() - t0
    return out


def test_ring_kv_tokens_match_one_rank_and_jax(worlds):
    """dp 2 ring KV: prompts chunked by 16 (the 70-token one in 5 chunks,
    each reading the earlier chunks' pages from both ranks) and decoded
    as one burst; each rank holds 18 of the 36 pages."""
    ref = worlds["ref"]
    assert ref["jax"] == ref["port"]
    assert ref["jax_long"] == ref["port_long"]
    assert len({tuple(t) for t in ref["jax"]}) > 1
    ranks = worlds["dp2"]
    assert ranks[0]["ring_kv"]["tokens"] == ref["port_long"]
    for r in ranks:
        assert r["ring_kv"]["pool_bytes"] * 2 == ref["pool"]
        assert r["ring_kv"]["pools"]["kv"][1] * 2 == 36


def test_ring_prefill_tokens_match(worlds):
    ref = worlds["ref"]
    assert ref["jax_rp"] == ref["port_rp"]
    r0 = worlds["dp2"][0]
    assert r0["ring_prefill"]["tokens"] == ref["port_rp"]
    assert r0["ring_prefill"]["ring_prefills"] == 2
    assert r0["ring_prefill"]["pool_bytes"] == ref["pool"]  # replicated
    assert r0["mix_ring_prefill"]["tokens"] == ref["mix"]
    assert r0["mix_ring_prefill"]["ring_prefills"] == 2
    # four replicas: the prompts' buckets split four ways
    r4 = worlds["dp4"][0]["ring_prefill_dp4"]
    assert r4["tokens"] == ref["port_rp"] and r4["ring_prefills"] == 2
    # dp 2 x pp 2: each stage's replicas ring over their slice of the
    # prompt, the relay passes it on; the JAX engine's tokens at dp 2 x
    # pp 2 with ring prefill, the one-rank engine's, and each stage's pool
    # its layers' share
    assert ref["jax_rp_pp2"] == ref["port_rp"]
    for r in worlds["pp"]:
        res = r["ring_prefill_pp2"]
        assert res["ring_prefills"] == 2
        assert res["pool_bytes"] * 2 == ref["pool"]
    assert worlds["pp"][0]["ring_prefill_pp2"]["tokens"] == ref["port_rp"]


def test_deepseek_ring_kv_with_token_split(worlds):
    """DeepSeek's latent pools striped over dp 2 (each rank half of both),
    the MoE layer's tokens split over the replicas where they divide (a
    gather over the dp group each such call), the capacity route never
    taken: the one-rank engine's and the JAX engine's tokens."""
    ref = worlds["ref"]
    assert ref["ds"] == ref["jax_ds"]
    for r in worlds["dp2"]:
        res = r["ds_ring_kv"]
        assert res["pool_bytes"] * 2 == ref["ds_pool"]
        assert res["dp_gathers"] > 0
    assert worlds["dp2"][0]["ds_ring_kv"]["tokens"] == ref["ds"]


def test_mixtral_ring_kv(worlds):
    """Mixtral's pool striped over dp 2 (each rank half of it; its MoE
    layers split the tokens over the replicas where they divide): the
    one-rank engine's and the JAX engine's tokens."""
    ref = worlds["ref"]
    assert ref["mix_kv"] == ref["jax_mix"]
    for r in worlds["dp2"]:
        assert r["mix_ring_kv"]["pool_bytes"] * 2 == ref["mix_pool"]
    assert worlds["dp2"][0]["mix_ring_kv"]["tokens"] == ref["mix_kv"]


def test_replicas_without_ring(worlds):
    """dp 2 without a ring pool: each replica holds the whole pool and
    serves the batch (the JAX package's test_dp2_tp4_batch)."""
    ref = worlds["ref"]
    for r in worlds["dp2"]:
        assert r["replicas"]["pool_bytes"] == ref["pool"]
    assert worlds["dp2"][0]["replicas"]["tokens"] == ref["jax"]


@pytest.mark.parametrize("world,name", [("tp", "ring_kv_tp2"),
                                        ("pp", "ring_kv_pp2"),
                                        ("dp4", "ring_kv_dp4")])
def test_ring_kv_composes(worlds, world, name):
    """dp 2 x tp 2, dp 2 x pp 2 and dp 4: every rank's pool holds a
    quarter of the one-rank pool (pages over dp, KV heads over tp or
    layers over pp); rank 0's tokens equal the one-rank engine's."""
    ref = worlds["ref"]
    ranks = worlds[world]
    assert ranks[0][name]["tokens"] == ref["port"]
    for r in ranks:
        assert r[name]["pool_bytes"] * 4 == ref["pool"]


@pytest.mark.parametrize("world,name,want", [
    ("dp2", "ring_kv", "ppl"), ("dp2", "ds_ring_kv", "ds_ppl"),
    ("pp", "ring_kv_pp2", "ppl")])
def test_perplexity_under_dp(worlds, world, name, want):
    """`evals.perplexity_from_tokens` on rank 0 of a dp world (the ring
    pool's engines, DeepSeek's MoE token split among them): replica 0's
    ranks run the windows in pools of their own, without the replicas'
    collectives, and the number equals the one-rank engine's (1e-5)."""
    got, ref = worlds[world][0][name]["ppl"], worlds["ref"][want]
    assert abs(got - ref) / ref < 1e-5, (got, ref)
