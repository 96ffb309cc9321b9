"""The latent attention kernel's split decode, planned and computed on the
CPU: the split plan of `chitu_tpu_torch/ops/attention_kernels.py`
(`latent_split`, `_latent_plan`), a function of shapes alone, walked as
`csrc/attention.cu`'s `latent_kernel` walks it, and the plain split-plus-merge arithmetic
(`attend_decode_split_plain` with `split_kv=False`) held against the JAX
package's `attend_decode` and `attend_decode_fused` on the merged latent
row: the jnp oracle (`impl="xla"`) and the Pallas kernels in interpret
mode, as tests/test_torch_kv_fp8.py runs them, on bf16 and e4m3 pools.

The latent row here is tiny-deepseek-debug's: 64 value lanes + 16 rope
lanes = 80 live lanes in a 128-lane pool row (the JAX side reads all 128,
zero beyond 80). Tolerances: against the oracle 1e-4 (the same f32
values summed in another order, the splits merged in split order);
against the interpreted kernels 1e-2 (they round q and the probabilities
to bf16 for their dots). The e4m3 comparisons with the kernels feed the
port the pool and the new rows with subnormal codes flushed, the
kernels' own reading of them (as in tests/test_torch_kv_fp8.py).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chitu_tpu.models.common import kv_decode as jdecode
from chitu_tpu.models.common import kv_encode as jencode
from chitu_tpu.ops import attention as jattn
from chitu_tpu.ops import pallas_attention as pk
from chitu_tpu_torch.ops import attention as tattn
from chitu_tpu_torch.ops import attention_kernels as tk


@pytest.fixture(autouse=True)
def _jax_op_impl_auto():
    """The JAX op_impl switch at "auto" for each test (a JAX test in the
    same worker may leave it at "pallas")."""
    mod = importlib.import_module("chitu_tpu.ops.linear")
    old = mod._OP_IMPL
    mod._OP_IMPL = "auto"
    yield
    mod._OP_IMPL = old


SMS = 132  # an H100 SXM's SMs
TILE = tk.KEY_TILE


def latent_walk(s, S, chunk, seq_len, window=0):
    """The first key of each 64-key tile the latent decode block of split s
    walks for a row whose context is [0, seq_len] (the new token at
    seq_len), as `latent_kernel` walks them: from the window's start
    rounded down to a tile, within the split's positions; [] for a split
    past the context (that block exits at once)."""
    kend = seq_len + 1
    kstart = max(kend - window, 0) if window > 0 else 0
    kbeg, wend = kstart // TILE * TILE, kend
    if S > 1:
        kbeg, wend = max(kbeg, s * chunk), min(kend, (s + 1) * chunk)
    return list(range(kbeg, wend, TILE)) if wend > kbeg else []


# ---------------------------------------------------------------------------
# the split plan: shapes only
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,mp,page", [(16, 33, 64), (1, 257, 64), (5, 40, 16),
                                       (64, 129, 16)])
@pytest.mark.parametrize("H", [128, 32, 16])
def test_latent_split_covers_every_key(H, B, mp, page):
    """Every key position of a row's context (and its window) is walked by
    exactly one split, in whole 64-key tiles that start on a tile and lie
    inside their split's positions; the splits a row reaches are the ones
    the merge reads, and no trailing split is empty for a full table."""
    S, chunk = tk.latent_split(B, H, mp, page, SMS)
    keys = mp * page
    assert S >= 1 and chunk % TILE == 0
    assert (S - 1) * chunk < keys <= S * chunk
    tiles_a_row = -(-H // tk.LATENT_ROWS)
    if B * tiles_a_row >= tk.LATENT_BLOCKS_PER_SM * SMS:
        assert S == 1
    edges = {0, 1, TILE - 1, TILE, TILE + 1, keys - 1}
    edges |= {c for s in range(1, S) for c in (s * chunk - 1, s * chunk, s * chunk + 1)}
    for seq_len in sorted(e for e in edges if 0 <= e < keys):
        for window in (0, 40):
            kend = seq_len + 1
            kstart = max(kend - window, 0) if window else 0
            seen = np.zeros(keys + TILE, np.int64)
            live = []
            for s in range(S):
                walk = latent_walk(s, S, chunk, seq_len, window)
                if walk:
                    live.append(s)
                for t0 in walk:
                    assert t0 % TILE == 0
                    if S > 1:
                        assert s * chunk <= t0 < (s + 1) * chunk
                    seen[t0 : t0 + TILE] += 1
            # each context key once; nothing walked past the context's tile
            assert (seen[kstart:kend] == 1).all(), (seq_len, window)
            assert seen.max() == 1
            assert not seen[-(-kend // TILE) * TILE :].any()
            assert live == list(range(kstart // chunk, (kend - 1) // chunk + 1)) \
                or S == 1


def test_latent_plan_reads_shapes_only(monkeypatch):
    """The split and its scratch come from shapes alone: built from meta
    tensors, which hold no values (no host sync; a CUDA graph can capture
    the launch)."""
    monkeypatch.setattr(tk, "_sm_count", lambda dev: SMS)
    meta = dict(device="meta")
    q = torch.empty((16, 128, tk.LATENT_QK), dtype=torch.bfloat16, **meta)
    bt = torch.empty((16, 33), dtype=torch.int32, **meta)
    S, chunk, part_o, part_ml = tk._latent_plan(q, bt, 64)
    assert (S, chunk) == tk.latent_split(16, 128, 33, 64, SMS)
    assert S > 1
    assert part_o.numel() == 16 * S * 128 * tk.LATENT_DV
    assert part_ml.numel() == 16 * S * 128 * 2
    assert part_o.device.type == "meta"
    # enough rows to fill the card: no split, no scratch
    q = torch.empty((1024, 128, tk.LATENT_QK), dtype=torch.bfloat16, **meta)
    bt = torch.empty((1024, 33), dtype=torch.int32, **meta)
    S, _, part_o, part_ml = tk._latent_plan(q, bt, 64)
    assert S == 1 and part_o is None and part_ml is None


# ---------------------------------------------------------------------------
# the split arithmetic against the JAX package
# ---------------------------------------------------------------------------

PAGE, LAYER, H = 16, 1, 8
LIVE, DV, JD = 80, 64, 128  # live lanes, value lanes, the JAX row's lanes
B, MP = 5, 12  # 192 keys: splits of 64 keys are three
SCALE = 0.1
ORACLE_TOL = 1e-4
KERNEL_TOL = 1e-2


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _jencode(x):
    return np.asarray(jencode(jnp.asarray(x), jnp.int8))


def _ftz(codes):
    """The Pallas kernels' reading of e4m3 codes: subnormals as zero."""
    codes = np.array(codes, copy=True)
    codes[(codes.view(np.uint8) & 0x78) == 0] = 0
    return codes


def _ftz_vals(x):
    """Values whose encodes are the flushed codes of x's encodes."""
    return np.asarray(jdecode(jnp.asarray(_ftz(_jencode(x))), jnp.float32))


def _case(seed, kind):
    r = np.random.default_rng(seed)
    pool = (r.standard_normal((3, B * MP, PAGE, JD)) * 0.5).astype(np.float32)
    pool[..., LIVE:] = 0.0
    if kind == "e4m3":
        pool = _jencode(pool)
    q = (r.standard_normal((B, H, JD)) * 0.5).astype(np.float32)
    q[..., LIVE:] = 0.0
    k = (r.standard_normal((B, 1, LIVE)) * 0.5).astype(np.float32)
    bt = np.arange(B * MP, dtype=np.int32).reshape(B, MP)
    # contexts (the new token at seq): empty, a split's last key, one key
    # past a split boundary, the next, the whole table
    seq = np.array([0, TILE - 1, TILE, TILE + 1, MP * PAGE - 1], np.int32)
    return pool, q, k, bt, seq


def _split_plain(q, pool, bt, seq, S, chunk):
    return tk.attend_decode_split_plain(
        _t(q[..., :LIVE]), pool, LAYER, _t(bt), _t(seq), PAGE, 1, LIVE, S,
        chunk, scale=SCALE, split_kv=False, v_dim=DV)


@pytest.mark.parametrize("S,chunk", [(3, 64), (2, 128), (12, 16)])
@pytest.mark.parametrize("kind", ["bf16", "e4m3"])
def test_latent_split_decode_equals_jax(kind, S, chunk):
    """B4 on the latent row: the splits' partials merged in split order
    equal the JAX oracle and the interpreted `attend_decode`."""
    pool, q, k, bt, seq = _case(3, kind)
    tpool = _t(pool)
    tattn.append_decode(tpool, LAYER, _t(k), None, _t(bt), _t(seq),
                        torch.ones(B, dtype=torch.bool), PAGE)
    jpool = np.array(tpool.numpy(), copy=True)
    want_pool = jattn.append_decode(
        jnp.asarray(pool), jnp.int32(LAYER), jnp.asarray(k), None,
        jnp.asarray(bt), jnp.asarray(seq), jnp.ones(B, bool), PAGE)
    np.testing.assert_array_equal(jpool, np.asarray(want_pool))
    args = (jnp.asarray(q), jnp.asarray(jpool), jnp.int32(LAYER), jnp.asarray(bt),
            jnp.asarray(seq), PAGE, 1, JD)
    oracle = np.asarray(jattn.attend_decode(*args, impl="xla", split_kv=False,
                                            scale=SCALE))[..., :DV]
    kern = np.asarray(pk.attend_decode(*args, interpret=True, split_kv=False,
                                       scale=SCALE))[..., :DV]
    got = _split_plain(q, tpool, bt, seq, S, chunk)
    assert got.shape == (B, H, DV)
    np.testing.assert_allclose(got.numpy(), oracle, atol=ORACLE_TOL, rtol=ORACLE_TOL)
    fpool = _t(_ftz(jpool)) if kind == "e4m3" else tpool
    np.testing.assert_allclose(_split_plain(q, fpool, bt, seq, S, chunk).numpy(),
                               kern, atol=KERNEL_TOL, rtol=KERNEL_TOL)


@pytest.mark.parametrize("S,chunk", [(3, 64), (2, 128), (12, 16)])
@pytest.mark.parametrize("kind", ["bf16", "e4m3"])
def test_latent_split_fused_decode_equals_jax(kind, S, chunk):
    """B1 on the latent row: the plain append (the JAX bytes) then the
    split arithmetic equal the interpreted `attend_decode_fused` on the
    valid rows (its pool too), and the oracle after the JAX append."""
    pool, q, k, bt, seq = _case(4, kind)
    val = np.array([True, True, False, True, True])
    tpool = _t(pool)
    tattn.append_decode(tpool, LAYER, _t(k), None, _t(bt), _t(seq), _t(val), PAGE)
    kern, kpool = pk.attend_decode_fused(
        jnp.asarray(q), jnp.asarray(pool), jnp.int32(LAYER), jnp.asarray(k),
        None, jnp.asarray(bt), jnp.asarray(seq), jnp.asarray(val), PAGE, 1, JD,
        interpret=True, split_kv=False, scale=SCALE)
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(kpool))
    oracle = np.asarray(jattn.attend_decode(
        jnp.asarray(q), kpool, jnp.int32(LAYER), jnp.asarray(bt),
        jnp.asarray(seq), PAGE, 1, JD, impl="xla", split_kv=False,
        scale=SCALE))[..., :DV]
    got = _split_plain(q, tpool, bt, seq, S, chunk)
    np.testing.assert_allclose(got.numpy()[val], oracle[val], atol=ORACLE_TOL,
                               rtol=ORACLE_TOL)
    if kind == "e4m3":  # the kernel's reading: subnormal codes flushed
        fpool = _t(_ftz(pool))
        tattn.append_decode(fpool, LAYER, _t(_ftz_vals(k)), None, _t(bt),
                            _t(seq), _t(val), PAGE)
    else:
        fpool = tpool
    np.testing.assert_allclose(
        _split_plain(q, fpool, bt, seq, S, chunk).numpy()[val],
        np.asarray(kern)[..., :DV][val], atol=KERNEL_TOL, rtol=KERNEL_TOL)
