"""The CUDA kernels against their plain PyTorch versions on the card, at
small geometries beside the Llama-3-8B, Mixtral and DeepSeek ones
chip_smoke.py covers: head_dim 128, 1 to 8 query heads per KV head, pages
of 16 and 64, window and softcap; the other split head sizes (192 with one
query head per KV head, as DeepSeek's dense MLA; 64 and 32) and the int8
pools of e4m3 bits on every attention kernel, the appends fed ties,
subnormals, +-448, +-464 and values beyond; the MLA latent row (576 live
lanes, 512 value lanes) at 16, 32 and 128 heads; B9 at 4 and 32 heads, T 1
to 128; B13 at decode and slab row counts. Pool bytes must be
equal; every (token, head) output row must satisfy
||kernel - plain|| <= 1e-2 * ||plain|| in bf16 (the kernels sum in f32 in
another order; bf16 rounding alone leaves about 2e-3).

Needs an NVIDIA GPU: skipped elsewhere. On the card (no JAX there, so
without the suite's conftest):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from chitu_tpu_torch.ops import attention as plain
from chitu_tpu_torch.ops import attention_kernels as tk

pytestmark = pytest.mark.cuda
ROW_RTOL = 1e-2
GEOMS = [  # (H, KV, D, page)
    (8, 4, 128, 16), (4, 4, 128, 64), (16, 2, 128, 64), (6, 3, 128, 16),
]
WS = [(0, 0.0), (40, 0.0), (0, 20.0)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _gen(dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return lambda *s: torch.randn(s, generator=g, device=dev).to(torch.bfloat16)


def _pool(rand, KV, D, page, P):
    return rand(2, P, page, 2 * KV * D)


def _check(out_k, out_p, rows=None):
    a, b = out_k.float(), out_p.float()
    if rows is not None:
        a, b = a[rows], b[rows]
    assert torch.isfinite(a).all()
    rel = (a - b).norm(dim=-1) / b.norm(dim=-1).clamp_min(1e-30)
    assert rel.max().item() <= ROW_RTOL, rel.max().item()


@pytest.mark.parametrize("window,softcap", WS)
@pytest.mark.parametrize("H,KV,D,page", GEOMS)
def test_decode_fused(dev, H, KV, D, page, window, softcap):
    rand = _gen(dev, 0)
    B, mp = 5, 8
    pool = _pool(rand, KV, D, page, B * mp)
    bt = torch.arange(B * mp, device=dev, dtype=torch.int32).reshape(B, mp)
    seq = torch.tensor([0, 3, page, 3 * page + 5, mp * page - 1],
                       device=dev, dtype=torch.int32)
    valid = torch.tensor([True, True, False, True, True], device=dev)
    q, k, v = rand(B, H, D), rand(B, KV, D), rand(B, KV, D)
    pk, pp = pool.clone(), pool.clone()
    args = (1, k, v, bt, seq, valid, page, KV, D)
    kw = dict(window=window, softcap=softcap)
    n0 = tk.LAUNCHES["attend_decode_fused"]
    out_k = tk.attend_decode_fused(q, pk, *args, **kw)
    out_p = tk.attend_decode_fused_plain(q, pp, *args, **kw)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["attend_decode_fused"] == n0 + 1
    assert torch.equal(pk, pp)
    _check(out_k, out_p, valid)


@pytest.mark.parametrize("window,softcap", WS)
@pytest.mark.parametrize("H,KV,D,page", GEOMS)
def test_prefill(dev, H, KV, D, page, window, softcap):
    rand = _gen(dev, 1)
    mp, T, start = 16, 32, 40
    pool = _pool(rand, KV, D, page, mp + 4)
    bt = torch.arange(mp, device=dev, dtype=torch.int32) + 4
    q_pos = torch.arange(start, start + T, device=dev, dtype=torch.int32)
    q = rand(T, H, D)
    args = (pool, 1, bt, q_pos, start + T, page, KV, D)
    kw = dict(window=window, softcap=softcap)
    _check(tk.attend_prefill(q, *args, **kw), plain.attend_prefill(q, *args, **kw))


@pytest.mark.parametrize("window,softcap", WS)
@pytest.mark.parametrize("H,KV,D,page", GEOMS)
def test_prefill_packed_fused(dev, H, KV, D, page, window, softcap):
    rand = _gen(dev, 2)
    Tq, NB, mp = 16, 6, 8
    T = Tq * NB
    segs = [(0, 20), (page, 17), (0, 3)]  # (start, new tokens); a dead block
    bts = torch.full((4, mp), -1, device=dev, dtype=torch.int32)
    bseg = torch.full((NB,), -1, device=dev, dtype=torch.int32)
    bq = torch.zeros((NB,), device=dev, dtype=torch.int32)
    total = torch.zeros((4,), device=dev, dtype=torch.int32)
    live = torch.zeros((T,), device=dev, dtype=torch.bool)
    off = 0
    for r, (s, n) in enumerate(segs):
        bts[r] = torch.arange(r * mp, (r + 1) * mp, device=dev)
        nb = (n + Tq - 1) // Tq
        bseg[off // Tq : off // Tq + nb] = r
        bq[off // Tq : off // Tq + nb] = s + Tq * torch.arange(nb, device=dev)
        total[r] = s + n
        live[off : off + n] = True
        off += nb * Tq
    pool = _pool(rand, KV, D, page, 4 * mp)
    q, k, v = rand(T, H, D), rand(T, KV, D), rand(T, KV, D)
    pk, pp = pool.clone(), pool.clone()
    args = (1, k, v, bts, bseg, bq, total, page, KV, D)
    kw = dict(window=window, softcap=softcap)
    out_k = tk.attend_prefill_packed_fused(q, pk, *args, **kw)
    out_p = tk.attend_prefill_packed_fused_plain(q, pp, *args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(pk, pp)
    _check(out_k, out_p, live)
    dead = ~torch.repeat_interleave(bseg >= 0, Tq)
    assert out_k[dead].abs().max().item() == 0.0


def test_wrappers_reject_bad_inputs(dev):
    rand = _gen(dev, 3)
    pool = _pool(rand, 2, 128, 16, 8)
    q = rand(3, 4, 128)
    bt = torch.zeros((3, 2), device=dev, dtype=torch.int64)  # wrong dtype
    seq = torch.zeros((3,), device=dev, dtype=torch.int32)
    valid = torch.ones((3,), device=dev, dtype=torch.bool)
    k = rand(3, 2, 128)
    with pytest.raises(TypeError):
        tk.attend_decode_fused(q, pool, 0, k, k, bt, seq, valid, 16, 2, 128)
    with pytest.raises(NotImplementedError):  # head_dim 96 is not built
        tk.attend_decode_fused(
            rand(3, 4, 96), rand(2, 8, 16, 384), 0, rand(3, 2, 96),
            rand(3, 2, 96), bt.int(), seq, valid, 16, 2, 96,
        )


# ---------------------------------------------------------------------------
# The quantized GEMMs and the activation-quant kernels against their plain
# versions. Limits: every GEMM output row within 1e-2 of the plain row's
# norm (f32 sums in another order over bf16-rounded weights: about 1e-3);
# the int8 GEMM's int32 sums equal exactly; activation scales within 1e-6
# relative, int8 values equal but for at most 0.1 % that differ by 1 (a
# value on a rounding tie after a last-bit difference in the reduction).
# ---------------------------------------------------------------------------

from chitu_tpu_torch.ops import norm_quant as nq  # noqa: E402
from chitu_tpu_torch.ops import quant_gemm_kernels as qg  # noqa: E402
from chitu_tpu_torch.ops.qtensor import QuantKind  # noqa: E402
from chitu_tpu_torch.quantize import transforms as qt  # noqa: E402

QMODES = ["fp8_block", "fp8_row", "w8a16", "w4a16", "w4a16_packed"]
# (T, K, N): decode and slab row counts, ragged K and N, an odd 576
QSHAPES = [
    (1, 128, 512), (16, 256, 1024), (5, 300, 200), (100, 300, 576),
    (130, 96, 72), (33, 513, 1030),
]


def _qweight(dev, mode, K, N, seed=0, layers=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    shape = (layers, K, N) if layers else (K, N)
    w = torch.randn(shape, generator=g, device=dev) * 0.05
    kind = {
        "fp8_block": QuantKind.SOFT_FP8, "fp8_row": QuantKind.FP8,
        "w8a16": QuantKind.W8A16, "w8a8": QuantKind.W8A8,
        "w4a16": QuantKind.W4A16, "w4a16_packed": QuantKind.W4A16,
    }[mode]
    q = qt.quantize_weight(w, kind)
    if mode == "fp8_row":
        q = qt.expand_fp8_scales_rowwise({"w": q})["w"]
    if mode == "w4a16_packed":
        q = qt.pack_int4_storage({"w": q})["w"]
    return q


def _row_rel(a, b):
    a, b = a.float(), b.float()
    assert torch.isfinite(a).all()
    return ((a - b).norm(dim=-1) / b.norm(dim=-1).clamp_min(1e-30)).max().item()


@pytest.mark.parametrize("T,K,N", QSHAPES)
@pytest.mark.parametrize("mode", QMODES)
def test_quant_gemm(dev, mode, T, K, N):
    if mode == "w4a16_packed":
        N = max(512, N // 512 * 512)
    rand = _gen(dev, 4)
    q = _qweight(dev, mode, K, N)
    assert q.packed == (mode == "w4a16_packed")
    x = rand(T, K)
    bias = rand(N)
    n0 = tk.LAUNCHES["quant_gemm"]
    for b, dt in ((None, torch.float32), (bias, torch.bfloat16)):
        got = qg.quant_gemm(x, q, b, dt)
        want = qg.quant_gemm_plain(x, q, b, dt)
        torch.cuda.synchronize()
        assert got.dtype == dt and got.shape == (T, N)
        assert _row_rel(got, want) <= ROW_RTOL
    assert tk.LAUNCHES["quant_gemm"] == n0 + 2


@pytest.mark.parametrize("mode", ["fp8_row", "w4a16_packed", "w4a16"])
def test_quant_gemm_stacked_layer_view(dev, mode):
    rand = _gen(dev, 5)
    q = _qweight(dev, mode, 256, 512, layers=3)
    x = rand(7, 256)
    got = qg.quant_gemm(x, q[2])
    want = qg.quant_gemm_plain(x, q[2])
    torch.cuda.synchronize()
    assert _row_rel(got, want) <= ROW_RTOL


@pytest.mark.parametrize("T", [5, 40])
@pytest.mark.parametrize("block", [32, 64, 256])
def test_quant_gemm_other_block_sizes(dev, T, block):
    """Quant blocks smaller than a K tile (several scale rows a tile) and
    larger than one agree with the plain version."""
    rand = _gen(dev, 9)
    w = rand(512, 384).float() * 0.05
    x = rand(T, 512)
    for kind in (QuantKind.W4A16, QuantKind.SOFT_FP8):
        q = qt.quantize_weight(w, kind, block)
        got = qg.quant_gemm(x, q)
        want = qg.quant_gemm_plain(x, q)
        torch.cuda.synchronize()
        assert _row_rel(got, want) <= ROW_RTOL


def test_quant_gemm_split_k_is_deterministic(dev):
    """Decode shapes that split K (a narrow output) give the same bits on
    every call, and the workspace is left clean for the next shape."""
    rand = _gen(dev, 10)
    q = _qweight(dev, "fp8_block", 4096, 512)
    q2 = _qweight(dev, "w4a16_packed", 1024, 1024, seed=3)
    x, x2 = rand(16, 4096), rand(3, 1024)
    first = qg.quant_gemm(x, q)
    for _ in range(5):
        other = qg.quant_gemm(x2, q2)
        assert _row_rel(other, qg.quant_gemm_plain(x2, q2)) <= ROW_RTOL
        assert torch.equal(qg.quant_gemm(x, q), first)
    assert _row_rel(first, qg.quant_gemm_plain(x, q)) <= ROW_RTOL


@pytest.mark.parametrize("T,K,N", QSHAPES)
def test_int8_gemm(dev, T, K, N):
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    xq = torch.randint(-127, 128, (T, K), generator=g, device=dev).to(torch.int8)
    q = _qweight(dev, "w8a8", K, N)
    xs = torch.rand((T,), generator=g, device=dev) * 0.01 + 1e-3
    got = qg.int8_matmul(xq, q.data)
    want = qg.int8_matmul_plain(xq, q.data)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    y = qg.int8_gemm(xq, xs, q)
    yp = qg.int8_gemm_plain(xq, xs, q)
    torch.cuda.synchronize()
    assert _row_rel(y, yp) <= 1e-5


def _check_acts(got, want):
    torch.cuda.synchronize()
    rel = ((got.scale - want.scale).abs() / want.scale).max().item()
    assert rel <= 1e-6, rel
    d = (got.data.int() - want.data.int()).abs()
    assert d.max().item() <= 1
    assert (d != 0).float().mean().item() <= 1e-3


@pytest.mark.parametrize("T,D", [(1, 128), (16, 4096), (37, 1000), (512, 256)])
def test_norm_quant_kernels(dev, T, D):
    rand = _gen(dev, 7)
    x = rand(T, D)
    w = (1.0 + 0.1 * rand(D).float()).to(torch.bfloat16)
    _check_acts(nq.rms_norm_quant(x, w, 1e-5), nq.rms_norm_quant_plain(x, w, 1e-5))
    _check_acts(nq.quant_acts(x), nq.quant_acts_plain(x))


def test_quant_wrappers_reject_bad_inputs(dev):
    rand = _gen(dev, 8)
    q = _qweight(dev, "fp8_block", 128, 128)
    with pytest.raises(TypeError):
        qg.quant_gemm(rand(4, 128).float(), q)
    with pytest.raises(ValueError):
        qg.quant_gemm(rand(4, 64), q)
    with pytest.raises(TypeError):
        nq.quant_acts(rand(4, 64).float())
    odd = qt.quantize_weight(rand(192, 128).float(), QuantKind.W4A16, 96)
    with pytest.raises(NotImplementedError):  # 96-row blocks do not tile K
        qg.quant_gemm(rand(4, 192), odd)


# ---------------------------------------------------------------------------
# B8: the grouped expert GEMM against its plain version, small stacks
# ---------------------------------------------------------------------------


def _moe_case(dev, mode, T, E, K, N, k=2, L=2, seed=5):
    from chitu_tpu_torch.models import moe
    from chitu_tpu_torch.ops.qtensor import QuantKind
    from chitu_tpu_torch.quantize import transforms as qt

    rand = _gen(dev, seed)
    w = (rand(L, E, K, N).float() * 0.05).to(torch.bfloat16)
    if mode != "bf16":
        w = qt.quantize_stacked(
            w, lambda t: qt.quantize_weight(t, QuantKind.SOFT_FP8))
        if mode == "e4m3_rowwise":
            w = qt.expand_fp8_scales_rowwise({"w": w})["w"]
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    sel = torch.stack(
        [torch.randperm(E, generator=g, device=dev)[:k] for _ in range(T)]
    ).to(torch.int32)
    bm, NB = moe.dispatch_geometry(T, k, E)
    _, block_expert = moe.sorted_dispatch(sel, E, bm)
    return w, rand(NB * bm, K), block_expert, bm


@pytest.mark.parametrize("T", [1, 16, 64, 128, 256, 512])  # bm 16 .. 256
@pytest.mark.parametrize("mode", ["bf16", "e4m3_blockwise", "e4m3_rowwise"])
def test_grouped_gemm(dev, mode, T):
    from chitu_tpu_torch.ops import moe_gemm_kernels as mg

    w, xs, block_expert, bm = _moe_case(dev, mode, T, 8, 256, 384)
    n0 = tk.LAUNCHES["grouped_gemm"]
    junk = torch.full((xs.shape[0], 384), 7.0, dtype=torch.bfloat16, device=dev)
    del junk  # the output lands on this memory: dead rows must be written
    got = mg.grouped_matmul(xs, w, 1, block_expert, bm)
    again = mg.grouped_matmul(xs, w, 1, block_expert, bm)
    want = mg.grouped_matmul_plain(xs, w, 1, block_expert, bm)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["grouped_gemm"] == n0 + 2
    assert torch.equal(got, again)  # split-K adds in a fixed order
    live = torch.repeat_interleave(block_expert >= 0, bm)
    assert not got[~live].any()
    _check(got, want, live)


def test_grouped_gemm_rejects_bad_inputs(dev):
    from chitu_tpu_torch.ops import moe_gemm_kernels as mg
    from chitu_tpu_torch.ops.qtensor import QuantKind
    from chitu_tpu_torch.quantize import transforms as qt

    w, xs, block_expert, bm = _moe_case(dev, "bf16", 16, 8, 256, 384)
    with pytest.raises(IndexError):
        mg.grouped_matmul(xs, w, 2, block_expert, bm)
    with pytest.raises(TypeError):
        mg.grouped_matmul(xs.float(), w, 0, block_expert, bm)
    with pytest.raises(ValueError):
        mg.grouped_matmul(xs[:-1], w, 0, block_expert, bm)
    with pytest.raises(TypeError):
        mg.grouped_matmul(xs, w, 0, block_expert.long(), bm)
    with pytest.raises(NotImplementedError):
        mg.grouped_matmul(xs, w, 0, block_expert, 48)
    with pytest.raises(NotImplementedError):  # N no multiple of 128
        mg.grouped_matmul(xs, w[..., :200].contiguous(), 0, block_expert, bm)
    w8 = qt.quantize_stacked(w, lambda t: qt.quantize_weight(t, QuantKind.W8A16))
    with pytest.raises(NotImplementedError):  # int8 experts: the capacity route
        mg.grouped_matmul(xs, w8, 0, block_expert, bm)


# ---------------------------------------------------------------------------
# B3 and B4 (split K/V), the merged latent row of B1, B3, B4 and B5, and
# B9, against their plain versions. Same row limit as above.
# ---------------------------------------------------------------------------

from chitu_tpu_torch.ops import absorb_kernels as ab  # noqa: E402


@pytest.mark.parametrize("window,softcap", WS)
@pytest.mark.parametrize("H,KV,D,page", GEOMS)
def test_decode_after_append(dev, H, KV, D, page, window, softcap):
    rand = _gen(dev, 6)
    B, mp = 5, 8
    pool = _pool(rand, KV, D, page, B * mp)
    bt = torch.arange(B * mp, device=dev, dtype=torch.int32).reshape(B, mp)
    seq = torch.tensor([0, 3, page, 3 * page + 5, mp * page - 1],
                       device=dev, dtype=torch.int32)
    valid = torch.ones((B,), device=dev, dtype=torch.bool)
    plain.append_decode(pool, 1, rand(B, KV, D), rand(B, KV, D), bt, seq,
                        valid, page)
    q = rand(B, H, D)
    args = (pool, 1, bt, seq, page, KV, D)
    kw = dict(window=window, softcap=softcap)
    n0 = tk.LAUNCHES["attend_decode"]
    out_k = tk.attend_decode(q, *args, **kw)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["attend_decode"] == n0 + 1
    _check(out_k, plain.attend_decode(q, *args, **kw))


def _slab(dev, Tq, NB, mp, segs):
    bts = torch.full((4, mp), -1, device=dev, dtype=torch.int32)
    bseg = torch.full((NB,), -1, device=dev, dtype=torch.int32)
    bq = torch.zeros((NB,), device=dev, dtype=torch.int32)
    total = torch.zeros((4,), device=dev, dtype=torch.int32)
    live = torch.zeros((Tq * NB,), device=dev, dtype=torch.bool)
    off = 0
    for r, (s, n) in enumerate(segs):
        bts[r] = torch.arange(r * mp, (r + 1) * mp, device=dev)
        nb = (n + Tq - 1) // Tq
        bseg[off // Tq : off // Tq + nb] = r
        bq[off // Tq : off // Tq + nb] = s + Tq * torch.arange(nb, device=dev)
        total[r] = s + n
        live[off : off + n] = True
        off += nb * Tq
    return bts, bseg, bq, total, live


@pytest.mark.parametrize("window,softcap", WS)
@pytest.mark.parametrize("H,KV,D,page", GEOMS)
def test_prefill_packed_after_append(dev, H, KV, D, page, window, softcap):
    rand = _gen(dev, 7)
    Tq, NB, mp = 16, 6, 8
    bts, bseg, bq, total, live = _slab(
        dev, Tq, NB, mp, [(0, 20), (page, 17), (0, 3)])
    pool = _pool(rand, KV, D, page, 4 * mp)
    q = rand(Tq * NB, H, D)
    args = (pool, 1, bts, bseg, bq, total, page, KV, D)
    kw = dict(window=window, softcap=softcap)
    out_k = tk.attend_prefill_packed(q, *args, **kw)
    out_p = tk.attend_prefill_packed_plain(q, *args, **kw)
    torch.cuda.synchronize()
    _check(out_k, out_p, live)
    dead = ~torch.repeat_interleave(bseg >= 0, Tq)
    assert out_k[dead].abs().max().item() == 0.0


LAT = dict(kv_heads=1, head_dim=tk.LATENT_QK, split_kv=False,
           v_dim=tk.LATENT_DV, scale=0.1352)
LAT_M = 640


def _latent_pool(rand, page, P):
    pool = rand(2, P, page, LAT_M)
    pool[..., tk.LATENT_QK:] = 0
    return pool


@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("H,page", [(128, 64), (32, 16), (16, 64)])
def test_latent_decode_fused(dev, H, page, window):
    rand = _gen(dev, 8)
    B, mp = 5, 8
    pool = _latent_pool(rand, page, B * mp)
    bt = torch.arange(B * mp, device=dev, dtype=torch.int32).reshape(B, mp)
    seq = torch.tensor([0, 3, page, 3 * page + 5, mp * page - 1],
                       device=dev, dtype=torch.int32)
    valid = torch.tensor([True, True, False, True, True], device=dev)
    q, k = rand(B, H, tk.LATENT_QK), rand(B, 1, tk.LATENT_QK)
    pk, pp = pool.clone(), pool.clone()
    args = (1, k, None, bt, seq, valid, page)
    out_k = tk.attend_decode_fused(q, pk, *args, window=window, **LAT)
    out_p = tk.attend_decode_fused_plain(q, pp, *args, window=window, **LAT)
    torch.cuda.synchronize()
    assert out_k.shape == (B, H, tk.LATENT_DV)
    assert torch.equal(pk, pp)
    _check(out_k, out_p, valid)


@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("H,page", [(128, 64), (32, 16), (16, 64)])
def test_latent_decode(dev, H, page, window):
    rand = _gen(dev, 9)
    B, mp = 5, 8
    pool = _latent_pool(rand, page, B * mp)
    bt = torch.arange(B * mp, device=dev, dtype=torch.int32).reshape(B, mp)
    seq = torch.tensor([0, 3, page, 3 * page + 5, mp * page - 1],
                       device=dev, dtype=torch.int32)
    valid = torch.ones((B,), device=dev, dtype=torch.bool)
    plain.append_decode(pool, 1, rand(B, 1, tk.LATENT_QK), None, bt, seq,
                        valid, page)
    q = rand(B, H, tk.LATENT_QK)
    out_k = tk.attend_decode(q, pool, 1, bt, seq, page, window=window, **LAT)
    out_p = plain.attend_decode(
        q, pool, 1, bt, seq, page, 1, tk.LATENT_QK, scale=LAT["scale"],
        window=window, split_kv=False)[..., : tk.LATENT_DV]
    _check(out_k, out_p)


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("H,page", [(128, 64), (32, 16), (16, 64)])
def test_latent_prefill(dev, H, page, window):
    rand = _gen(dev, 10)
    mp, T, start = 16, 32, 40
    pool = _latent_pool(rand, page, mp + 4)
    bt = torch.arange(mp, device=dev, dtype=torch.int32) + 4
    q_pos = torch.arange(start, start + T, device=dev, dtype=torch.int32)
    q = rand(T, H, tk.LATENT_QK)
    args = (pool, 1, bt, q_pos, start + T, page)
    _check(tk.attend_prefill(q, *args, window=window, **LAT),
           plain.attend_prefill(q, *args, 1, tk.LATENT_QK, scale=LAT["scale"],
                                window=window, split_kv=False)[..., :512])


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("H,page,Tq", [(128, 64, 8), (32, 16, 16), (16, 64, 8)])
def test_latent_prefill_packed(dev, H, page, Tq, window):
    rand = _gen(dev, 11)
    NB, mp = 12, 8
    bts, bseg, bq, total, live = _slab(
        dev, Tq, NB, mp, [(0, 20), (page, 17), (0, 3)])
    pool = _latent_pool(rand, page, 4 * mp)
    q = rand(Tq * NB, H, tk.LATENT_QK)
    args = (pool, 1, bts, bseg, bq, total, page)
    out_k = tk.attend_prefill_packed(q, *args, window=window, **LAT)
    out_p = tk.attend_prefill_packed_plain(q, *args, window=window, **LAT)
    torch.cuda.synchronize()
    _check(out_k, out_p, live)
    dead = ~torch.repeat_interleave(bseg >= 0, Tq)
    assert out_k[dead].abs().max().item() == 0.0


@pytest.mark.parametrize("T", [1, 5, 16, 100, 128])
@pytest.mark.parametrize("kind", ["uk", "uv"])
@pytest.mark.parametrize("H", [4, 32])
def test_absorb_matmul(dev, H, kind, T):
    rand = _gen(dev, 12)
    L, C, dn, dv = 2, 512, 128, 128
    w = rand(L, C, H * (dn + dv)) * 0.05
    if kind == "uk":
        # q_nope as the model passes it: a view of [T, H, dn + rope] rows
        x = rand(T, H, dn + 64)[..., :dn]
    else:
        x = rand(T, H, C)
    n0 = ab.LAUNCHES["absorb_matmul"]
    got = ab.absorb_matmul(x, w, 1, kind, dn, dv)
    again = ab.absorb_matmul(x, w, 1, kind, dn, dv)
    want = ab.absorb_matmul_plain(x, w, 1, kind, dn, dv)
    torch.cuda.synchronize()
    assert ab.LAUNCHES["absorb_matmul"] == n0 + 2
    assert torch.equal(got, again)
    _check(got, want)


def test_latent_and_absorb_reject_bad_inputs(dev):
    rand = _gen(dev, 13)
    pool = _latent_pool(rand, 16, 8)
    bt = torch.zeros((3, 2), device=dev, dtype=torch.int32)
    seq = torch.zeros((3,), device=dev, dtype=torch.int32)
    with pytest.raises(NotImplementedError):  # 24 heads: no head tile
        tk.attend_decode(rand(3, 24, 576), pool, 0, bt, seq, 16, **LAT)
    with pytest.raises(NotImplementedError):  # another latent width
        tk.attend_decode(rand(3, 32, 80), pool, 0, bt, seq, 16, 1, 80,
                         split_kv=False, v_dim=64)
    w = rand(2, 512, 4 * 256)
    with pytest.raises(NotImplementedError):  # T beyond the gate
        ab.absorb_matmul(rand(129, 4, 128), w, 0, "uk", 128, 128)
    with pytest.raises(TypeError):
        ab.absorb_matmul(rand(4, 4, 128).float(), w, 0, "uk", 128, 128)
    with pytest.raises(ValueError):
        ab.absorb_matmul(rand(4, 4, 128), w, 0, "uv", 128, 128)


# ---------------------------------------------------------------------------
# The variants of this slice: the split layout at head sizes 192, 64 and 32,
# and int8 pools of fp8-e4m3 bits on every attention kernel (split and
# latent). The appends must write the JAX package's e4m3 bytes: the pool
# after a fused append equals the plain append's (`kv_encode`), NaN codes
# included. B13 against its plain version. Same row limit as above.
# ---------------------------------------------------------------------------

from chitu_tpu_torch.models.common import kv_encode  # noqa: E402
from chitu_tpu_torch.ops import dense_gemm_kernels as dg  # noqa: E402

VGEOMS = [  # (H, KV, D, page, pool)
    (4, 4, 192, 16, "bf16"), (8, 8, 192, 64, "e4m3"), (32, 4, 64, 16, "bf16"),
    (32, 4, 64, 64, "e4m3"), (4, 2, 32, 16, "bf16"), (4, 2, 32, 16, "e4m3"),
    (8, 4, 128, 16, "e4m3"), (16, 2, 128, 64, "e4m3"),
]
# e4m3 encodings to pin: +-448, +-464 (ties down to 448), the smallest
# subnormal and its half (a tie to zero), a subnormal tie, mantissa ties
# either way, signed zeros and an underflow
SPECIALS = [448.0, -448.0, 464.0, -464.0, 2.0 ** -9, -(2.0 ** -9), 2.0 ** -10,
            -(2.0 ** -10), 3 * 2.0 ** -10, 1.0625, 1.1875, -0.0, 0.0, 1e-8,
            -1e-8, 0.01171875]
# beyond the e4m3 range: NaN codes (the rows holding them are not attended)
OVERFLOW = [466.0, -466.0, 1000.0, -600.0, float("inf"), float("-inf"),
            float("nan")]


def _vpool(rand, KV, D, page, P, kind):
    pool = rand(2, P, page, 2 * KV * D)
    return pool if kind == "bf16" else kv_encode(pool, torch.int8)


def _with(x, vals):
    x = x.clone()
    flat = x.view(-1)
    flat[: len(vals)] = torch.tensor(vals, dtype=x.dtype, device=x.device)
    return x


def _tag(D, kind):
    tags = ([f"d{D}"] if D != 128 else []) + (["e4m3"] if kind == "e4m3" else [])
    return ",".join(tags)


@pytest.mark.parametrize("H,KV,D,page,kind", VGEOMS)
def test_variant_decode_fused(dev, H, KV, D, page, kind):
    rand = _gen(dev, 20)
    B, mp = 5, 8
    pool = _vpool(rand, KV, D, page, B * mp, kind)
    bt = torch.arange(B * mp, device=dev, dtype=torch.int32).reshape(B, mp)
    seq = torch.tensor([0, 3, page, 3 * page + 5, mp * page - 1],
                       device=dev, dtype=torch.int32)
    valid = torch.tensor([True, True, False, True, True], device=dev)
    q = rand(B, H, D)
    k, v = _with(rand(B, KV, D), SPECIALS), _with(rand(B, KV, D), SPECIALS[::-1])
    pk, pp = pool.clone(), pool.clone()
    args = (1, k, v, bt, seq, valid, page, KV, D)
    key = f"attend_decode_fused[{_tag(D, kind)}]"
    n0 = tk.LAUNCHES.get(key, 0)
    out_k = tk.attend_decode_fused(q, pk, *args)
    out_p = tk.attend_decode_fused_plain(q, pp, *args)
    torch.cuda.synchronize()
    assert tk.LAUNCHES[key] == n0 + 1
    assert torch.equal(pk, pp)
    _check(out_k, out_p, valid)


@pytest.mark.parametrize("H,KV,D,page,kind", VGEOMS)
def test_variant_decode(dev, H, KV, D, page, kind):
    rand = _gen(dev, 21)
    B, mp = 5, 8
    pool = _vpool(rand, KV, D, page, B * mp, kind)
    bt = torch.arange(B * mp, device=dev, dtype=torch.int32).reshape(B, mp)
    seq = torch.tensor([0, 3, page, 3 * page + 5, mp * page - 1],
                       device=dev, dtype=torch.int32)
    valid = torch.ones((B,), device=dev, dtype=torch.bool)
    plain.append_decode(pool, 1, rand(B, KV, D), rand(B, KV, D), bt, seq,
                        valid, page)
    q = rand(B, H, D)
    args = (pool, 1, bt, seq, page, KV, D)
    _check(tk.attend_decode(q, *args, window=40),
           plain.attend_decode(q, *args, window=40))


@pytest.mark.parametrize("H,KV,D,page,kind", VGEOMS)
def test_variant_prefill(dev, H, KV, D, page, kind):
    rand = _gen(dev, 22)
    mp, T, start = 16, 32, 40
    pool = _vpool(rand, KV, D, page, mp + 4, kind)
    bt = torch.arange(mp, device=dev, dtype=torch.int32) + 4
    q_pos = torch.arange(start, start + T, device=dev, dtype=torch.int32)
    q = rand(T, H, D)
    args = (pool, 1, bt, q_pos, start + T, page, KV, D)
    _check(tk.attend_prefill(q, *args, softcap=20.0),
           plain.attend_prefill(q, *args, softcap=20.0))


@pytest.mark.parametrize("H,KV,D,page,kind", VGEOMS)
def test_variant_prefill_packed(dev, H, KV, D, page, kind):
    """B2 (append, then attend) and B3 (attend only) on one slab."""
    rand = _gen(dev, 23)
    Tq, NB, mp = 16, 6, 8
    bts, bseg, bq, total, live = _slab(
        dev, Tq, NB, mp, [(0, 20), (page, 17), (0, 3)])
    pool = _vpool(rand, KV, D, page, 4 * mp, kind)
    T = Tq * NB
    q = rand(T, H, D)
    k, v = _with(rand(T, KV, D), SPECIALS), _with(rand(T, KV, D), SPECIALS[::-1])
    pk, pp = pool.clone(), pool.clone()
    args = (1, k, v, bts, bseg, bq, total, page, KV, D)
    out_k = tk.attend_prefill_packed_fused(q, pk, *args, window=24)
    out_p = tk.attend_prefill_packed_fused_plain(q, pp, *args, window=24)
    torch.cuda.synchronize()
    assert torch.equal(pk, pp)
    _check(out_k, out_p, live)
    pargs = (pk, 1, bts, bseg, bq, total, page, KV, D)
    out_k = tk.attend_prefill_packed(q, *pargs)
    _check(out_k, tk.attend_prefill_packed_plain(q, *pargs), live)
    dead = ~torch.repeat_interleave(bseg >= 0, Tq)
    assert out_k[dead].abs().max().item() == 0.0


@pytest.mark.parametrize("D", [192, 128])
def test_e4m3_appends_write_nan_codes(dev, D):
    """Values beyond 464 land as NaN codes (sign | 0x7F), byte-equal to
    the plain append, in B1's and B2's appends."""
    rand = _gen(dev, 24)
    KV, page, B, mp = 2, 16, 3, 4
    pool = _vpool(rand, KV, D, page, B * mp, "e4m3")
    bt = torch.arange(B * mp, device=dev, dtype=torch.int32).reshape(B, mp)
    seq = torch.tensor([1, 5, 20], device=dev, dtype=torch.int32)
    valid = torch.ones((B,), device=dev, dtype=torch.bool)
    k = _with(rand(B, KV, D), OVERFLOW + SPECIALS)
    v = _with(rand(B, KV, D), SPECIALS + OVERFLOW)
    pk, pp = pool.clone(), pool.clone()
    tk.attend_decode_fused(rand(B, 2 * KV, D), pk, 1, k, v, bt, seq, valid,
                           page, KV, D)
    tk.attend_decode_fused_plain(rand(B, 2 * KV, D), pp, 1, k, v, bt, seq,
                                 valid, page, KV, D)
    torch.cuda.synchronize()
    assert torch.equal(pk, pp)
    assert (pk == 127).any() and (pk == -1).any()
    Tq, NB = 16, 2
    bts, bseg, bq, total, live = _slab(dev, Tq, NB, mp, [(0, 20)])
    k = _with(rand(Tq * NB, KV, D), OVERFLOW * 3)
    v = _with(rand(Tq * NB, KV, D), SPECIALS)
    pk, pp = pool.clone(), pool.clone()
    q = rand(Tq * NB, 2 * KV, D)
    args = (1, k, v, bts, bseg, bq, total, page, KV, D)
    tk.attend_prefill_packed_fused(q, pk, *args)
    tk.attend_prefill_packed_fused_plain(q, pp, *args)
    torch.cuda.synchronize()
    assert torch.equal(pk, pp)


def _latent_e4m3(rand, page, P):
    return kv_encode(_latent_pool(rand, page, P), torch.int8)


@pytest.mark.parametrize("H,page", [(128, 64), (32, 16)])
def test_latent_e4m3(dev, H, page):
    """The latent row on an e4m3 pool through all four modes; B1's append
    bytes equal the plain append's."""
    rand = _gen(dev, 25)
    B, mp = 5, 8
    pool = _latent_e4m3(rand, page, B * mp)
    bt = torch.arange(B * mp, device=dev, dtype=torch.int32).reshape(B, mp)
    seq = torch.tensor([0, 3, page, 3 * page + 5, mp * page - 1],
                       device=dev, dtype=torch.int32)
    valid = torch.tensor([True, True, False, True, True], device=dev)
    q = rand(B, H, tk.LATENT_QK)
    k = _with(rand(B, 1, tk.LATENT_QK), SPECIALS)
    pk, pp = pool.clone(), pool.clone()
    args = (1, k, None, bt, seq, valid, page)
    n0 = tk.LAUNCHES.get("attend_decode_fused[latent,e4m3]", 0)
    out_k = tk.attend_decode_fused(q, pk, *args, **LAT)
    out_p = tk.attend_decode_fused_plain(q, pp, *args, **LAT)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["attend_decode_fused[latent,e4m3]"] == n0 + 1
    assert torch.equal(pk, pp)
    _check(out_k, out_p, valid)
    out_k = tk.attend_decode(q, pk, 1, bt, seq, page, **LAT)
    out_p = plain.attend_decode(
        q, pk, 1, bt, seq, page, 1, tk.LATENT_QK, scale=LAT["scale"],
        split_kv=False)[..., : tk.LATENT_DV]
    _check(out_k, out_p, valid)
    T, start = 32, 40
    bt1 = torch.arange(mp, device=dev, dtype=torch.int32) + 4
    q_pos = torch.arange(start, start + T, device=dev, dtype=torch.int32)
    qp = rand(T, H, tk.LATENT_QK)
    sargs = (pool, 1, bt1, q_pos, start + T, page)
    _check(tk.attend_prefill(qp, *sargs, **LAT),
           plain.attend_prefill(qp, *sargs, 1, tk.LATENT_QK, scale=LAT["scale"],
                                split_kv=False)[..., : tk.LATENT_DV])
    Tq, NB = 8, 12
    bts, bseg, bq, total, live = _slab(dev, Tq, NB, mp, [(0, 20), (page, 17)])
    qs = rand(Tq * NB, H, tk.LATENT_QK)
    pargs = (pool, 1, bts, bseg, bq, total, page)
    _check(tk.attend_prefill_packed(qs, *pargs, **LAT),
           tk.attend_prefill_packed_plain(qs, *pargs, **LAT), live)


@pytest.mark.parametrize("T", [1, 16, 100, 512])
@pytest.mark.parametrize("K,N", [(256, 384), (1024, 128), (384, 1024)])
def test_dense_matmul_stacked(dev, T, K, N):
    rand = _gen(dev, 26)
    w = rand(3, K, N) * 0.05
    x = rand(T, K)
    n0 = dg.LAUNCHES["dense_matmul_stacked"]
    got = dg.dense_matmul_stacked(x, 2, w)
    want = dg.dense_matmul_stacked_plain(x, 2, w)
    torch.cuda.synchronize()
    assert dg.LAUNCHES["dense_matmul_stacked"] == n0 + 1
    assert got.dtype == torch.float32 and got.shape == (T, N)
    _check(got, want)


def test_dense_matmul_stacked_geometry_rule(dev):
    """K or N off the multiples of 128 go to torch.matmul, as the JAX
    function does; no kernel launch."""
    rand = _gen(dev, 27)
    w, x = rand(2, 200, 256), rand(5, 200)
    n0 = dg.LAUNCHES["dense_matmul_stacked"]
    got = dg.dense_matmul_stacked(x, 1, w)
    assert dg.LAUNCHES["dense_matmul_stacked"] == n0
    _check(got, dg.dense_matmul_stacked_plain(x, 1, w))
    with pytest.raises(TypeError):
        dg.dense_matmul_stacked(x.float()[:, :128], 0, rand(2, 128, 128))


def test_variant_wrappers_reject_bad_inputs(dev):
    rand = _gen(dev, 28)
    bt = torch.zeros((3, 2), device=dev, dtype=torch.int32)
    seq = torch.zeros((3,), device=dev, dtype=torch.int32)
    with pytest.raises(TypeError):  # an f16 pool
        tk.attend_decode(rand(3, 4, 64), rand(2, 8, 16, 256).half(), 0, bt,
                         seq, 16, 2, 64)
    with pytest.raises(NotImplementedError):  # V narrower than K
        tk.attend_decode(rand(3, 4, 192), rand(2, 8, 16, 768), 0, bt, seq,
                         16, 2, 192, v_dim=128)


# ---------------------------------------------------------------------------
# The redesigned split-layout kernels: the split decode (B1, B4) and the
# tensor-core prefill (B5, B2, B3), over every head size, 1 to 16 query
# heads a KV head, both pools and pages of 16 and 64
# ---------------------------------------------------------------------------

SPLIT_GEOMS = [(D, G, kind, page) for D in (32, 64, 128, 192)
               for G in (1, 4, 8, 16) for kind in ("bf16", "e4m3")
               for page in (16, 64)]


def _ids(p):
    return "d{}-g{}-{}-p{}".format(*p)


def _ws(D, G, page):
    return WS[(D // 32 + G + page) % 3]


@pytest.mark.parametrize("D,G,kind,page", SPLIT_GEOMS, ids=map(_ids, SPLIT_GEOMS))
def test_split_decode(dev, D, G, kind, page):
    """B1 and B4 over contexts 0, 1, 63, 64, 65 and each split boundary
    +-1 (the splits as the wrapper picks them), a dead row, window or
    softcap; pool bytes equal, rows within 1e-2, two launches
    bit-equal."""
    rand = _gen(dev, 30)
    KV, keys = 2, 512
    mp = keys // page
    S, chunk = tk.decode_split(16, KV, mp, page, tk._sm_count(dev))
    ctx = [0, 1, 63, 64, 65, keys - 1]
    ctx += [c for s in range(1, S) for c in (s * chunk - 2, s * chunk - 1, s * chunk)]
    ctx = sorted(set(min(max(c, 0), keys - 1) for c in ctx))[:16]
    B = len(ctx)
    S, chunk = tk.decode_split(B, KV, mp, page, tk._sm_count(dev))
    pool = _vpool(rand, KV, D, page, B * mp, kind)
    bt = torch.arange(B * mp, device=dev, dtype=torch.int32).reshape(B, mp)
    seq = torch.tensor(ctx, device=dev, dtype=torch.int32)
    valid = torch.ones((B,), device=dev, dtype=torch.bool)
    valid[1] = False
    q, k, v = rand(B, KV * G, D), rand(B, KV, D), rand(B, KV, D)
    window, softcap = _ws(D, G, page)
    kw = dict(window=window, softcap=softcap)
    args = (1, k, v, bt, seq, valid, page, KV, D)
    pk, pp = pool.clone(), pool.clone()
    out_k = tk.attend_decode_fused(q, pk, *args, **kw)
    out_p = tk.attend_decode_fused_plain(q, pp, *args, **kw)
    again = tk.attend_decode_fused(q, pool.clone(), *args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(pk, pp)
    assert torch.equal(out_k, again)
    _check(out_k, out_p, valid)
    dargs = (pk, 1, bt, seq, page, KV, D)
    out_k = tk.attend_decode(q, *dargs, **kw)
    again = tk.attend_decode(q, *dargs, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out_k, again)
    _check(out_k, tk.attend_decode_plain(q, *dargs, **kw))
    _check(out_k.float(),
           tk.attend_decode_split_plain(q, *dargs, S, chunk, **kw).float())


@pytest.mark.parametrize("D,G,kind,page", SPLIT_GEOMS, ids=map(_ids, SPLIT_GEOMS))
def test_split_prefill(dev, D, G, kind, page):
    """B5 for a chunk whose q_pos is not tile-aligned, then B2 (append and
    attend) and B3 on packed slabs of Tq 8 and 64 with dead blocks;
    window or softcap; pool bytes equal, rows within 1e-2, dead blocks
    zero, two launches bit-equal."""
    rand = _gen(dev, 31)
    KV = 2
    window, softcap = _ws(D, G, page)
    kw = dict(window=window, softcap=softcap)
    mp, T, start = 256 // page + 2, 96, 37
    pool = _vpool(rand, KV, D, page, 4 * mp, kind)
    bt = torch.arange(mp, device=dev, dtype=torch.int32) + mp
    q_pos = torch.arange(start, start + T, device=dev, dtype=torch.int32)
    q = rand(T, KV * G, D)
    args = (pool, 1, bt, q_pos, start + T, page, KV, D)
    out_k = tk.attend_prefill(q, *args, **kw)
    again = tk.attend_prefill(q, *args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out_k, again)
    _check(out_k, plain.attend_prefill(q, *args, **kw))
    segs = [(0, 70), (page + 3, 37), (0, 5)]  # (start, new tokens)
    for Tq in (8, 64):
        NB = sum(-(-n // Tq) for _, n in segs) + 2  # two dead blocks
        bts, bseg, bq, total, live = _slab(dev, Tq, NB, mp, segs)
        T = Tq * NB
        q = rand(T, KV * G, D)
        k, v = rand(T, KV, D), rand(T, KV, D)
        pk, pp = pool.clone(), pool.clone()
        fargs = (1, k, v, bts, bseg, bq, total, page, KV, D)
        out_k = tk.attend_prefill_packed_fused(q, pk, *fargs, **kw)
        out_p = tk.attend_prefill_packed_fused_plain(q, pp, *fargs, **kw)
        torch.cuda.synchronize()
        assert torch.equal(pk, pp)
        _check(out_k, out_p, live)
        dead = ~torch.repeat_interleave(bseg >= 0, Tq)
        assert dead.any() and out_k[dead].abs().max().item() == 0.0
        pargs = (pk, 1, bts, bseg, bq, total, page, KV, D)
        out_k = tk.attend_prefill_packed(q, *pargs, **kw)
        again = tk.attend_prefill_packed(q, *pargs, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out_k, again)
        _check(out_k, tk.attend_prefill_packed_plain(q, *pargs, **kw), live)
        assert out_k[dead].abs().max().item() == 0.0
