"""The CUDA kernels against their plain PyTorch versions on the card, at
small geometries beside the Llama-3-8B ones chip_smoke.py covers:
head_dim 128 (the one head size the kernels take), 1 to 8 query heads per
KV head, pages of 16 and 64, window and softcap. Pool bytes must be
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
    with pytest.raises(NotImplementedError):  # head_dim 64 has no kernel yet
        tk.attend_decode_fused(
            rand(3, 4, 64), rand(2, 8, 16, 256), 0, rand(3, 2, 64),
            rand(3, 2, 64), bt.int(), seq, valid, 16, 2, 64,
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
