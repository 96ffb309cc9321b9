"""The host-side planning of the port's Hopper GEMM mainloop
(`chitu_tpu_torch/ops/gemm_plan.py`), which the dequant GEMM (B6+B7) and
the grouped expert GEMM (B8) wrappers run before every launch: the regime
for a row count, the K splits from shapes and a stated SM count (132, the
H100 SXM's; 114, the H100 PCIe's), whether a tensor map can describe an
operand, the split-K workspace, and B8's tile coordinates. Plain functions
of shapes and pointers, so they run here on the CPU."""

import math

import numpy as np
import pytest
import torch

from chitu_tpu_torch.models import moe
from chitu_tpu_torch.ops import gemm_plan as gp

SMS = 132


@pytest.mark.parametrize("rows,cols,tn", [
    (1, 48, 16), (8, 48, 16), (16, 48, 16), (17, 48, 32), (32, 48, 32),
    (33, 48, 64), (64, 48, 64),
    (65, 48, 128), (128, 48, 128),  # as many blocks either way: 128
    (512, 48, 256),  # 96 blocks in one wave against 192 in two
    (513, 48, 128),  # two waves either way: 128
    (65, 224, 128), (512, 224, 256),
    (512, 32, 128),  # 128 blocks in one wave either way: 128
    (1024, 32, 256),  # 128 blocks in one wave against 256 in two
])
def test_regime_for_rows(rows, cols, tn):
    """The regime and the rows a tile (132 SMs)."""
    assert gp.token_tile(rows) == (tn if tn <= 64 else 0)
    plan = gp.quant_plan(rows, 4096, cols * 128, False, SMS)
    assert plan.tn == tn
    assert plan.regime == ("decode" if tn <= 64 else "slab")
    assert plan.bk == (128 if tn <= 64 else 64)
    if tn <= 64:
        assert plan.grid == (plan.splits, 1, cols) and plan.row_tiles == 1
    else:
        assert plan.splits == 1 and plan.ws_floats == 0
        assert plan.grid == (math.ceil(rows / tn), 1, cols)


@pytest.mark.parametrize("cols,k_tiles,sms,splits", [
    (224, 32, 132, 1),  # Llama-3-8B w_gate_up [4096 -> 28672]: the columns fill the card
    (48, 32, 132, 2),  # wqkv [4096 -> 6144]: two splits fit one wave
    (32, 112, 132, 4),  # w_down [14336 -> 4096]
    (32, 112, 114, 7),  # the same on 114 SMs: 224 blocks in two waves
    (1, 1, 132, 1),  # one K tile cannot be split
    (1, 3, 132, 1),  # nor three: two tiles a split at least
    (1, 400, 132, 16),  # a lone column tile takes the most splits
])
def test_decode_splits(cols, k_tiles, sms, splits):
    assert gp.decode_splits(cols, k_tiles, sms) == splits


@pytest.mark.parametrize("sms", [132, 114, 78])
def test_decode_splits_is_cheapest(sms):
    """Every choice is within its limits and no cheaper one exists."""
    for cols in (1, 3, 8, 32, 48, 96, 224, 1792):
        for k_tiles in (1, 2, 5, 32, 56, 112):
            s = gp.decode_splits(cols, k_tiles, sms)
            assert 1 <= s <= max(1, min(gp.MAX_SPLITS, k_tiles // 2))

            def cost(n):
                return math.ceil(cols * n / sms) * (math.ceil(k_tiles / n) + gp.FILL_TILES)

            limit = max(1, min(gp.MAX_SPLITS, k_tiles // 2))
            assert cost(s) == min(cost(n) for n in range(1, limit + 1))
            assert all(cost(n) > cost(s) for n in range(1, s))


def test_quant_plan_workspace_and_tickets():
    p = gp.quant_plan(16, 4096, 6144, False, SMS)
    assert (p.splits, p.col_tiles) == (2, 48)
    assert p.ws_floats == 48 * 2 * 16 * 128 and p.tickets == 48
    p = gp.quant_plan(40, 14336, 4096, False, SMS)  # token tile 64
    assert (p.tn, p.splits) == (64, 4)
    assert p.ws_floats == 32 * 4 * 64 * 128
    p = gp.quant_plan(16, 4096, 28672, False, SMS)
    assert p.splits == 1 and p.ws_floats == 0 and p.tickets == 224
    # packed int4: 128 logical columns from 64 byte columns a tile
    p = gp.quant_plan(16, 4096, 28672, True, SMS)
    assert p.col_tiles == 224
    # a ragged width rounds up; K rounds up to whole tiles
    p = gp.quant_plan(5, 300, 200, False, SMS)
    assert p.col_tiles == 2 and p.splits == 1


@pytest.mark.parametrize("K,N,packed,w_off,x_off,tma_w,tma_x", [
    (4096, 6144, False, 0, 0, True, True),
    (4096, 576, False, 0, 0, True, True),  # 576 bytes a row: 36 x 16
    (300, 200, False, 0, 0, False, False),  # 200-byte rows, 600-byte x rows
    (96, 72, False, 0, 0, False, True),
    (513, 1030, False, 0, 0, False, False),
    (1024, 1024, True, 0, 0, True, True),  # packed: 512 bytes a row
    (4096, 6144, False, 8, 0, False, True),  # a base off 16 bytes
    (4096, 6144, False, 0, 2, True, False),
])
def test_tensor_map_or_cp_async(K, N, packed, w_off, x_off, tma_w, tma_x):
    p = gp.quant_plan(7, K, N, packed, SMS, 4096 + w_off, 8192 + x_off)
    assert (p.tma_w, p.tma_x) == (tma_w, tma_x)


def test_layer_view_alignment():
    """A layer of a stacked weight is a view whose base moves by K * N
    bytes a layer (K * N / 2 packed): rows a tensor map can describe
    (a multiple of 16 bytes) keep every layer's base aligned, so the
    layer views of one stack all take the same path."""
    base = 1 << 20
    for K, N, packed in [(256, 512, False), (300, 208, False), (99, 1024, True),
                         (99, 200, False), (13, 72, False)]:
        row = N // 2 if packed else N
        paths = {gp.tma_ok(base + layer * K * row, row) for layer in range(4)}
        assert paths == {row % 16 == 0}


@pytest.mark.parametrize("block,bk,ok", [
    (32, 64, True), (64, 64, True), (128, 64, True), (256, 64, True),
    (32, 128, True), (64, 128, True), (128, 128, True), (256, 128, True),
    (16, 128, False), (16, 64, False), (96, 128, False), (96, 64, False),
])
def test_blocks_tile(block, bk, ok):
    assert gp.blocks_tile(block, bk) == ok


@pytest.mark.parametrize("T,k,E,K,N,tn,splits", [
    (16, 2, 8, 4096, 28672, 16, 1),  # Mixtral decode, merged gate/up
    (16, 2, 8, 14336, 4096, 16, 1),  # 8 live blocks x 32 columns
    (1, 2, 8, 14336, 4096, 16, 4),  # 3 blocks x 32 columns: split
    (64, 2, 8, 4096, 14336, 32, 1),  # bm 32
    (128, 2, 8, 4096, 14336, 64, 1),  # bm 64
    (256, 2, 8, 4096, 14336, 128, 1),  # bm 128: a 128-row slab tile
    (512, 2, 8, 4096, 28672, 256, 1),  # bm 256: a 256-row slab tile
    (16, 8, 256, 7168, 4096, 16, 1),  # DeepSeek-R1: 136 blocks
    (1, 8, 256, 2048, 7168, 16, 1),
    (1, 2, 8, 2048, 256, 16, 8),  # a narrow stack splits K more
])
def test_moe_plan(T, k, E, K, N, tn, splits):
    bm, NB = moe.dispatch_geometry(T, k, E)
    assert bm == tn
    p = gp.moe_plan(NB, bm, E, K, N, SMS)
    assert (p.tn, p.splits, p.row_tiles) == (tn, splits, 1)
    assert p.regime == ("decode" if tn <= 64 else "slab")
    assert p.grid == (splits, NB, N // 128)
    assert p.tickets == NB * (N // 128)
    assert p.ws_floats == (NB * (N // 128) * splits * tn * 128 if splits > 1 else 0)
    assert p.tma_w and p.tma_x


def test_moe_tile_coords_match_the_stack():
    """The weight row and scale offset B8 derives for (layer, expert, K
    tile) land on that expert's tile of a [L, E, K, N] stack and of its
    [L, E, K/128, scale_ld] scales, read as the kernel reads them: as
    [L * E * K, N] rows and a flat float array."""
    L, E, K, N = 3, 5, 512, 256
    rng = np.random.default_rng(0)
    w = rng.standard_normal((L, E, K, N)).astype(np.float32)
    rows = w.reshape(L * E * K, N)
    for scale_ld in (N, N // 128):
        s = rng.standard_normal((L, E, K // 128, scale_ld)).astype(np.float32)
        flat = s.reshape(-1)
        for layer, e, kt, bk in [(0, 0, 0, 128), (2, 4, 3, 128), (1, 3, 7, 64),
                                 (2, 1, 5, 64)]:
            row, soff = gp.moe_tile_coords(layer, E, e, K, kt, bk, scale_ld)
            k0 = kt * bk
            np.testing.assert_array_equal(rows[row], w[layer, e, k0])
            np.testing.assert_array_equal(rows[row + bk - 1], w[layer, e, k0 + bk - 1])
            np.testing.assert_array_equal(flat[soff:soff + scale_ld],
                                          s[layer, e, k0 // 128])
    for e in (-1, E, E + 3):
        assert gp.moe_tile_coords(1, E, e, K, 0, 128, N) is None


def test_workspace_grows_and_keeps_counters_zero():
    ws = gp.Workspace()
    dev = torch.device("cpu")
    a, c = ws.get(torch, dev, 1000, 8)
    assert a.numel() >= 1000 and c.numel() >= 8 and not c.any()
    b, c2 = ws.get(torch, dev, 500, 4)  # a smaller call reuses them
    assert b.data_ptr() == a.data_ptr() and c2.data_ptr() == c.data_ptr()
    d, c3 = ws.get(torch, dev, 5000, 4)  # a larger one grows both
    assert d.numel() >= 5000 and c3.numel() >= 8 and not c3.any()


# ---------------------------------------------------------------------------
# B13, the dense stacked-layer GEMM: the same mainloop with bf16 tiles, one
# tensor map over the stack's [L * K, N] rows
# ---------------------------------------------------------------------------

LLAMA_SPLITS = {(4096, 6144): 2, (4096, 4096): 4, (4096, 28672): 1, (14336, 4096): 4}
LLAMA_SLAB = {(4096, 6144): 256, (4096, 4096): 128, (4096, 28672): 256,
              (14336, 4096): 128}


@pytest.mark.parametrize("K,N", list(LLAMA_SPLITS))
@pytest.mark.parametrize("T", [1, 16, 64, 65, 512])
def test_dense_plan_at_llama_shapes(T, K, N):
    """Llama-3-8B's four projections on 132 SMs: swapped decode tiles with
    K splits at up to 64 rows (N 4096: four splits, 128 blocks against the
    first kernel's 32), slab tiles of 128 or 256 rows above."""
    p = gp.dense_plan(T, K, N, SMS, 1 << 20, 1 << 21)
    assert p.tma_w and p.tma_x
    assert p.col_tiles == N // 128
    if T <= 64:
        assert p.regime == "decode" and p.bk == 128
        assert p.tn == (16 if T <= 16 else 64)
        assert p.splits == LLAMA_SPLITS[(K, N)]
        assert p.grid == (p.splits, 1, N // 128)
        assert p.ws_floats == ((N // 128) * p.splits * p.tn * 128 if p.splits > 1 else 0)
    else:
        assert p.regime == "slab" and p.bk == 64 and p.splits == 1
        assert p.tn == (128 if T == 65 else LLAMA_SLAB[(K, N)])
        assert p.grid == (math.ceil(T / p.tn), 1, N // 128)


def split_range(k_tiles, splits, split):
    """(first K tile, K tiles) of split `split`, as the mainloop cuts K
    (`csrc/gemm_common.cuh`): evenly, the first `k_tiles % splits` splits
    one tile longer."""
    base, rem = divmod(k_tiles, splits)
    return split * base + min(split, rem), base + (1 if split < rem else 0)


def dense_tile_row(layer, K, k0):
    """B13: the row of the stack's [L * K, N] weight map where the layer's
    K tile starting at k0 lies, as the mainloop reads it (`layer * K + k0`)."""
    return layer * K + k0


@pytest.mark.parametrize("k_tiles,splits", [(32, 4), (112, 4), (7, 3), (4, 2), (1, 1)])
def test_split_range_covers_k_once(k_tiles, splits):
    seen = []
    for sp in range(splits):
        b, c = split_range(k_tiles, splits, sp)
        assert c >= k_tiles // splits
        seen += list(range(b, b + c))
    assert seen == list(range(k_tiles))


def test_dense_tile_row_is_the_layer_row():
    """Row layer * K + k0 of the stack read as [L * K, N] rows is row k0 of
    w[layer]."""
    L, K, N = 3, 256, 128
    w = torch.arange(L * K * N, dtype=torch.float32).reshape(L, K, N)
    rows = w.reshape(L * K, N)
    for layer in range(L):
        assert dense_tile_row(layer, K, 0) == layer * K
        for k0 in (0, 64, 128, 192):
            assert torch.equal(rows[dense_tile_row(layer, K, k0)], w[layer, k0])


@pytest.mark.parametrize("T,K,N", [(5, 512, 256), (16, 512, 128), (70, 256, 384),
                                   (130, 384, 128)])
def test_dense_walk_emulated(T, K, N):
    """The planned walk, each tile multiplied on the CPU at the planned
    coordinates of the stack's [L * K, N] rows (split-K partials summed in
    split order, as the last block of a tile sums them), assembles
    `dense_matmul_stacked_plain`."""
    from chitu_tpu_torch.ops import dense_gemm_kernels as dg

    rng = np.random.default_rng(1)
    L, layer = 3, 2
    w = torch.tensor(rng.standard_normal((L, K, N)), dtype=torch.float32).bfloat16()
    x = torch.tensor(rng.standard_normal((T, K)), dtype=torch.float32).bfloat16()
    p = gp.dense_plan(T, K, N, SMS)
    if T == 16:
        assert p.splits == 2  # the walk covers a split
    rows = w.float().reshape(L * K, N)
    xf = x.float()
    out = torch.zeros((T, N))
    k_tiles = K // p.bk
    row_tiles = [(0, T)] if p.regime == "decode" else [
        (m, min(m + p.tn, T)) for m in range(0, T, p.tn)]
    for m0, m1 in row_tiles:
        for bx in range(p.col_tiles):
            cols = slice(bx * 128, (bx + 1) * 128)
            for sp in range(p.splits):
                b, c = split_range(k_tiles, p.splits, sp)
                part = torch.zeros((m1 - m0, 128))
                for kt in range(b, b + c):
                    r = dense_tile_row(layer, K, kt * p.bk)
                    part += xf[m0:m1, kt * p.bk:(kt + 1) * p.bk] @ rows[r:r + p.bk, cols]
                out[m0:m1, cols] += part
    want = dg.dense_matmul_stacked_plain(x, layer, w)
    torch.testing.assert_close(out, want, atol=1e-6 * want.abs().max().item(), rtol=1e-6)


# ---------------------------------------------------------------------------
# B10 (the W8A8 int8 GEMM) on the same mainloop: int8 tiles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,K,N", [
    (16, 4096, 28672), (16, 4096, 6144), (16, 14336, 4096), (1, 4096, 6144),
    (64, 4096, 6144), (65, 4096, 6144), (512, 4096, 28672), (512, 14336, 4096),
    (5, 300, 200), (130, 96, 72), (33, 513, 1030),
])
def test_int8_plan(T, K, N):
    """K tiles of 256 bytes at decode and 128 at the slab (multiples of
    wgmma's 32-byte s8 step); the decode's K splits partition the K tiles
    exactly;
    the split-K workspace holds a partial tile a split; tensor maps only
    for rows a whole number of 16 bytes."""
    p = gp.int8_plan(T, K, N, SMS, w_ptr=256, x_ptr=512)
    assert p.bk % 32 == 0
    assert p.bk == (gp.INT8_DECODE_BK if p.regime == "decode" else gp.INT8_SLAB_BK)
    cols = math.ceil(N / 128)
    assert p.col_tiles == cols
    tn = gp.token_tile(T) or gp.slab_rows(T, cols, SMS)
    assert p.tn == tn and p.regime == ("decode" if tn <= 64 else "slab")
    k_tiles = math.ceil(K / p.bk)
    if p.regime == "decode":
        assert p.splits == gp.decode_splits(cols, k_tiles, SMS)
        assert p.grid == (p.splits, 1, cols)
    else:
        assert p.splits == 1 and p.grid == (math.ceil(T / tn), 1, cols)
    runs = [split_range(k_tiles, p.splits, s) for s in range(p.splits)]
    assert [t for b, c in runs for t in range(b, b + c)] == list(range(k_tiles))
    assert all(c >= 1 for _, c in runs)
    assert p.ws_floats == (cols * p.splits * tn * 128 if p.splits > 1 else 0)
    assert p.tma_x == (K % 16 == 0) and p.tma_w == (N % 16 == 0)
    assert not gp.int8_plan(T, K, N, SMS, w_ptr=8, x_ptr=512).tma_w


@pytest.mark.parametrize("splits", [1, 2, 3, 7, 16])
def test_split_range_partition(splits):
    """Every K tile in exactly one split, in order, the runs one tile apart
    in length at most (the kernel's partition, its last split included)."""
    for k_tiles in range(splits, 130):
        runs = [split_range(k_tiles, splits, s) for s in range(splits)]
        assert [t for b, c in runs for t in range(b, b + c)] == list(range(k_tiles))
        lens = [c for _, c in runs]
        assert max(lens) - min(lens) <= 1 and min(lens) >= 1
