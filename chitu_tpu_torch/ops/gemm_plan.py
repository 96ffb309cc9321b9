"""Host-side planning of the shared Hopper GEMM mainloop
(`csrc/gemm_common.cuh`) that the dequant GEMM (B6+B7) and the W8A8 int8
GEMM (B10, `ops/quant_gemm_kernels.py`), the grouped expert GEMM (B8,
`ops/moe_gemm_kernels.py`) and the dense stacked-layer GEMM (B13,
`ops/dense_gemm_kernels.py`) launch, and of the MLA absorb kernel's item
walk (B9, `ops/absorb_kernels.py`, `csrc/absorb.cu`): plain functions of
shapes (and, for the tensor maps, of pointers), so the CPU tests reach
them.

- The regime and the rows a tile: at most `DECODE_ROWS` rows run the
  decode tiles, which swap A and B (64 weight columns a warpgroup as
  wgmma's M, the rows as its N, padded to a token tile of 16, 32 or 64)
  with a K tile of 128; more rows run slab tiles of 128 or 256 rows by 128
  columns with a K tile of 64 (256 where that takes fewer waves of blocks:
  one converted weight tile then serves twice the rows).
- The split count of the decode tiles, from shapes and the SM count only
  (never from the routing), so a launch can be captured in a CUDA graph.
- Whether a tensor map can describe an operand (TMA wants a 16-byte
  aligned base and a row stride that is a multiple of 16 bytes), else the
  kernel's producer warp copies it through cp.async.
- The split-K workspace: partial tiles and ticket counters.
- B8's tile coordinates: the weight row of (layer, expert, K tile) in the
  stack's [L * E * K, N] rows, and where that tile's scale row lies.
- B9's walk: its items (head, 128-column tile), the run of items each
  persistent block takes, and each tile's row and column in the stacked
  wkv_b's [L * C, H * (dn + dv)] map.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

DECODE_ROWS = 64  # rows a decode tile takes; more run the slab tiles
TOKEN_TILES = (16, 32, 64)  # wgmma N of the decode tiles
DECODE_BK, SLAB_BK = 128, 64  # K tiles
INT8_DECODE_BK, INT8_SLAB_BK = 256, 128  # B10's K tiles (bytes): wgmma k32 steps
COL_TILE = 128  # output columns a block
MAX_SPLITS = 16
FILL_TILES = 2  # a block's ring fill and epilogue, in K tiles of work
QBLK = 128  # B8: K rows that share one scale row


def token_tile(rows: int) -> int:
    """wgmma N of the decode tile for `rows` rows; 0 = the slab tiles."""
    if rows > DECODE_ROWS:
        return 0
    return next(t for t in TOKEN_TILES if t >= rows)


# a 256-row slab tile's time over a 128-row tile's at the same K: the
# mainloop's tile time is set by the copies, the conversion and the
# barriers more than by the tensor cores (`chip_smoke.py` on an H100 80GB
# HBM3 at 700 W: 1.59 against 1.47 us a K tile, PERF.md)
SLAB_256_COST = 1.1


def slab_rows(rows: int, col_tiles: int, sms: int) -> int:
    """Rows a slab tile, the cheaper of 128 and 256 by waves of blocks
    (one block an SM) times the tile's relative time."""
    def cost(r, weight):
        return math.ceil(-(-rows // r) * col_tiles / sms) * weight

    return 256 if cost(256, SLAB_256_COST) < cost(128, 1.0) else 128


def k_tile(tile_rows: int) -> int:
    return SLAB_BK if tile_rows > DECODE_ROWS else DECODE_BK


def decode_splits(col_tiles: int, k_tiles: int, sms: int,
                  max_splits: int = MAX_SPLITS) -> int:
    """K splits of the decode tiles. One block runs an SM at a time, so s
    splits cost ceil(col_tiles * s / sms) waves of ceil(k_tiles / s) +
    FILL_TILES tiles; the cheapest s wins (the smallest on a tie), keeping
    at least two K tiles a split."""
    best, best_cost = 1, None
    for s in range(1, max(1, min(max_splits, k_tiles // 2)) + 1):
        cost = math.ceil(col_tiles * s / sms) * (math.ceil(k_tiles / s) + FILL_TILES)
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best


def tma_ok(ptr: int, row_bytes: int) -> bool:
    """Can a tensor map describe rows of `row_bytes` bytes from `ptr`?"""
    return ptr % 16 == 0 and row_bytes % 16 == 0


def blocks_tile(block: int, bk: int) -> bool:
    """Do quant blocks of `block` rows tile with K tiles of bk rows? (A
    multiple of the tile, or a divisor with at most bk / 32 blocks a
    tile: the scale rows a stage holds.)"""
    return block % bk == 0 or (bk % block == 0 and bk // block <= bk // 32)


@dataclass(frozen=True)
class GemmPlan:
    regime: str  # "decode" (A and B swapped) or "slab"
    tn: int  # rows a tile: the decode tiles' token tile, or 128 / 256
    bk: int  # K tile
    col_tiles: int  # grid.z
    groups: int  # grid.y (B8: dispatch blocks)
    row_tiles: int  # grid.x of the slab
    splits: int  # grid.x of the decode tiles
    tma_w: bool  # a tensor map loads the weight (else cp.async)
    tma_x: bool  # ... and x
    ws_floats: int  # split-K partial tiles (0: no split)
    tickets: int  # split-K counters

    @property
    def grid(self) -> Tuple[int, int, int]:
        return (self.row_tiles if self.regime == "slab" else self.splits,
                self.groups, self.col_tiles)


def _ws(tn, splits, tiles):
    return (tiles * splits * tn * COL_TILE if splits > 1 else 0), tiles


def quant_plan(T: int, K: int, N: int, packed: bool, sms: int,
               w_ptr: int = 0, x_ptr: int = 0) -> GemmPlan:
    """B6+B7 for x [T, K] bf16 and a one-layer weight of N logical columns
    (bytes: N a row, or N / 2 packed int4) at `w_ptr`."""
    cols = N // COL_TILE if packed else -(-N // COL_TILE)
    tn = token_tile(T) or slab_rows(T, cols, sms)
    bk = k_tile(tn)
    decode = tn <= DECODE_ROWS
    splits = decode_splits(cols, -(-K // bk), sms) if decode else 1
    ws, tickets = _ws(tn, splits, cols)
    return GemmPlan(
        regime="decode" if decode else "slab", tn=tn, bk=bk, col_tiles=cols,
        groups=1, row_tiles=1 if decode else -(-T // tn), splits=splits,
        tma_w=tma_ok(w_ptr, N // 2 if packed else N), tma_x=tma_ok(x_ptr, 2 * K),
        ws_floats=ws, tickets=tickets,
    )


@functools.lru_cache(maxsize=1024)
def int8_plan(T: int, K: int, N: int, sms: int,
              w_ptr: int = 0, x_ptr: int = 0) -> GemmPlan:
    """B10 for x int8 [T, K] and an int8 weight [K, N] (`x_ptr`, `w_ptr`:
    their addresses, or the addresses' offsets from 16 bytes, all a tensor
    map asks of them): the dequant GEMM's tiles and splits with K tiles of
    256 bytes at decode and 128 at the slab (wgmma's s8 step is 32 bytes
    deep); a tensor map takes rows whose bytes (K for x, N for W) are a
    multiple of 16 from an aligned base. Memoized."""
    cols = -(-N // COL_TILE)
    tn = token_tile(T) or slab_rows(T, cols, sms)
    decode = tn <= DECODE_ROWS
    bk = INT8_DECODE_BK if decode else INT8_SLAB_BK
    splits = decode_splits(cols, -(-K // bk), sms) if decode else 1
    ws, tickets = _ws(tn, splits, cols)
    return GemmPlan(
        regime="decode" if decode else "slab", tn=tn, bk=bk, col_tiles=cols,
        groups=1, row_tiles=1 if decode else -(-T // tn), splits=splits,
        tma_w=tma_ok(w_ptr, N), tma_x=tma_ok(x_ptr, K),
        ws_floats=ws, tickets=tickets,
    )


@functools.lru_cache(maxsize=1024)
def dense_plan(T: int, K: int, N: int, sms: int,
               w_ptr: int = 0, x_ptr: int = 0) -> GemmPlan:
    """B13 for x [T, K] bf16 at `x_ptr` and a bf16 stack [L, K, N] at
    `w_ptr`: the dequant GEMM's plan for a bf16 weight (no conversion, the
    same tiles, splits and slab rows). The wrapper hands the kernel aligned
    operands, so both go by tensor map. Memoized: a decode step asks for
    the same few plans again and again."""
    return quant_plan(T, K, N, False, sms, w_ptr, x_ptr)


def moe_plan(NB: int, bm: int, E: int, K: int, N: int, sms: int) -> GemmPlan:
    """B8 for NB dispatch blocks of bm rows over E experts [K, N]. At most
    min(E, NB) blocks are live, so the split count counts their column
    tiles. A tile is one dispatch block (bm rows). Every operand is 16-byte
    aligned with K and N multiples of 128: tensor maps describe them all."""
    tn = bm
    bk = k_tile(tn)
    cols = N // COL_TILE
    decode = tn <= DECODE_ROWS
    splits = decode_splits(min(E, NB) * cols, K // bk, sms) if decode else 1
    ws, tickets = _ws(tn, splits, NB * cols)
    return GemmPlan(
        regime="decode" if decode else "slab", tn=tn, bk=bk, col_tiles=cols,
        groups=NB, row_tiles=1, splits=splits,
        tma_w=True, tma_x=True, ws_floats=ws, tickets=tickets,
    )


def moe_tile_coords(layer: int, E: int, e: int, K: int, k_index: int,
                    bk: int, scale_ld: int) -> Optional[Tuple[int, int]]:
    """Where B8's block of expert `e` finds its k_index-th K tile: (the row
    of the stack's [L * E * K, N] weight map, the float offset of the
    tile's scale row in the stack's [L, E, K/128, scale_ld] scales); None
    for a dead block (e < 0 or e >= E), which reads nothing."""
    if e < 0 or e >= E:
        return None
    expert = layer * E + e
    k0 = k_index * bk
    return expert * K + k0, (expert * (K // QBLK) + k0 // QBLK) * scale_ld


AB_TILE = 128  # B9: K tile, and output columns an item
AB_MAX_T = 128  # B9: the model's gate (the largest token tile)


@dataclass(frozen=True)
class AbsorbPlan:
    kind: str  # "uk" or "uv"
    tn: int  # token tile (wgmma N): 16, 32, 64, or 128 (the slab tile)
    nk: int  # K tiles an item: dn / 128 (uk) or C / 128 (uv)
    ncol: int  # column tiles a head: C / 128 (uk) or dv / 128 (uv)
    items: int  # H * ncol
    per_block: int  # items a persistent block walks
    blocks: int  # grid.x

    @property
    def regime(self) -> str:
        return "slab" if self.tn > DECODE_ROWS else "decode"


@functools.lru_cache(maxsize=1024)
def absorb_plan(T: int, H: int, C: int, dn: int, dv: int, kind: str,
                sms: int) -> AbsorbPlan:
    """B9's launch for x [T, H, K] against the stacked wkv_b [L, C, H * (dn
    + dv)]: items (head, 128-column tile) ordered head-major, a block
    taking a contiguous run of ceil(items / sms) of them, so about one
    block an SM walks several items through one TMA ring. Memoized."""
    if kind not in ("uk", "uv"):
        raise ValueError(f"kind {kind!r}")
    K, N = (dn, C) if kind == "uk" else (C, dv)
    if T < 1 or T > AB_MAX_T or K % AB_TILE or N % AB_TILE or dn % AB_TILE \
            or dv % AB_TILE:
        raise NotImplementedError(
            f"absorb_matmul: T {T} (1..{AB_MAX_T}), C {C}, dn {dn} and dv {dv} "
            f"(multiples of {AB_TILE})")
    tn = token_tile(T) or AB_MAX_T
    ncol = N // AB_TILE
    items = H * ncol
    per_block = -(-items // sms)
    return AbsorbPlan(kind=kind, tn=tn, nk=K // AB_TILE, ncol=ncol, items=items,
                      per_block=per_block, blocks=-(-items // per_block))


def absorb_items(plan: AbsorbPlan, block: int):
    """The (head, column tile) items block `block` walks, in order."""
    end = min((block + 1) * plan.per_block, plan.items)
    return [divmod(u, plan.ncol) for u in range(block * plan.per_block, end)]


def absorb_tile(kind: str, layer: int, C: int, dn: int, dv: int, h: int,
                ct: int, j: int) -> Tuple[int, int, int]:
    """Where K tile j of item (h, ct) lies: (its first row and first column
    in the stacked wkv_b's [L * C, H * (dn + dv)] map, the first lane of x
    [T, H, K] it multiplies). uk: the item's 128 c rows at the head's dn
    lanes h * S + 128 j; uv: K tile j's 128 c rows at the head's dv lanes
    h * S + dn + 128 ct."""
    S = dn + dv
    if kind == "uk":
        return layer * C + ct * AB_TILE, h * S + j * AB_TILE, j * AB_TILE
    return layer * C + j * AB_TILE, h * S + dn + ct * AB_TILE, j * AB_TILE


class Workspace:
    """The split-K workspace of one kernel on one device, grown on demand:
    partial tiles (f32) and ticket counters that every launch leaves at
    zero. Launches that run in order (one stream, as the port launches
    them) share it; launches on different streams must not overlap. It
    must be large enough before a CUDA graph is captured."""

    def __init__(self):
        self._bufs = {}

    def get(self, torch, dev, floats: int, tickets: int):
        ws, counters = self._bufs.get(dev.index, (None, None))
        if ws is None or ws.numel() < floats or counters.numel() < tickets:
            if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "the split-K workspace must exist before a CUDA graph is "
                    "captured: run the call once beforehand"
                )
            old_f = ws.numel() if ws is not None else 0
            old_t = counters.numel() if counters is not None else 0
            ws = torch.empty((max(floats, old_f, 1),), dtype=torch.float32, device=dev)
            counters = torch.zeros((max(tickets, old_t, 1),), dtype=torch.int32,
                                   device=dev)
            self._bufs[dev.index] = (ws, counters)
        return ws, counters


_SMS = {}


def sm_count(torch, dev) -> int:
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[dev.index]
