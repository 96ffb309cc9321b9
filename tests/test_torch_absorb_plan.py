"""The host-side plan of the MLA absorb kernel (B9, `csrc/absorb.cu`):
its items (head, 128-column tile), the run of items each persistent block
walks, and each tile's row and column in the stacked wkv_b's
[L * C, H * (dn + dv)] map (`chitu_tpu_torch/ops/gemm_plan.py`). Plain
functions of shapes, so they run here on the CPU; a walk emulated tile by
tile with `torch.matmul` must assemble `absorb_matmul_plain`."""

import numpy as np
import pytest
import torch

from chitu_tpu_torch.ops import absorb_kernels as ab
from chitu_tpu_torch.ops import gemm_plan as gp

SMS = 132


@pytest.mark.parametrize("label,H,kind,T,tn,nk,ncol,per_block,blocks", [
    ("R1", 128, "uk", 16, 16, 1, 4, 4, 128),  # 512 items, one head a block
    ("R1", 128, "uk", 1, 16, 1, 4, 4, 128),
    ("R1", 128, "uk", 128, 128, 1, 4, 4, 128),  # the 128-row slab tile
    ("R1", 128, "uv", 16, 16, 4, 1, 1, 128),  # 4 K tiles an item
    ("R1", 128, "uv", 100, 128, 4, 1, 1, 128),
    ("mid", 32, "uk", 16, 16, 1, 4, 1, 128),
    ("mid", 32, "uv", 40, 64, 4, 1, 1, 32),
    ("R1", 128, "uk", 64, 64, 1, 4, 4, 128),
    ("R1", 128, "uk", 65, 128, 1, 4, 4, 128),
    ("R1", 128, "uk", 17, 32, 1, 4, 4, 128),
])
def test_absorb_plan(label, H, kind, T, tn, nk, ncol, per_block, blocks):
    """DeepSeek-R1 (128 heads) and deepseek-mid-bench (32) on 132 SMs:
    wkv_b [L, 512, H * 256], dn = dv = 128."""
    p = gp.absorb_plan(T, H, 512, 128, 128, kind, SMS)
    assert (p.tn, p.nk, p.ncol, p.per_block, p.blocks) == (tn, nk, ncol, per_block, blocks)
    assert p.items == H * ncol and p.tn >= T
    assert p.regime == ("slab" if T > 64 else "decode")
    assert p.blocks <= SMS


@pytest.mark.parametrize("H,kind,sms", [(128, "uk", 132), (128, "uv", 132),
                                        (32, "uk", 132), (3, "uk", 2), (5, "uv", 3),
                                        (7, "uk", 114)])
def test_absorb_items_cover_each_once(H, kind, sms):
    """Every (head, column tile) is walked by exactly one block, head-major,
    each block a contiguous run."""
    C, dn, dv = 512, 128, 128
    p = gp.absorb_plan(16, H, C, dn, dv, kind, sms)
    walked = [it for b in range(p.blocks) for it in gp.absorb_items(p, b)]
    ncol = (C if kind == "uk" else dv) // 128
    assert walked == [(h, ct) for h in range(H) for ct in range(ncol)]
    assert all(1 <= len(gp.absorb_items(p, b)) <= p.per_block for b in range(p.blocks))


def test_absorb_tile_coords_land_on_the_heads_lanes():
    """The planned tile of the [L * C, H * S] map is the head's dn lanes
    (uk: rows = the item's c rows) or dv lanes (uv: rows = K tile j's c
    rows) of w[layer]."""
    L, C, H, dn, dv = 3, 256, 4, 128, 256
    S = dn + dv
    w = torch.arange(L * C * H * S, dtype=torch.float64).reshape(L, C, H * S)
    rows = w.reshape(L * C, H * S)
    wl = w.view(L, C, H, S)
    for layer, h, ct, j in [(0, 0, 0, 0), (2, 3, 1, 0), (1, 2, 1, 1)]:
        r, c, lane = gp.absorb_tile("uk", layer, C, dn, dv, h, ct, 0)
        assert (r, c, lane) == (layer * C + ct * 128, h * S, 0)
        assert torch.equal(rows[r:r + 128, c:c + 128],
                           wl[layer, ct * 128:(ct + 1) * 128, h, :dn])
        r, c, lane = gp.absorb_tile("uv", layer, C, dn, dv, h, ct, j)
        assert (r, c, lane) == (layer * C + j * 128, h * S + dn + ct * 128, j * 128)
        assert torch.equal(rows[r:r + 128, c:c + 128],
                           wl[layer, j * 128:(j + 1) * 128, h, dn + ct * 128:dn + (ct + 1) * 128])


def test_absorb_plan_rejects_what_the_kernel_cannot_take():
    with pytest.raises(NotImplementedError):
        gp.absorb_plan(129, 4, 512, 128, 128, "uk", SMS)
    with pytest.raises(NotImplementedError):
        gp.absorb_plan(4, 4, 80, 128, 128, "uk", SMS)  # C off the 128 tile
    with pytest.raises(NotImplementedError):
        gp.absorb_plan(4, 4, 512, 64, 128, "uv", SMS)
    with pytest.raises(ValueError):
        gp.absorb_plan(4, 4, 512, 128, 128, "uq", SMS)


@pytest.mark.parametrize("kind", ["uk", "uv"])
@pytest.mark.parametrize("T,H,sms", [(5, 3, 2), (70, 2, 132), (1, 4, 3)])
def test_absorb_walk_emulated(kind, T, H, sms):
    """Each block's items, each K tile multiplied on the CPU at the planned
    coordinates of the [L * C, H * S] map and of x, assemble
    `absorb_matmul_plain` (f32 throughout)."""
    rng = np.random.default_rng(2)
    L, C, dn, dv, layer = 2, 256, 128, 128, 1
    S = dn + dv
    w = torch.tensor(rng.standard_normal((L, C, H * S)), dtype=torch.float32)
    K = dn if kind == "uk" else C
    # uk reads q_nope as the model passes it: a view of wider rows
    x = torch.tensor(rng.standard_normal((T, H, K + 64)), dtype=torch.float32)[..., :K]
    p = gp.absorb_plan(T, H, C, dn, dv, kind, sms)
    rows = w.reshape(L * C, H * S)
    out = torch.zeros((T, H, C if kind == "uk" else dv))
    for b in range(p.blocks):
        for h, ct in gp.absorb_items(p, b):
            acc = torch.zeros((T, 128))
            for j in range(p.nk):
                r, c, lane = gp.absorb_tile(kind, layer, C, dn, dv, h, ct, j)
                wt = rows[r:r + 128, c:c + 128]
                xt = x[:, h, lane:lane + 128]
                acc += xt @ (wt.T if kind == "uk" else wt)
            out[:, h, ct * 128:(ct + 1) * 128] = acc
    want = ab.absorb_matmul_plain(x, w, layer, kind, dn, dv)
    torch.testing.assert_close(out, want, atol=1e-6 * want.abs().max().item(), rtol=1e-6)
