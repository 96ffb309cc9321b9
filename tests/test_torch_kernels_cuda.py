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
