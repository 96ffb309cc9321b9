"""The port's MoE modules against the JAX package, on the CPU, from
numpy-seeded inputs:

- `chitu_tpu_torch/models/moe.py` against `chitu_tpu/models/moe.py`:
  `route` (sel equal, weights to 1e-6), `dispatch_geometry` (equal),
  `sorted_dispatch` (row_assign and block_expert equal element for element,
  at the size of the JAX counting sort, A = 32, and of its argsort, A =
  1024, and for skewed routing), `sorted_combine` (1e-6, at both of the JAX
  function's formulations, T <= 128 and T > 128), `moe_ffn_sorted`,
  `moe_ffn` and `moe_ffn_ref` against their namesakes;
- `ops/moe_gemm_kernels.grouped_matmul_plain` (what the CUDA wrapper runs
  for CPU tensors) against the Pallas grouped kernel in interpret mode:
  bf16 weights to 1e-2 (bf16 outputs of about 1: one bf16 step is 8e-3),
  e4m3 weights to atol = rtol = 2e-2 (the Pallas kernel scales the f32
  block sums, the plain version rounds the scaled weight to bf16 first:
  the tolerance of the dequant GEMM's tests); dead blocks exactly zero;
- `quantize_params` on 4-D leaves and `merge_moe_gate_up` against the JAX
  functions: bytes and scales equal (to the last bit of the scales where
  the JAX side quantizes under jit, as tests/test_torch_quant.py explains),
  the ineligible pairs left split; `maybe_fp8_act` equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chitu_tpu.config import MoEArgs as JMoEArgs
from chitu_tpu.models import moe as jmoe
from chitu_tpu.ops import pallas_moe_gemm as jpmg
from chitu_tpu.ops.qtensor import QuantKind as JKind
from chitu_tpu.quantize import transforms as jqt
from chitu_tpu_torch.config import MoEArgs
from chitu_tpu_torch.models import moe as tmoe
from chitu_tpu_torch.models.llama import qtensor_from_numpy
from chitu_tpu_torch.ops import linear as tlinear
from chitu_tpu_torch.ops import moe_gemm_kernels as tmg
from chitu_tpu_torch.ops.qtensor import QTensor, QuantKind
from chitu_tpu_torch.quantize import transforms as tqt

import importlib


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


jlinear = importlib.import_module("chitu_tpu.ops.linear")

T, K, E, D, F = 16, 2, 8, 128, 256


def _rng(seed=0):
    return np.random.default_rng(seed)


def _np(a):
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a


def _tnp(t):
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy()
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy()


def _tq(jq) -> QTensor:
    """A JAX QTensor -> the port's, byte for byte."""
    return qtensor_from_numpy(jax.tree_util.tree_map(np.asarray, jq))


def _setup(seed=0, t=T):
    r = _rng(seed)
    x = (r.standard_normal((t, D)) * 0.5).astype(np.float32)
    sel = np.stack([r.permutation(E)[:K] for _ in range(t)]).astype(np.int32)
    w = r.random((t, K)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    wg = (r.standard_normal((E, D, F)) * 0.05).astype(np.float32)
    wu = (r.standard_normal((E, D, F)) * 0.05).astype(np.float32)
    wd = (r.standard_normal((E, F, D)) * 0.05).astype(np.float32)
    return x, sel, w, wg, wu, wd


# ---------------------------------------------------------------------------
# route
# ---------------------------------------------------------------------------

ROUTES = {
    "softmax_top2": (
        dict(n_routed_experts=8, n_activated_experts=2, norm_topk_prob=True),
        8, False,
    ),
    "softmax_top2_raw": (
        dict(n_routed_experts=8, n_activated_experts=2, norm_topk_prob=False),
        8, False,
    ),
    "sigmoid_bias_groups": (
        dict(n_routed_experts=16, n_activated_experts=4, n_expert_groups=4,
             n_limited_groups=2, score_func="sigmoid", route_scale=2.5,
             norm_topk_prob=True),
        16, True,
    ),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_route_matches_jax(case):
    kw, n_exp, with_bias = ROUTES[case]
    r = _rng(1)
    x = (r.standard_normal((16, 32)) * 0.5).astype(np.float32)
    gate = (r.standard_normal((32, n_exp)) * 0.5).astype(np.float32)
    bias = (r.standard_normal((n_exp,)) * 0.1).astype(np.float32) if with_bias else None
    jw, jsel = jmoe.route(
        jnp.asarray(x), jnp.asarray(gate), JMoEArgs(**kw),
        gate_bias=None if bias is None else jnp.asarray(bias),
    )
    tw, tsel = tmoe.route(
        torch.from_numpy(x), torch.from_numpy(gate), MoEArgs(**kw),
        gate_bias=None if bias is None else torch.from_numpy(bias),
    )
    assert tsel.dtype == torch.int32 and tw.dtype == torch.float32
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "t,k,e", [(1, 2, 8), (16, 2, 8), (16, 2, 16), (64, 2, 8), (128, 2, 8),
              (512, 2, 8), (528, 2, 8), (512, 2, 16), (16, 8, 256), (3, 1, 4)],
)
def test_dispatch_geometry_and_capacity_equal_jax(t, k, e):
    assert tmoe.dispatch_geometry(t, k, e) == jmoe.dispatch_geometry(t, k, e)
    assert tmoe.expert_capacity(t, e, k) == jmoe.expert_capacity(t, e, k)
    assert tmoe.expert_capacity(t, e, k, 1.25) == jmoe.expert_capacity(t, e, k, 1.25)


def _sel(case, t, k, e, seed=3):
    r = _rng(seed)
    if case == "random":
        return np.stack([r.permutation(e)[:k] for _ in range(t)]).astype(np.int32)
    if case == "skewed":  # every token picks the same experts
        return np.tile(np.array([[0, 3, 5, 6][:k]], np.int32), (t, 1))
    if case == "one_expert_missing":
        return np.stack(
            [1 + r.permutation(e - 1)[:k] for _ in range(t)]).astype(np.int32)
    raise KeyError(case)


@pytest.mark.parametrize("case", ["random", "skewed", "one_expert_missing"])
@pytest.mark.parametrize("t", [16, 512], ids=["A32", "A1024"])
def test_sorted_dispatch_equals_jax(t, case):
    """Element for element, at the size of each of the JAX function's two
    formulations (counting sort for A <= 512, stable argsort above)."""
    sel = _sel(case, t, K, E)
    bm, NB = tmoe.dispatch_geometry(t, K, E)
    jra, jbe = jmoe.sorted_dispatch(jnp.asarray(sel), E, bm)
    tra, tbe = tmoe.sorted_dispatch(torch.from_numpy(sel), E, bm)
    assert tra.dtype == torch.int32 and tbe.dtype == torch.int32
    assert tra.shape == (NB * bm,) and tbe.shape == (NB,)
    np.testing.assert_array_equal(tra.numpy(), np.asarray(jra))
    np.testing.assert_array_equal(tbe.numpy(), np.asarray(jbe))


def test_sorted_dispatch_with_invalid_ids_equals_jax():
    """Ids >= n_experts (another shard's experts under expert parallelism)
    sort into the dispatch slot E_dispatch - 1."""
    sel = _sel("random", 16, K, E)
    sel = np.where(sel >= 4, 4, sel).astype(np.int32)  # experts 4.. invalid
    bm, _ = tmoe.dispatch_geometry(16, K, 5)
    jra, jbe = jmoe.sorted_dispatch(jnp.asarray(sel), 5, bm)
    tra, tbe = tmoe.sorted_dispatch(torch.from_numpy(sel), 5, bm)
    np.testing.assert_array_equal(tra.numpy(), np.asarray(jra))
    np.testing.assert_array_equal(tbe.numpy(), np.asarray(jbe))


@pytest.mark.parametrize("t", [16, 200], ids=["T16", "T200"])
def test_sorted_combine_matches_jax(t):
    """Both of the JAX function's formulations (one-hot dot for T <= 128,
    scatter-add above) against the port's gather; 1e-6: with k = 2 the two
    terms of a token add in either order to the same f32."""
    r = _rng(4)
    sel = _sel("random", t, K, E)
    bm, NB = tmoe.dispatch_geometry(t, K, E)
    rows = r.standard_normal((NB * bm, 64)).astype(np.float32)
    w = r.random((t, K)).astype(np.float32)
    jra, _ = jmoe.sorted_dispatch(jnp.asarray(sel), E, bm)
    want = jmoe.sorted_combine(jnp.asarray(rows), jra, jnp.asarray(w))
    tra, _ = tmoe.sorted_dispatch(torch.from_numpy(sel), E, bm)
    got = tmoe.sorted_combine(torch.from_numpy(rows), tra, torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == (t, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# the grouped GEMM's plain version against the interpreted Pallas kernel
# ---------------------------------------------------------------------------


def _stack_pair(mode, r, L=0):
    """(JAX weight, the port's weight) for one mode: [E, D, F] or, with L,
    [L, E, D, F]."""
    shape = ((L,) if L else ()) + (E, D, F)
    w = (r.standard_normal(shape) * 0.05).astype(np.float32)
    if mode == "bf16":
        jw = jnp.asarray(w).astype(jnp.bfloat16)
        return jw, torch.from_numpy(w).to(torch.bfloat16)
    jq = jqt.quantize_weight(jnp.asarray(w), JKind.SOFT_FP8)
    if mode == "e4m3_rowwise":
        jq = jqt.expand_fp8_scales_rowwise({"w": jq})["w"]
    return jq, _tq(jq)


@pytest.mark.parametrize("layers", [0, 3], ids=["unstacked", "stacked"])
@pytest.mark.parametrize("mode", ["bf16", "e4m3_blockwise", "e4m3_rowwise"])
def test_grouped_matmul_plain_matches_pallas(mode, layers):
    r = _rng(5)
    jw, tw = _stack_pair(mode, r, layers)
    sel = _sel("random", T, K, E)
    sel[sel == 6] = 2  # expert 6 idle: one more dead block
    bm, NB = tmoe.dispatch_geometry(T, K, E)
    tra, tbe = tmoe.sorted_dispatch(torch.from_numpy(sel), E, bm)
    xs = (r.standard_normal((NB * bm, D)) * 0.5).astype(np.float32)
    txs = torch.from_numpy(xs).to(torch.bfloat16)
    jxs = jnp.asarray(xs).astype(jnp.bfloat16)
    tol = 1e-2 if mode == "bf16" else 2e-2
    for layer in ([0, 2] if layers else [0]):
        want = np.asarray(
            jpmg.grouped_matmul(
                jxs, jw, jnp.int32(layer), jnp.asarray(tbe.numpy()), bm,
                interpret=True,
            ).astype(jnp.float32)
        )
        got = tmg.grouped_matmul(txs, tw, layer, tbe, bm)
        assert got.dtype == torch.bfloat16 and got.shape == (NB * bm, F)
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)
        dead = np.repeat(tbe.numpy() < 0, bm)
        assert dead.any() and not got.float().numpy()[dead].any()
        assert not want[dead].any()


def test_kernel_eligible_equals_jax():
    r = _rng(6)
    for shape in [(E, 128, 256), (2, E, 256, 128), (E, 96, 256), (E, 128, 200)]:
        w = (r.standard_normal(shape) * 0.05).astype(np.float32)
        assert tmg.kernel_eligible(torch.from_numpy(w)) == jpmg.kernel_eligible(
            jnp.asarray(w))
        for kind in ("soft_fp8", "fp8", "w8a16", "w8a8", "w4a16"):
            jq = jqt.quantize_weight(jnp.asarray(w), JKind(kind))
            assert tmg.kernel_eligible(_tq(jq)) == jpmg.kernel_eligible(jq), (
                shape, kind)


# ---------------------------------------------------------------------------
# the FFN formulations
# ---------------------------------------------------------------------------


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-9))


@pytest.mark.parametrize("routing", ["random", "skewed"])
@pytest.mark.parametrize(
    "mode", ["bf16", "e4m3_blockwise", "e4m3_rowwise", "e4m3_merged"])
def test_moe_ffn_sorted_matches_jax(mode, routing):
    """Same rows, same experts, same order: the port's sorted FFN against
    the JAX one (Pallas kernel interpreted). bf16: 1e-2 of the output's
    norm (bf16 rounding of g, u and h at other last bits); e4m3: 2e-2 (the
    two dequant orders, as above)."""
    x, _, w, wg, wu, wd = _setup()
    sel = _sel(routing, T, K, E)
    r = _rng(7)
    if mode == "bf16":
        j = [jnp.asarray(a).astype(jnp.bfloat16) for a in (wg, wu, wd)]
        t = [torch.from_numpy(a).to(torch.bfloat16) for a in (wg, wu, wd)]
    else:
        q = lambda a: jqt.quantize_weight(jnp.asarray(a), JKind.SOFT_FP8)
        j = [q(wg), q(wu), q(wd)]
        if mode == "e4m3_rowwise":
            j = [jqt.expand_fp8_scales_rowwise({"w": a})["w"] for a in j]
        if mode == "e4m3_merged":  # the merge takes [L, E, ..] stacks
            j = [a[None] for a in j]
            m = jqt.merge_moe_gate_up({"w_gate": j[0], "w_up": j[1]})
            j = [m["w_gu"], None, j[2]]
        t = [None if a is None else _tq(a) for a in j]
    want = jmoe.moe_ffn_sorted(
        jnp.asarray(x).astype(jnp.bfloat16), j[0], j[1], j[2], jnp.asarray(w),
        jnp.asarray(sel), E, interpret=True,
    )
    got = tmoe.moe_ffn_sorted(
        torch.from_numpy(x).to(torch.bfloat16), t[0], t[1], t[2],
        torch.from_numpy(w), torch.from_numpy(sel), E,
    )
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), want.astype(jnp.float32)) < (
        1e-2 if mode == "bf16" else 2e-2)
    # and against the dense oracle on the unquantized weights
    ref = jmoe.moe_ffn_ref(
        jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wu), jnp.asarray(wd),
        jnp.asarray(w), jnp.asarray(sel),
    )
    assert _rel(got.float().numpy(), ref) < (0.03 if mode == "bf16" else 0.12)


def test_moe_ffn_sorted_stacked_layer_and_dead_experts_match_jax():
    """A [L, E, ..] stack indexed at layer 2, and ids >= n_experts marked
    invalid through e_dispatch (their blocks dead, their share missing)."""
    x, sel, w, *_ = _setup()
    r = _rng(8)
    L = 3
    ws = [(r.standard_normal(s) * 0.05).astype(np.float32)
          for s in ((L, E, D, F), (L, E, D, F), (L, E, F, D))]
    j = [jnp.asarray(a).astype(jnp.bfloat16) for a in ws]
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in ws]
    sl = np.where(sel >= 4, 4, sel).astype(np.int32)
    # only 4 experts are indexable: the stacks of the first four
    j4 = [a[:, :4] for a in j]
    t4 = [a[:, :4].contiguous() for a in t]
    want = jmoe.moe_ffn_sorted(
        jnp.asarray(x).astype(jnp.bfloat16), *j4, jnp.asarray(w),
        jnp.asarray(sl), 4, layer=jnp.int32(2), interpret=True, e_dispatch=5,
    )
    got = tmoe.moe_ffn_sorted(
        torch.from_numpy(x).to(torch.bfloat16), *t4, torch.from_numpy(w),
        torch.from_numpy(sl), 4, layer=2, e_dispatch=5,
    )
    assert _rel(got.float().numpy(), want.astype(jnp.float32)) < 1e-2
    full = tmoe.moe_ffn_sorted(
        torch.from_numpy(x).to(torch.bfloat16), *t, torch.from_numpy(w),
        torch.from_numpy(sel), E, layer=2,
    )
    assert _rel(got.float().numpy(), full.float().numpy()) > 0.1


@pytest.mark.parametrize("capacity", [16, 3], ids=["exact", "overflow"])
@pytest.mark.parametrize("kind", ["dense", "w8a16"])
def test_moe_ffn_capacity_matches_jax(kind, capacity):
    """The capacity-einsum route in f32, dense and with int8 experts
    (dequantized on both sides): 1e-4, sums in another order. With
    capacity 3 both drop the same overflowing assignments."""
    x, sel, w, wg, wu, wd = _setup(seed=9)
    if kind == "dense":
        j = [jnp.asarray(a) for a in (wg, wu, wd)]
        t = [torch.from_numpy(a) for a in (wg, wu, wd)]
    else:
        j = [jqt.quantize_weight(jnp.asarray(a), JKind.W8A16) for a in (wg, wu, wd)]
        t = [_tq(a) for a in j]
    want = jmoe.moe_ffn(
        jnp.asarray(x), *j, jnp.asarray(w), jnp.asarray(sel), capacity)
    got = tmoe.moe_ffn(
        torch.from_numpy(x), *t, torch.from_numpy(w), torch.from_numpy(sel),
        capacity)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_moe_ffn_ref_matches_jax():
    x, sel, w, wg, wu, wd = _setup(seed=10)
    want = jmoe.moe_ffn_ref(*map(jnp.asarray, (x, wg, wu, wd, w, sel)))
    got = tmoe.moe_ffn_ref(*map(torch.from_numpy, (x, wg, wu, wd, w, sel)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kind", ["soft_fp8", "w8a16", "w4a16"])
def test_moe_ffn_auto_picks_the_jax_route(kind, monkeypatch):
    """Eligible stacks (e4m3) go through the sorted path, the others
    through the capacity route, merged or split, as in the JAX package; the
    result matches the JAX `moe_ffn_auto` (2e-2 of the norm through the
    kernel, 1e-4 on the capacity route, where both dequantize)."""
    x, sel, w, wg, wu, wd = _setup(seed=11)
    args = dict(n_routed_experts=E, n_activated_experts=K)
    j = [jqt.quantize_weight(jnp.asarray(a[None]), JKind(kind))
         for a in (wg, wu, wd)]  # [1, E, ..] stacks, read at layer 0
    m = jqt.merge_moe_gate_up({"w_gate": j[0], "w_up": j[1]})
    if kind != "w4a16":
        j = [m["w_gu"], None, j[2]]
    t = [None if a is None else _tq(a) for a in j]
    routes = []
    monkeypatch.setattr(
        tmoe, "moe_ffn_sorted",
        lambda *a, _f=tmoe.moe_ffn_sorted, **kw: routes.append("sorted") or _f(*a, **kw))
    monkeypatch.setattr(
        tmoe, "moe_ffn",
        lambda *a, _f=tmoe.moe_ffn, **kw: routes.append("capacity") or _f(*a, **kw))
    xd = np.float32 if kind != "soft_fp8" else None
    jx = jnp.asarray(x) if xd else jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x) if xd else torch.from_numpy(x).to(torch.bfloat16)
    want = jmoe.moe_ffn_auto(
        jx, j[0], j[1], j[2], jnp.asarray(w), jnp.asarray(sel),
        JMoEArgs(**args), layer=0, interpret=True,
    )
    got = tmoe.moe_ffn_auto(
        tx, t[0], t[1], t[2], torch.from_numpy(w), torch.from_numpy(sel),
        MoEArgs(**args), layer=0,
    )
    assert routes == ["sorted" if kind == "soft_fp8" else "capacity"]
    assert jmoe._sorted_eligible(tuple(j)) == (kind == "soft_fp8")
    if kind == "soft_fp8":
        assert _rel(got.float().numpy(), want.astype(jnp.float32)) < 2e-2
    else:
        np.testing.assert_allclose(
            got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# quantization of 4-D leaves, the gate/up merge, the activation rounding
# ---------------------------------------------------------------------------


class _QArgs:
    group_size = 128
    quantize_head = False

    def __init__(self, method):
        self.method = method


def _assert_q_close(tq: QTensor, jq, exact):
    assert isinstance(tq, QTensor) and tq.kind.value == jq.kind.value
    assert tq.block == jq.block
    assert tuple(tq.data.shape) == tuple(jq.data.shape)
    if exact:
        np.testing.assert_array_equal(_tnp(tq.scale), np.asarray(jq.scale))
        np.testing.assert_array_equal(_tnp(tq.data), _np(jq.data))
    else:
        # the JAX side quantized under jit: last bit of the scales, and
        # the stored values that sat on a rounding tie
        np.testing.assert_allclose(
            _tnp(tq.scale), np.asarray(jq.scale), rtol=2.4e-7)
        assert (_tnp(tq.data) != _np(jq.data)).mean() <= 2e-3
    assert (tq.zeros is None) == (jq.zeros is None)


def _moe_tree(r, Fd=F):
    L = 2
    return {
        "embed": r.standard_normal((32, D)).astype(np.float32),
        "layers": {
            "ffn_norm": np.ones((L, D), np.float32),
            "wo": (r.standard_normal((L, D, D)) * 0.05).astype(np.float32),
            "moe_gate": (r.standard_normal((L, D, E)) * 0.05).astype(np.float32),
            "gate_bias": np.zeros((L, E), np.float32),
            "w_gate": (r.standard_normal((L, E, D, Fd)) * 0.05).astype(np.float32),
            "w_up": (r.standard_normal((L, E, D, Fd)) * 0.05).astype(np.float32),
            "w_down": (r.standard_normal((L, E, Fd, D)) * 0.05).astype(np.float32),
        },
    }


@pytest.mark.parametrize("method", ["soft_fp8", "fp8", "w8a16", "w8a8", "w4a16"])
def test_quantize_params_4d_and_merge_equal_jax(method):
    """Expert stacks quantize slab by slab to the JAX package's bytes and
    scales; router and bias stay dense; the pair merges for fp8 and int8
    kinds and stays split for W4A16."""
    tree = _moe_tree(_rng(12))
    jt = jqt.merge_moe_gate_up(jqt.quantize_params(
        jax.tree_util.tree_map(jnp.asarray, tree), _QArgs(method), None))
    tt = tqt.merge_moe_gate_up(tqt.quantize_params(
        jax.tree_util.tree_map(torch.from_numpy, tree), _QArgs(method), None))
    jl, tl = jt["layers"], tt["layers"]
    assert sorted(jl) == sorted(tl)
    assert ("w_gu" in tl) == (method != "w4a16")
    for name in ("ffn_norm", "moe_gate", "gate_bias"):
        assert isinstance(tl[name], torch.Tensor)
        np.testing.assert_array_equal(tl[name].numpy(), np.asarray(jl[name]))
    for name in tl:
        if isinstance(tl[name], QTensor):
            _assert_q_close(tl[name], jl[name], exact=False)
    if "w_gu" in tl:
        assert tuple(tl["w_gu"].data.shape) == (2, E, D, 2 * F)


def test_merge_moe_gate_up_equals_jax_on_equal_leaves():
    """The merge itself, on leaves carried across byte for byte: 4-D expert
    pairs, the 3-D pairs of the MLA family, and what must stay split."""
    r = _rng(13)
    q = lambda shape, kind: jqt.quantize_weight(
        jnp.asarray((r.standard_normal(shape) * 0.05).astype(np.float32)),
        JKind(kind))
    row = lambda a: jqt.expand_fp8_scales_rowwise({"w": a})["w"]
    dense = lambda shape: jnp.asarray(
        (r.standard_normal(shape) * 0.05).astype(np.float32))
    jt = {
        "layers": {
            "w_gate": q((2, E, D, F), "soft_fp8"), "w_up": q((2, E, D, F), "soft_fp8"),
            "wq_a": q((2, D, 128), "fp8"), "wkv_a": q((2, D, 64), "fp8"),
            "shared_gate": q((2, D, F), "w8a16"), "shared_up": q((2, D, F), "w8a16"),
        },
        "moe_layers": {
            "exp_gate": row(q((2, E, D, F), "fp8")), "exp_up": row(q((2, E, D, F), "fp8")),
        },
        "ragged": {  # the gate's out dim does not fill its last block
            "w_gate": q((2, E, D, 200), "soft_fp8"), "w_up": q((2, E, D, 200), "soft_fp8"),
        },
        "dense": {"w_gate": dense((2, E, D, F)), "w_up": dense((2, E, D, F))},
        "int4": {"w_gate": q((2, E, D, F), "w4a16"), "w_up": q((2, E, D, F), "w4a16")},
        "mixed": {"w_gate": q((2, E, D, F), "fp8"), "w_up": q((2, E, D, F), "soft_fp8")},
    }
    conv = lambda a: _tq(a) if hasattr(a, "kind") else torch.from_numpy(np.asarray(a))
    tt = {g: {k: conv(v) for k, v in leaves.items()} for g, leaves in jt.items()}
    for tp in (1, 2):
        jm = jqt.merge_moe_gate_up({g: dict(v) for g, v in jt.items()}, tp=tp)
        tm = tqt.merge_moe_gate_up({g: dict(v) for g, v in tt.items()}, tp=tp)
        for group in jm:
            assert sorted(jm[group]) == sorted(tm[group]), (group, tp)
            for name, leaf in tm[group].items():
                if isinstance(leaf, QTensor):
                    _assert_q_close(leaf, jm[group][name], exact=True)
        assert "w_gu" in tm["layers"] and "wq_kv_a" in tm["layers"]
        assert ("shared_gu" in tm["layers"]) == (tp == 1)
        assert "exp_gu" in tm["moe_layers"]
        for group in ("ragged", "dense", "int4", "mixed"):
            assert sorted(tm[group]) == ["w_gate", "w_up"]


@pytest.fixture
def fp8_act_modes():
    old = jlinear.get_fp8_act(), tlinear.get_fp8_act()

    def set_(act):
        jlinear.set_fp8_act(act)
        tlinear.set_fp8_act(act)

    yield set_
    jlinear.set_fp8_act(old[0])
    tlinear.set_fp8_act(old[1])


@pytest.mark.parametrize("act", ["int8", "e4m3"])
@pytest.mark.parametrize("kind", ["fp8", "soft_fp8", "dense"])
def test_maybe_fp8_act_equals_jax(fp8_act_modes, kind, act):
    """Rounds through e4m3 only for an FP8 weight under fp8_act=e4m3, and
    then to the JAX function's values bit for bit."""
    fp8_act_modes(act)
    r = _rng(14)
    x = (r.standard_normal((5, 256)) * 2).astype(np.float32)
    w = (r.standard_normal((E, 256, 128)) * 0.05).astype(np.float32)
    if kind == "dense":
        jw, tw = jnp.asarray(w), torch.from_numpy(w)
    else:
        jw = jqt.quantize_weight(jnp.asarray(w), JKind(kind))
        tw = _tq(jw)
    want = np.asarray(jlinear.maybe_fp8_act(jnp.asarray(x), jw))
    got = tlinear.maybe_fp8_act(torch.from_numpy(x), tw).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != x).any() == (kind == "fp8" and act == "e4m3")
