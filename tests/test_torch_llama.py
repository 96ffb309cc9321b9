"""chitu_tpu_torch/models/llama.py against chitu_tpu/models/llama.py:
logits of prefill (two chunks, the second at q_pos > 0), decode,
prefill_packed and step_hybrid on the same f32 weights, carried across by
`params_from_numpy`, from the same token ids, with the KV pool threaded
through all four in order.

The JAX model runs twice: attn_impl="xla" (the jnp oracle) and
attn_impl="pallas" (the Pallas kernels in interpret mode, the fused
decode and fused packed-prefill paths included: q blocks of 16 = page).
Tolerances: against xla, logits and pool to 1e-4 (f32 on both sides,
sums in another order); against pallas, 5e-3 on both (the Pallas
kernels round q, K/V and probabilities to bf16 inside attention, and that
error flows into the later layers' K/V; measured up to 3e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chitu_tpu.config import load_config as jload
from chitu_tpu.models import build_model as jbuild
from chitu_tpu_torch.config import load_config as tload
from chitu_tpu_torch.models import build_model as tbuild
from chitu_tpu_torch.models.llama import params_from_numpy


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


PAGE = 16
MP = 8
OVR = [
    "models=micro-llama-debug", "models.n_layers=2", "models.dim=256",
    "models.n_heads=4", "models.n_kv_heads=2", "models.head_dim=128",
    "models.inter_dim=512", "models.vocab_size=512",
    "infer.max_seq_len=128", "infer.page_size=16", "infer.max_reqs=4",
]
TOL = {"xla": (1e-4, 1e-4), "pallas": (5e-3, 5e-3)}  # (logits, pool)


class _Jax:
    def __init__(self, model, params, pool, impl):
        self.m, self.p, self.impl = model, params, impl
        self.cache = {"kv": jnp.asarray(pool)}

    def prefill(self, tokens, bt, start, n):
        out, self.cache = self.m.prefill(
            self.p, self.cache, jnp.asarray(tokens), jnp.asarray(bt),
            jnp.int32(start), jnp.int32(n), PAGE, attn_impl=self.impl,
        )
        return np.asarray(out)

    def decode(self, *a):
        out, self.cache = self.m.decode(
            self.p, self.cache, *map(jnp.asarray, a), PAGE,
            attn_impl=self.impl,
        )
        return np.asarray(out)

    def prefill_packed(self, *a):
        out, self.cache = self.m.prefill_packed(
            self.p, self.cache, *map(jnp.asarray, a), PAGE,
            attn_impl=self.impl,
        )
        return np.asarray(out)

    def step_hybrid(self, *a):
        od, op, self.cache = self.m.step_hybrid(
            self.p, self.cache, *map(jnp.asarray, a), PAGE,
            attn_impl=self.impl,
        )
        return np.concatenate([np.asarray(od), np.asarray(op)])

    def pool(self):
        return np.asarray(self.cache["kv"])


class _Torch:
    def __init__(self, model, pool):
        self.m = model
        self.cache = {"kv": torch.from_numpy(pool.copy())}

    def prefill(self, tokens, bt, start, n):
        out, _ = self.m.prefill(
            self.cache, torch.from_numpy(tokens), torch.from_numpy(bt),
            start, n, PAGE,
        )
        return out.numpy()

    def decode(self, *a):
        out, _ = self.m.decode(self.cache, *map(torch.from_numpy, a), PAGE)
        return out.numpy()

    def prefill_packed(self, *a):
        out, _ = self.m.prefill_packed(
            self.cache, *map(torch.from_numpy, a), PAGE
        )
        return out.numpy()

    def step_hybrid(self, *a):
        od, op, _ = self.m.step_hybrid(
            self.cache, *map(torch.from_numpy, a), PAGE
        )
        return np.concatenate([od.numpy(), op.numpy()])

    def pool(self):
        return self.cache["kv"].numpy()


def _bt(*pages):
    bt = np.full((len(pages), MP), -1, np.int32)
    for i, p in enumerate(pages):
        bt[i, : len(p)] = p
    return bt


def _slab(segs, Tq, NB, R):
    """Packed slab as the executor builds it: segs = [(tokens, start)]."""
    T = Tq * NB
    tok = np.zeros((T,), np.int32)
    seg_ids = np.full((T,), -1, np.int32)
    pos = np.full((T,), -1, np.int32)
    bseg = np.full((NB,), -1, np.int32)
    bq = np.zeros((NB,), np.int32)
    total = np.zeros((R,), np.int32)
    last = np.zeros((R,), np.int32)
    off = 0
    for r, (ids, s) in enumerate(segs):
        n = len(ids)
        tok[off : off + n] = ids
        seg_ids[off : off + n] = r
        pos[off : off + n] = np.arange(s, s + n)
        total[r], last[r] = s + n, off + n - 1
        nb = (n + Tq - 1) // Tq
        bseg[off // Tq : off // Tq + nb] = r
        bq[off // Tq : off // Tq + nb] = s + np.arange(nb) * Tq
        off += nb * Tq
    return tok, seg_ids, pos, total, last, bseg, bq


def _script(run, rng):
    """The four forwards in order; returns {phase: (logits, rows)} where
    rows are the logits rows that every implementation defines."""
    V = 512
    ids = lambda n: rng.integers(1, V, size=n).astype(np.int32)
    out = {}
    p0 = ids(32)
    t1 = np.zeros((32,), np.int32)
    t1[:20] = p0[:20]
    bt0 = _bt(range(0, 8))[0]
    run.prefill(t1, bt0, 0, 20)
    t2 = np.zeros((16,), np.int32)
    t2[:12] = p0[20:32]
    out["prefill"] = (run.prefill(t2, bt0, 20, 12)[None], [0])

    # decode: request 0 at position 32 plus one padded row
    out["decode"] = (
        run.decode(
            np.array([ids(1)[0], 0], np.int32), np.array([32, 0], np.int32),
            _bt(range(0, 8), []), np.array([True, False]),
        ),
        [0],
    )

    # packed prefill: two prompts (q blocks of 16 = page), a dead block,
    # and an empty third segment
    p1, p2 = ids(21), ids(9)
    slab = _slab([(p1, 0), (p2, 0)], 16, 4, 3)
    out["prefill_packed"] = (
        run.prefill_packed(
            slab[0], slab[1], slab[2], _bt(range(8, 16), range(16, 24), []),
            slab[3], slab[4], slab[5], slab[6],
        ),
        [0, 1],
    )

    # hybrid: requests 0 and 1 decode while request 3 prefills
    p3 = ids(13)
    slab = _slab([(p3, 0)], 16, 2, 2)
    out["step_hybrid"] = (
        run.step_hybrid(
            np.array([ids(1)[0], ids(1)[0]], np.int32),
            np.array([33, 21], np.int32),
            _bt(range(0, 8), range(8, 16)), np.array([True, True]),
            slab[0], slab[1], slab[2], _bt(range(24, 32), []), slab[3],
            slab[4], slab[5], slab[6],
        ),
        [0, 1, 2],
    )
    out["pool"] = run.pool()
    return out


@pytest.fixture(scope="module")
def runs():
    jcfg = jload(overrides=OVR)
    tcfg = tload(overrides=OVR)
    jm = jbuild(jcfg.models, jcfg)
    params = jm.init_params(jax.random.PRNGKey(0), jnp.float32)
    tm = tbuild(tcfg.models, tcfg, device="cpu")
    tm.load_params(params_from_numpy(jax.tree_util.tree_map(np.asarray, params)))
    L, M = jcfg.models.n_layers, 2 * 2 * 128
    pool = np.zeros((L, 40, PAGE, M), np.float32)
    res = {"torch": _script(_Torch(tm, pool), np.random.default_rng(0))}
    for impl in ("xla", "pallas"):
        res[impl] = _script(
            _Jax(jm, params, pool, impl), np.random.default_rng(0)
        )
    return res


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize(
    "phase", ["prefill", "decode", "prefill_packed", "step_hybrid"]
)
def test_logits_match_jax(runs, impl, phase):
    got, rows = runs["torch"][phase]
    want, _ = runs[impl][phase]
    tol = TOL[impl][0]
    np.testing.assert_allclose(got[rows], want[rows], atol=tol, rtol=tol)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_pool_matches_jax(runs, impl):
    tol = TOL[impl][1]
    np.testing.assert_allclose(
        runs["torch"]["pool"], runs[impl]["pool"], atol=tol, rtol=tol
    )


def test_params_from_numpy_bf16_and_unmerged():
    """bf16 `ml_dtypes` leaves cross via uint16 views, bit for bit, and an
    unmerged JAX tree merges into wqkv / w_gate_up."""
    cfg = jload(overrides=OVR + ["infer.merge_qkv_gate_up=off"])
    jm = jbuild(cfg.models, cfg)
    tree = jax.tree_util.tree_map(
        np.asarray, jm.init_params(jax.random.PRNGKey(1), jnp.bfloat16)
    )
    got = params_from_numpy(tree)
    assert got["wqkv"].dtype == torch.bfloat16
    lay = tree["layers"]
    want = np.concatenate([lay["wq"], lay["wk"], lay["wv"]], axis=-1)
    np.testing.assert_array_equal(
        got["wqkv"].view(torch.int16).numpy(), want.view(np.int16)
    )
    want = np.concatenate([lay["w_gate"], lay["w_up"]], axis=-1)
    np.testing.assert_array_equal(
        got["w_gate_up"].view(torch.int16).numpy(), want.view(np.int16)
    )


# ---------------------------------------------------------------------------
# Quantized trees: quantized by the JAX package, carried across by
# `params_from_numpy`, the logits of a prefill chunk and a decode step held
# against the JAX model under op_impl "xla" (dequantize + dot) and "pallas"
# (the Pallas GEMMs in interpret mode). Attention runs through the jnp
# oracle on both sides. Activations are f32 here, so against "xla" only
# summation order differs (2e-3 covers it, the bf16-rounded weights
# included); the Pallas kernels round x to bf16 first, and 3e-2 covers
# that on logits of size about 1. Two cases get their own limit:
# - fp8 with e4m3 activations: rounding to 3 mantissa bits is a step
#   function, so the 1e-4 differences that summation order leaves between
#   the two models flip whole e4m3 steps (6-12 %) of single activations;
#   measured 1.7e-2 (xla) and 3.6e-2 (pallas), limit 6e-2. The rounding
#   itself equals the JAX function bit for bit (tests/test_torch_quant.py).
# - W8A8: the JAX model cannot run its int8-activation route (its `_ffn`
#   calls `.astype(x.dtype)` with x a `QuantizedActs`, an AttributeError
#   under op_impl "pallas" on any backend), so the port, which runs int8
#   activations, is held against the JAX model's "xla" route (dequantized
#   weight, unquantized activations): the difference is the activation
#   quantization itself, at most 1/254 of a row's largest value per
#   element; limit 3e-2. The port's int8 route is held to the Pallas int8
#   GEMM and quantizers module by module in tests/test_torch_quant.py.
# ---------------------------------------------------------------------------

import functools  # noqa: E402
import importlib  # noqa: E402

from chitu_tpu.ops import pallas_quant_gemm as jpqg  # noqa: E402
from chitu_tpu.quantize import transforms as jqt  # noqa: E402
from chitu_tpu_torch.ops import linear as tlinear  # noqa: E402
from chitu_tpu_torch.ops.qtensor import QTensor  # noqa: E402

jlinear = importlib.import_module("chitu_tpu.ops.linear")

QTOL = {"xla": 2e-3, "pallas": 3e-2}
QTOL_CASE = {"fp8_e4m3": 6e-2, "w8a8": 3e-2}
# name -> (quant.method, fp8_act, extra transform of the JAX tree, head)
QCASES = {
    "soft_fp8": ("soft_fp8", "int8", None, False),
    "soft_fp8_rowwise_head": (
        "soft_fp8", "int8", jqt.expand_fp8_scales_rowwise, True),
    "fp8_e4m3": ("fp8", "e4m3", None, False),
    "w8a16": ("w8a16", "int8", None, False),
    "w4a16": ("w4a16", "int8", None, False),
    "w4a16_packed": ("w4a16", "int8", jqt.pack_int4_storage, False),
    "w8a8": ("w8a8", "int8", None, False),
    "llmint8": ("llmint8", "int8", None, False),
}


class _QArgs:
    group_size = 128

    def __init__(self, method, quantize_head):
        self.method, self.quantize_head = method, quantize_head


@pytest.fixture
def jax_quant_modes(monkeypatch):
    """Sets op_impl / fp8_act of the JAX package (and fp8_act of the port)
    for one test and restores them afterwards: the test files of one
    worker share a process. Under "pallas" the stacked GEMM, which the JAX
    `linear` calls without its interpret flag, runs in interpret mode."""
    old = jlinear._OP_IMPL, jlinear.get_fp8_act(), tlinear.get_fp8_act()

    def set_(impl, act):
        jlinear.set_op_impl(impl)
        jlinear.set_fp8_act(act)
        tlinear.set_fp8_act(act)
        if impl == "pallas":
            monkeypatch.setattr(
                jpqg, "matmul_stacked",
                functools.partial(jpqg.matmul_stacked, interpret=True),
            )

    yield set_
    jlinear.set_op_impl(old[0])
    jlinear.set_fp8_act(old[1])
    tlinear.set_fp8_act(old[2])


def _quant_script(run, rng):
    ids = lambda n: rng.integers(1, 512, size=n).astype(np.int32)
    bt0 = _bt(range(0, 8))[0]
    t1 = np.zeros((32,), np.int32)
    t1[:20] = ids(20)
    out = {"prefill": run.prefill(t1, bt0, 0, 20)[None]}
    out["decode"] = run.decode(
        np.array([ids(1)[0], 0], np.int32), np.array([20, 0], np.int32),
        _bt(range(0, 8), []), np.array([True, False]),
    )[:1]
    return out


def _jax_w8a8_prefill():
    cfg = jload(overrides=OVR)
    jm = jbuild(cfg.models, cfg)
    params = jqt.quantize_params(
        jm.init_params(jax.random.PRNGKey(2), jnp.float32),
        _QArgs("w8a8", False), jm,
    )
    pool = np.zeros((cfg.models.n_layers, 40, PAGE, 2 * 2 * 128), np.float32)
    _Jax(jm, params, pool, "xla").prefill(
        np.ones((16,), np.int32), _bt(range(0, 8))[0], 0, 16
    )


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("case", sorted(QCASES))
def test_quantized_logits_match_jax(jax_quant_modes, case, impl):
    method, act, transform, head = QCASES[case]
    if method == "w8a8":
        with pytest.raises(AttributeError, match="QuantizedActs"):
            jax_quant_modes("pallas", act)
            _jax_w8a8_prefill()
        impl = "xla"
    jax_quant_modes(impl, act)
    jcfg = jload(overrides=OVR)
    tcfg = tload(overrides=OVR)
    jm = jbuild(jcfg.models, jcfg)
    params = jm.init_params(jax.random.PRNGKey(2), jnp.float32)
    params = jqt.quantize_params(params, _QArgs(method, head), jm)
    if transform is not None:
        params = transform(params)
    tm = tbuild(tcfg.models, tcfg, device="cpu")
    tm.load_params(params_from_numpy(jax.tree_util.tree_map(np.asarray, params)))
    assert all(isinstance(getattr(tm, n), QTensor)
               for n in ("wqkv", "wo", "w_gate_up", "w_down"))
    assert isinstance(tm.lm_head, QTensor) == head
    if case == "w4a16_packed":
        assert tm.wqkv.packed and tm.w_gate_up.packed and not tm.wo.packed
    pool = np.zeros((jcfg.models.n_layers, 40, PAGE, 2 * 2 * 128), np.float32)
    got = _quant_script(_Torch(tm, pool), np.random.default_rng(1))
    want = _quant_script(_Jax(jm, params, pool, "xla"), np.random.default_rng(1))
    for phase in ("prefill", "decode"):
        np.testing.assert_allclose(
            got[phase], want[phase], err_msg=phase,
            atol=QTOL_CASE.get(case, QTOL[impl]),
            rtol=QTOL_CASE.get(case, QTOL[impl]),
        )


def test_params_from_numpy_merges_unmerged_quantized_tree():
    """An unmerged JAX tree quantized leaf by leaf merges into wqkv /
    w_gate_up QTensors that dequantize to the concatenated parts."""
    cfg = jload(overrides=OVR + ["infer.merge_qkv_gate_up=off"])
    jm = jbuild(cfg.models, cfg)
    for method in ("soft_fp8", "w8a16", "w4a16"):
        params = jm.init_params(jax.random.PRNGKey(4), jnp.float32)
        params = jqt.pack_int4_storage(
            jqt.quantize_params(params, _QArgs(method, False), jm)
        )
        lay = params["layers"]
        got = params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
        for name, parts in (("wqkv", ("wq", "wk", "wv")),
                            ("w_gate_up", ("w_gate", "w_up"))):
            want = np.concatenate(
                [np.asarray(lay[p].dequantize(jnp.float32)) for p in parts],
                axis=-1,
            )
            assert isinstance(got[name], QTensor)
            np.testing.assert_array_equal(
                got[name].dequantize(torch.float32).numpy(), want
            )
