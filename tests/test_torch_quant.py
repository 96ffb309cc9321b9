"""The port's quantization modules against the JAX package, on the CPU,
from numpy-seeded inputs:

- `chitu_tpu_torch/quantize/transforms.py` against
  `chitu_tpu/quantize/transforms.py`: bytes, scales, zeros and indices
  EQUAL for every kind (both sides do the same f32 operations);
- `QTensor.dequantize` within 1 bf16 ulp (equal in practice);
- the plain GEMMs and activation quantizers (what the CUDA wrappers run
  for CPU tensors) against the Pallas kernels in interpret mode, at the
  tolerance of tests/test_pallas_quant_gemm.py (atol = rtol = 2e-2: the
  Pallas kernels scale the f32 block sums, the plain version rounds the
  scaled weight to bf16 first); int8 values equal but for 1-LSB ties;
- `ops.linear` with in_perm, outlier rows, int8 activations and a dense
  weight against the JAX `linear`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import functools
import importlib

from chitu_tpu.ops import pallas_norm_quant as jnq
from chitu_tpu.ops import pallas_quant_gemm as jpqg
from chitu_tpu.ops.qtensor import QTensor as JQTensor
from chitu_tpu.ops.qtensor import QuantKind as JKind
from chitu_tpu.quantize import transforms as jqt
from chitu_tpu_torch.models.llama import qtensor_from_numpy
from chitu_tpu_torch.ops import linear as tlinear
from chitu_tpu_torch.ops import norm_quant as tnq
from chitu_tpu_torch.ops import quant_gemm_kernels as tqg
from chitu_tpu_torch.ops.qtensor import QTensor, QuantKind
from chitu_tpu_torch.quantize import transforms as tqt


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


# the module: `chitu_tpu.ops.linear` as an attribute is the function
jlinear = importlib.import_module("chitu_tpu.ops.linear")

KINDS = ["soft_fp8", "fp8", "w8a16", "w8a8", "w4a16"]
SHAPES = [(300, 200), (128, 1024), (3, 256, 384), (2, 130, 72)]
TOL = 2e-2


def _w(shape, seed=0, scale=0.05):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32
    )


def _np(a):
    """jax array -> numpy, fp8 as its bytes."""
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a


def _tnp(t):
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _assert_q_equal(tq: QTensor, jq: JQTensor):
    assert tq.kind.value == jq.kind.value and tq.block == jq.block
    for name in ("data", "scale", "zeros", "in_perm", "oc_idx", "oc_w"):
        a, b = getattr(tq, name), getattr(jq, name)
        assert (a is None) == (b is None), name
        if a is None:
            continue
        b = np.asarray(b)
        if b.dtype.name == "bfloat16":
            b = b.view(np.int16)
        np.testing.assert_array_equal(_tnp(a), _np(b), err_msg=name)


def _assert_q_close(tq: QTensor, jq: JQTensor):
    """Equal but for the last bit of the scales and what follows from it.
    The JAX `quantize_params` runs `quantize_weight` under jit, where XLA
    turns the division by a constant (448, 127, 15) into a product with
    its rounded reciprocal: its scales differ from the eager JAX function's
    (and so from the port's) in the last bit, which moves a stored value
    that sat on a rounding tie by one step."""
    assert tq.kind.value == jq.kind.value and tq.block == jq.block
    np.testing.assert_allclose(tq.scale.numpy(), np.asarray(jq.scale), rtol=2.4e-7)
    for name in ("data", "zeros", "oc_idx"):
        a, b = getattr(tq, name), getattr(jq, name)
        assert (a is None) == (b is None), name
        if a is not None:
            a, b = _tnp(a), _np(b)
            assert a.shape == b.shape and a.dtype == b.dtype, name
            assert (a != b).mean() <= 2e-3, (name, (a != b).mean())
    if tq.oc_w is not None:
        np.testing.assert_array_equal(
            _tnp(tq.oc_w), np.asarray(jq.oc_w).view(np.int16)
        )


def _bf16_ulp_close(got: torch.Tensor, want):
    """Both bf16: equal or adjacent bf16 values."""
    a = got.view(torch.int16).numpy().astype(np.int32)
    b = np.asarray(want).view(np.int16).astype(np.int32)
    # order-preserving map of the sign-magnitude bits
    key = lambda v: np.where(v < 0, -(v & 0x7FFF), v)
    assert np.abs(key(a) - key(b)).max() <= 1


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("kind", KINDS)
def test_quantize_weight_equals_jax(kind, shape):
    w = _w(shape)
    tq = tqt.quantize_weight(torch.from_numpy(w), QuantKind(kind))
    jq = jqt.quantize_weight(jnp.asarray(w), JKind(kind))
    _assert_q_equal(tq, jq)
    _bf16_ulp_close(tq.dequantize(), jq.dequantize())
    if len(shape) == 3:  # the engine's layer-by-layer route gives the same
        ts = tqt.quantize_stacked(
            torch.from_numpy(w),
            lambda x: tqt.quantize_weight(x, QuantKind(kind)),
        )
        _assert_q_equal(ts, jq)


@pytest.mark.parametrize("kind", ["soft_fp8", "w4a16"])
@pytest.mark.parametrize("block", [32, 64])
def test_quantize_weight_other_block_sizes_equal_jax(kind, block):
    w = _w((2, 200, 136), seed=13)
    tq = tqt.quantize_weight(torch.from_numpy(w), QuantKind(kind), block)
    jq = jqt.quantize_weight(jnp.asarray(w), JKind(kind), block)
    _assert_q_equal(tq, jq)
    _bf16_ulp_close(tq.dequantize(), jq.dequantize())
    tx, jx = _x(3, 200)
    got = tqg.quant_gemm(tx, tq[1]).numpy()
    want = np.asarray(jnp.dot(jx, jq[1].dequantize(jnp.bfloat16),
                              preferred_element_type=jnp.float32))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("shape", [(1600, 96), (2, 256, 64)], ids=str)
def test_quantize_llmint8_equals_jax(shape):
    w = _w(shape, seed=1)
    tq = tqt.quantize_llmint8(torch.from_numpy(w))
    jq = jqt.quantize_llmint8(jnp.asarray(w))
    _assert_q_equal(tq, jq)
    assert tq.oc_idx.shape[-1] == 8
    _bf16_ulp_close(tq.dequantize(), jq.dequantize())


@pytest.mark.parametrize("shape", [(64, 1024), (2, 130, 512), (64, 200)], ids=str)
def test_pack_int4_storage_equals_jax(shape):
    w = _w(shape, seed=2)
    tq = tqt.pack_int4_storage(
        {"w": tqt.quantize_weight(torch.from_numpy(w), QuantKind.W4A16)}
    )["w"]
    jq = jqt.pack_int4_storage(
        {"w": jqt.quantize_weight(jnp.asarray(w), JKind.W4A16)}
    )["w"]
    _assert_q_equal(tq, jq)
    assert tq.packed == (shape[-1] % 512 == 0) == jqt.is_packed_int4(jq)
    assert tq.shape == shape
    _bf16_ulp_close(tq.dequantize(), jq.dequantize())
    if tq.packed:
        back = tqt.unpack_int4_storage(tq)
        _assert_q_equal(back, jqt.unpack_int4_storage(jq))


def test_expand_fp8_scales_rowwise_equals_jax():
    w = _w((2, 300, 200), seed=3)
    tq = tqt.expand_fp8_scales_rowwise(
        {"l": {"w": tqt.quantize_weight(torch.from_numpy(w), QuantKind.FP8)}}
    )["l"]["w"]
    jq = jqt.expand_fp8_scales_rowwise(
        {"l": {"w": jqt.quantize_weight(jnp.asarray(w), JKind.FP8)}}
    )["l"]["w"]
    _assert_q_equal(tq, jq)
    assert tq.scale.shape == (2, 3, 200)
    _bf16_ulp_close(tq.dequantize(), jq.dequantize())


def test_dequantize_in_perm_equals_jax():
    w = _w((256, 96), seed=4)
    perm = np.random.default_rng(4).permutation(256).astype(np.int32)
    jq = jqt.quantize_weight(jnp.asarray(w[perm]), JKind.W4A16)
    jq = JQTensor(data=jq.data, scale=jq.scale, zeros=jq.zeros, kind=jq.kind,
                  block=jq.block, in_perm=jnp.asarray(perm))
    tq = qtensor_from_numpy(jax.tree_util.tree_map(np.asarray, jq))
    _assert_q_equal(tq, jq)
    _bf16_ulp_close(tq.dequantize(), jq.dequantize())


@pytest.mark.parametrize("shape", [(4, 300), (2, 3, 256)], ids=str)
def test_fp8_act_roundtrip_equals_jax(shape):
    x = _w(shape, seed=5, scale=2.0)
    got = tqt.fp8_act_roundtrip(torch.from_numpy(x).to(torch.bfloat16))
    want = jqt.fp8_act_roundtrip(jnp.asarray(x, dtype=jnp.bfloat16))
    np.testing.assert_array_equal(_tnp(got), np.asarray(want).view(np.int16))


def _pair(kind, K, N, seed=0, rowwise=False, pack=False, layers=0):
    """The same quantized weight in both packages."""
    w = _w((layers, K, N) if layers else (K, N), seed)
    jq = jqt.quantize_weight(jnp.asarray(w), JKind(kind))
    if rowwise:
        jq = jqt.expand_fp8_scales_rowwise({"w": jq})["w"]
    if pack:
        jq = jqt.pack_int4_storage({"w": jq})["w"]
    return qtensor_from_numpy(jax.tree_util.tree_map(np.asarray, jq)), jq


def _x(T, K, seed=1):
    x = _w((T, K), seed, 0.5)
    return torch.from_numpy(x).to(torch.bfloat16), jnp.asarray(x, dtype=jnp.bfloat16)


@pytest.mark.parametrize("kind", ["soft_fp8", "w8a16", "w4a16"])
@pytest.mark.parametrize("T,K,N", [(16, 256, 384), (100, 300, 200), (1, 128, 128)])
def test_plain_gemm_matches_pallas_2d(kind, T, K, N):
    tq, jq = _pair(kind, K, N)
    tx, jx = _x(T, K)
    got = tqg.quant_gemm(tx, tq).numpy()
    want = np.asarray(jpqg._matmul_impl(jx, jq, interpret=True))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_plain_gemm_matches_pallas_packed_int4():
    tq, jq = _pair("w4a16", 256, 1024, pack=True)
    assert tq.packed
    tx, jx = _x(9, 256)
    got = tqg.quant_gemm(tx, tq).numpy()
    want = np.asarray(jpqg._matmul_impl(jx, jq, interpret=True))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize(
    "kind,kw", [("soft_fp8", dict(rowwise=True)), ("w4a16", dict(pack=True)),
                ("w4a16", {})],
    ids=["fp8_rowwise", "w4a16_packed", "w4a16"],
)
def test_plain_gemm_matches_pallas_stacked(kind, kw):
    tq, jq = _pair(kind, 256, 512, layers=3, **kw)
    tx, jx = _x(5, 256)
    got = tqg.quant_gemm(tx, tq[2]).numpy()
    want = np.asarray(jpqg.matmul_stacked(jx, jq, 2, interpret=True))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def _acts_equal(got, want, ties=0):
    np.testing.assert_allclose(
        got.scale.numpy(), np.asarray(want.scale), rtol=1e-6
    )
    d = np.abs(got.data.numpy().astype(np.int32) - np.asarray(want.data))
    assert d.max() <= 1 and (d != 0).sum() <= ties


@pytest.mark.parametrize("T,D", [(5, 256), (40, 96)])
def test_activation_quant_matches_pallas(T, D):
    tx, jx = _x(T, D, seed=6)
    nw = 1.0 + _w((D,), 7, 0.1)
    got = tnq.rms_norm_quant(tx, torch.from_numpy(nw).to(torch.bfloat16), 1e-5)
    want = jnq.rms_norm_quant(
        jx, jnp.asarray(nw, dtype=jnp.bfloat16), 1e-5, interpret=True
    )
    # bf16 inputs put many values on exact .5 ties of y / s, and a last-bit
    # difference in s flips them: under jit XLA turns `amax / 127.0` into a
    # product with the rounded reciprocal, the port divides
    ties = max(2, T * D // 1000)
    _acts_equal(got, want, ties)
    _acts_equal(tnq.quant_acts(tx), jnq.quant_acts(jx, interpret=True), ties)


@pytest.mark.parametrize("T,K,N", [(16, 256, 384), (3, 300, 200)])
def test_int8_gemm_matches_pallas(T, K, N):
    tq, jq = _pair("w8a8", K, N)
    tx, jx = _x(T, K)
    # dynamic activations: quantize, then the int8 GEMM
    want = np.asarray(jpqg._w8a8_matmul(jx, jq, interpret=True))
    got = tlinear.linear(tx, tq, out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    # pre-quantized activations: the sums are exact, so the products agree
    # to f32 rounding
    ta = tnq.quant_acts(tx)
    ja = jnq.quant_acts(jx, interpret=True)
    want = np.asarray(jpqg._w8a8_matmul_pre(ja.data, ja.scale, jq, interpret=True))
    got = tqg.int8_gemm(ta.data, ta.scale, tq).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    acc = tqg.int8_matmul(ta.data, tq.data).numpy()
    exact = np.asarray(ja.data).astype(np.int64) @ np.asarray(jq.data).astype(np.int64)
    np.testing.assert_array_equal(acc, exact)


@pytest.fixture
def jax_impl(monkeypatch):
    """Sets the JAX package's op_impl / fp8_act for one test and puts the
    old values back: the test files of one worker share the process. Under
    "pallas" the stacked GEMM, which `linear` calls without its interpret
    flag, runs in interpret mode as the 2-D one does on the CPU."""
    old_impl, old_act = jlinear._OP_IMPL, jlinear.get_fp8_act()
    old_tact = tlinear.get_fp8_act()

    def set_(impl=None, act=None):
        if impl:
            jlinear.set_op_impl(impl)
        if impl == "pallas":
            monkeypatch.setattr(
                jpqg, "matmul_stacked",
                functools.partial(jpqg.matmul_stacked, interpret=True),
            )
        if act:
            jlinear.set_fp8_act(act)
            tlinear.set_fp8_act(act)

    yield set_
    jlinear.set_op_impl(old_impl)
    jlinear.set_fp8_act(old_act)
    tlinear.set_fp8_act(old_tact)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_linear_in_perm_and_bias(jax_impl, impl):
    jax_impl(impl)
    K, N = 256, 128
    w = _w((2, K, N), 8)
    perm = np.stack([np.random.default_rng(s).permutation(K) for s in (1, 2)])
    perm = perm.astype(np.int32)
    jq = jqt.quantize_weight(
        jnp.asarray(np.take_along_axis(w, perm[..., None], axis=1)), JKind.W4A16
    )
    jq = JQTensor(data=jq.data, scale=jq.scale, zeros=jq.zeros, kind=jq.kind,
                  block=jq.block, in_perm=jnp.asarray(perm))
    tq = qtensor_from_numpy(jax.tree_util.tree_map(np.asarray, jq))
    tx, jx = _x(6, K)
    b = _w((2, N), 9, 0.1)
    got = tlinear.linear(
        tx, tq, torch.from_numpy(b).to(torch.bfloat16), layer=1,
        out_dtype=torch.float32,
    ).numpy()
    want = np.asarray(jlinear.linear(
        jx, jq, jnp.asarray(b[1], dtype=jnp.bfloat16), out_dtype=jnp.float32,
        layer=1,
    ))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    # the permutation is what makes it the original product
    ref = tx.float().numpy() @ w[1]
    assert np.abs(got - b[1].astype(np.float32) - ref).max() < 0.15


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_linear_llmint8_outliers(jax_impl, impl):
    jax_impl(impl)
    w = _w((2, 1600, 64), 10)
    w[:, ::200] *= 30.0  # outlier input channels
    jq = jax.lax.map(jqt.quantize_llmint8, jnp.asarray(w))
    tq = qtensor_from_numpy(jax.tree_util.tree_map(np.asarray, jq))
    assert tq.oc_idx.shape == (2, 8)
    tx, jx = _x(4, 1600)
    got = tlinear.linear(tx, tq, layer=1, out_dtype=torch.float32).numpy()
    want = np.asarray(jlinear.linear(jx, jq, out_dtype=jnp.float32, layer=1))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_linear_fp8_act_e4m3(jax_impl):
    jax_impl("pallas", "e4m3")
    tq, jq = _pair("fp8", 256, 384)
    tx, jx = _x(7, 256)
    got = tlinear.linear(tx, tq, out_dtype=torch.float32).numpy()
    want = np.asarray(jlinear.linear(jx, jq, out_dtype=jnp.float32))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    jax_impl(act="int8")  # int8 mode leaves the activations as they are
    plain = tlinear.linear(tx, tq, out_dtype=torch.float32).numpy()
    assert np.abs(plain - got).max() > 0
    want = np.asarray(jlinear.linear(jx, jq, out_dtype=jnp.float32))
    np.testing.assert_allclose(plain, want, atol=TOL, rtol=TOL)


def test_linear_quantized_acts(jax_impl):
    """int8 activations into a W8A8 weight (stacked, by layer), into a
    dense weight, and rejected by a weight-only kind."""
    jax_impl("pallas")
    tq, jq = _pair("w8a8", 256, 128, layers=2)
    tx, jx = _x(5, 256)
    ta, ja = tnq.quant_acts(tx), jnq.quant_acts(jx, interpret=True)
    got = tlinear.linear(ta, tq, layer=1).float().numpy()
    want = np.asarray(jlinear.linear(ja, jq, layer=1).astype(jnp.float32))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    w = _w((256, 64), 11)
    got = tlinear.linear(ta, torch.from_numpy(w).to(torch.bfloat16)).float().numpy()
    want = np.asarray(
        jlinear.linear(ja, jnp.asarray(w, dtype=jnp.bfloat16)).astype(jnp.float32)
    )
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    with pytest.raises(TypeError):
        tlinear.linear(ta, _pair("w8a16", 256, 128)[0])


class _QArgs:
    def __init__(self, method, quantize_head=False, group_size=128):
        self.method, self.quantize_head = method, quantize_head
        self.group_size = group_size


@pytest.mark.parametrize("method", sorted(jqt._KIND_BY_METHOD))
def test_quantize_params_equals_jax(method):
    """The same nested tree through both `quantize_params`: the same
    leaves become QTensors, with the same contents."""
    rng = np.random.default_rng(12)
    mk = lambda *s: (rng.standard_normal(s) * 0.05).astype(np.float32)
    tree = {
        "embed": mk(64, 256), "norm": np.ones(256, np.float32),
        "lm_head": mk(256, 64),
        "layers": {
            "attn_norm": np.ones((2, 256), np.float32), "wqkv": mk(2, 256, 384),
            "b_qkv": mk(2, 384), "wo": mk(2, 256, 256),
            "ffn_norm": np.ones((2, 256), np.float32),
            "w_gate_up": mk(2, 256, 1024), "w_down": mk(2, 512, 256),
        },
    }
    args = _QArgs(method, quantize_head=True)
    jt = jqt.quantize_params(jax.tree_util.tree_map(jnp.asarray, tree), args, None)
    tt = tqt.quantize_params(
        {k: ({n: torch.from_numpy(a) for n, a in v.items()} if k == "layers"
             else torch.from_numpy(v)) for k, v in tree.items()},
        args, None,
    )
    assert set(tqt.KIND_BY_METHOD) == set(jqt._KIND_BY_METHOD)
    quantized = {"wqkv", "wo", "w_gate_up", "w_down"}
    for name, leaf in tt["layers"].items():
        assert isinstance(leaf, QTensor) == (name in quantized), name
        if name in quantized:
            _assert_q_close(leaf, jt["layers"][name])
        else:
            np.testing.assert_array_equal(leaf.numpy(), tree["layers"][name])
    head_q = method != "llmint8"
    assert isinstance(tt["lm_head"], QTensor) == head_q
    assert isinstance(jt["lm_head"], JQTensor) == head_q
    if head_q:
        _assert_q_close(tt["lm_head"], jt["lm_head"])
    assert not isinstance(tt["embed"], QTensor)
