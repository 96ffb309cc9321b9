"""chitu_tpu_torch/models/common.py against chitu_tpu/models/common.py on
the same numpy inputs (f32; atol 1e-5: the same arithmetic, summed in
another order by another library)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chitu_tpu import config as jcfg
from chitu_tpu.models import common as jc
from chitu_tpu_torch import config as tcfg
from chitu_tpu_torch.models import common as tc


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


ATOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(
        got.numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), atol=atol, rtol=atol,
    )


def test_rms_norm():
    r = _rng(0)
    x = r.standard_normal((5, 64)).astype(np.float32)
    w = r.standard_normal((64,)).astype(np.float32)
    _close(
        tc.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
        jc.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5),
    )


@pytest.mark.parametrize(
    "scaling",
    [
        None,
        dict(kind="yarn", factor=4.0, original_max_position=64,
             beta_fast=32.0, beta_slow=1.0, mscale=1.0, mscale_all_dim=0.5),
        dict(kind="linear", factor=2.0),
    ],
)
def test_rope_tables(scaling):
    js = jcfg.RopeScalingArgs(**scaling) if scaling else None
    ts = tcfg.RopeScalingArgs(**scaling) if scaling else None
    jcos, jsin = jc.rope_tables(64, 256, 10000.0, js)
    tcos, tsin = tc.rope_tables(64, 256, 10000.0, ts)
    _close(tcos, jcos)
    _close(tsin, jsin)


@pytest.mark.parametrize(
    "layout,rot", [("hf-llama", 64), ("llama", 64), ("glm4", 32)]
)
def test_apply_rope_layouts(layout, rot):
    r = _rng(1)
    x = r.standard_normal((7, 3, 64)).astype(np.float32)
    jcos, jsin = jc.rope_tables(rot, 16, 10000.0)
    pos = np.array([0, 3, 5, 6, 9, 12, 15])
    cos, sin = np.asarray(jcos)[pos], np.asarray(jsin)[pos]
    _close(
        tc.apply_rope(
            torch.from_numpy(x), torch.from_numpy(cos), torch.from_numpy(sin),
            layout,
        ),
        jc.apply_rope(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin), layout),
    )


@pytest.mark.parametrize("softcap", [0.0, 4.0])
def test_grouped_attention(softcap):
    r = _rng(2)
    q = r.standard_normal((6, 4, 32)).astype(np.float32)
    k = r.standard_normal((9, 2, 32)).astype(np.float32)
    v = r.standard_normal((9, 2, 32)).astype(np.float32)
    mask = r.random((6, 9)) > 0.3
    mask[:, 0] = True
    _close(
        tc.grouped_attention(
            *(torch.from_numpy(a) for a in (q, k, v, mask)), softcap=softcap
        ),
        jc.grouped_attention(
            *(jnp.asarray(a) for a in (q, k, v, mask)), softcap=softcap
        ),
    )


def test_paged_flat_index_drops_out_of_range():
    bt = np.array([[3, 7, -1], [2, -1, -1]], np.int32)
    pos = np.array([[0, 17, 33, 40, 48, 70], [5, 15, 16, 2, 47, 48]], np.int32)
    bt_rows = np.repeat(bt[:, None, :], pos.shape[1], axis=1)
    got = tc.paged_flat_index(torch.from_numpy(bt_rows), torch.from_numpy(pos), 16)
    want = jc.paged_flat_index(jnp.asarray(bt_rows), jnp.asarray(pos), 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() == tc.DROP).sum() > 2  # -1 entries and overflow


@pytest.mark.parametrize("kv,d", [(1, 64), (2, 128), (3, 40), (8, 128)])
def test_pool_minor_sizes(kv, d):
    assert tc.pad_kv_minor(kv, d) == jc.pad_kv_minor(kv, d)
    assert tc.kv_pool_minor(kv, d) == jc.kv_pool_minor(kv, d)


def test_paged_append_drop_semantics():
    r = _rng(3)
    L, P, page, C = 2, 5, 4, 16
    pool = r.standard_normal((L, P, page, C)).astype(np.float32)
    vals = r.standard_normal((6, 2, 4)).astype(np.float32)  # 8 < C: padded
    drop = np.iinfo(np.int32).max
    flat = np.array([0, 7, drop, P * page, 19, 3], np.int32)  # 2 dropped
    want = jc.paged_append(
        jnp.asarray(pool), jnp.int32(1), jnp.asarray(vals), jnp.asarray(flat)
    )
    tp = torch.from_numpy(pool.copy())
    got = tc.paged_append(tp, 1, torch.from_numpy(vals), torch.from_numpy(flat))
    assert got.data_ptr() == tp.data_ptr()  # in place
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_kv_encode_decode_bf16_bits():
    x = _rng(4).standard_normal((5, 32)).astype(np.float32)
    got = tc.kv_encode(torch.from_numpy(x), torch.bfloat16)
    want = jc.kv_encode(jnp.asarray(x), jnp.bfloat16)
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy(), np.asarray(want).view(np.int16)
    )
    back = tc.kv_decode(got, torch.float32)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jc.kv_decode(want, jnp.float32))
    )
