"""The unmerged weight layout (`infer.merge_qkv_gate_up=off`: separate
wq/wk/wv, w_gate/w_up and bq/bk/bv leaves) at tp 1, against the JAX
package's unmerged models on the CPU.

- Llama: the four forwards of tests/test_torch_llama.py (prefill in two
  chunks, decode, prefill_packed, step_hybrid, the pool threaded
  through), on the JAX unmerged model's f32 tree with qkv biases
  (drawn nonzero): logits and pool within 5e-3 of the jnp oracle's. Both
  sides are f32 but read the pool as bf16, so a K/V value one f32 ulp
  from a bf16 rounding midpoint lands one bf16 step apart and moves the
  later layers (measured up to 2.6e-4 on the logits);
- Mixtral's attention takes the same layout: prefill and decode logits
  within 5e-3 (the limit of tests/test_torch_mixtral.py: the MoE paths
  round to bf16);
- the port's engines on one f32 tree, merged and unmerged, give the same
  greedy tokens.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chitu_tpu.config import load_config as jload
from chitu_tpu.models import build_model as jbuild
from chitu_tpu_torch import SampleParams
from chitu_tpu_torch.config import load_config as tload
from chitu_tpu_torch.engine import Engine
from chitu_tpu_torch.models import build_model as tbuild
from chitu_tpu_torch.models.llama import params_from_numpy

import test_torch_llama as tl
import test_torch_mixtral as tmx

OFF = ["infer.merge_qkv_gate_up=off"]


@pytest.fixture(autouse=True)
def _jax_op_impl_auto():
    """The JAX op_impl switch at "auto": a JAX test in the same worker may
    leave it at "pallas"."""
    mod = importlib.import_module("chitu_tpu.ops.linear")
    old = mod._OP_IMPL
    mod._OP_IMPL = "auto"
    yield
    mod._OP_IMPL = old


def _models(ovr, seed=0):
    jcfg, tcfg = jload(overrides=ovr + OFF), tload(overrides=ovr + OFF)
    jm = jbuild(jcfg.models, jcfg)
    params = jm.init_params(jax.random.PRNGKey(seed), jnp.float32)
    if jcfg.models.attn_bias:  # nonzero biases, so the test sees them
        for i, b in enumerate(("bq", "bk", "bv")):
            lay = params["layers"]
            lay[b] = jax.random.normal(jax.random.PRNGKey(9 + i), lay[b].shape) * 0.1
    tm = tbuild(tcfg.models, tcfg, device="cpu")
    tm.load_params(params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                     tm.layout))
    return jcfg, jm, params, tm


def test_llama_unmerged_matches_jax():
    jcfg, jm, params, tm = _models(tl.OVR + ["models.attn_bias=true"])
    assert not tm.merged and "wq" in params["layers"]
    assert {"wq", "wk", "wv", "w_gate", "w_up", "bq", "bk", "bv"} <= set(
        tm._shapes())
    L, M = jcfg.models.n_layers, 2 * 2 * 128
    pool = np.zeros((L, 40, tl.PAGE, M), np.float32)
    got = tl._script(tl._Torch(tm, pool), np.random.default_rng(0))
    want = tl._script(tl._Jax(jm, params, pool, "xla"), np.random.default_rng(0))
    tol = 5e-3
    for phase in ("prefill", "decode", "prefill_packed", "step_hybrid"):
        (g, rows), (w, _) = got[phase], want[phase]
        np.testing.assert_allclose(g[rows], w[rows], atol=tol, rtol=tol,
                                   err_msg=phase)
    np.testing.assert_allclose(got["pool"], want["pool"], atol=tol, rtol=tol)


def test_mixtral_attention_unmerged_matches_jax():
    jcfg, jm, params, tm = _models(tmx.OVR)
    assert not tm.merged and hasattr(tm, "wq") and not tm.merged_gu
    L, M = jcfg.models.n_layers, 2 * 4 * 32
    pool = np.zeros((L, 40, tmx.PAGE, M), np.float32)
    jcache = {"kv": jnp.asarray(pool)}
    tcache = {"kv": torch.from_numpy(pool.copy())}

    def jprefill(tokens, bt, start, n):
        nonlocal jcache
        out, jcache = jm.prefill(
            params, jcache, jnp.asarray(tokens), jnp.asarray(bt),
            jnp.int32(start), jnp.int32(n), tmx.PAGE, attn_impl="xla")
        return np.asarray(out)

    def jdecode(*a):
        nonlocal jcache
        out, jcache = jm.decode(params, jcache, *map(jnp.asarray, a), tmx.PAGE,
                                attn_impl="xla")
        return np.asarray(out)

    def tprefill(tokens, bt, start, n):
        out, _ = tm.prefill(tcache, torch.from_numpy(tokens),
                            torch.from_numpy(bt), start, n, tmx.PAGE)
        return out.numpy()

    def tdecode(*a):
        out, _ = tm.decode(tcache, *map(torch.from_numpy, a), tmx.PAGE)
        return out.numpy()

    V = jcfg.models.vocab_size
    want = tmx._script(jprefill, jdecode, np.random.default_rng(1), V)
    got = tmx._script(tprefill, tdecode, np.random.default_rng(1), V)
    for phase in ("prefill", "decode"):
        np.testing.assert_allclose(got[phase], want[phase], atol=tmx.TOL,
                                   rtol=tmx.TOL, err_msg=phase)


def test_engines_merged_and_unmerged_agree():
    _, _, params, _ = _models(tl.OVR, seed=3)
    params["embed"] = params["embed"] * 50.0  # choices far above rounding
    tree = jax.tree_util.tree_map(np.asarray, params)
    p = SampleParams(temperature=0.0, max_new_tokens=8)
    out = []
    for extra in ([], OFF):
        eng = Engine(tload(overrides=tl.OVR + extra), device="cpu",
                     params=lambda m: params_from_numpy(tree, m.layout))
        assert eng.model.merged == (not extra)
        out.append(eng.generate("the unmerged layout", p))
    assert out[0] == out[1] and len(set(out[0])) > 1
