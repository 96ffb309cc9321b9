"""chitu_tpu_torch's checkpoint side against the JAX package's, on the CPU:
`utils/safetensors.py` against the `safetensors` package, `quantize/packed.py`
against `chitu_tpu/quantize/packed.py`, and `loader.py` / `loaders_moe.py`
against `chitu_tpu/loader.py` / `loaders_moe.py`.

Checkpoints are written from numpy draws of a fixed seed with the
`safetensors` package (or `torch.save` for Meta `.pth`) at tiny widths
(micro-llama-debug, tiny-mixtral-debug and tiny-deepseek-debug at 2
layers). Limits:
- the loaded tree equals `params_from_numpy` of the JAX loader's tree leaf
  for leaf, byte for byte (QTensor data, scale, zeros, in_perm, oc_idx and
  oc_w included): both cast f32 to bf16 with round-to-nearest-even, and
  move e4m3 and int4 bytes as they are;
- the same ValueError messages as the JAX loader;
- greedy tokens of the port's engine equal the JAX engine's on the same
  checkpoint;
- teacher-forced logits against `transformers` on checkpoints it saved:
  top-1 agreement >= 0.95 and ||got - want|| / ||want|| < 0.05, the limits
  of `tests/test_hf_parity.py:_check_parity` (0.9 and 0.08 for DeepSeek,
  as there).
"""

import dataclasses
import importlib
import json
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import save_file as st_save

from chitu_tpu.config import load_config as jload
from chitu_tpu.engine import Engine as JEngine
from chitu_tpu.loader import (
    _meta_mp_dim,
    load_checkpoint as jload_checkpoint,
    save_preprocessed as jsave_preprocessed,
)
from chitu_tpu.models import build_model as jbuild
from chitu_tpu.quantize import packed as jpacked
from chitu_tpu.task import SampleParams as JSampleParams
from chitu_tpu_torch import SampleParams, load_config
from chitu_tpu_torch import loader_streaming as ls
from chitu_tpu_torch.engine import Engine
from chitu_tpu_torch.kvcache import PagedKVCache
from chitu_tpu_torch.loader import (
    load_checkpoint,
    load_preprocessed,
    save_preprocessed,
)
from chitu_tpu_torch.models import build_model
from chitu_tpu_torch.models.llama import params_from_numpy
from chitu_tpu_torch.ops.qtensor import TENSOR_FIELDS, QTensor, QuantKind
from chitu_tpu_torch.quantize import packed
from chitu_tpu_torch.utils import safetensors as tst


@pytest.fixture(autouse=True)
def _jax_op_impl_auto():
    """Run each test with the JAX op_impl switch at "auto" (ROADMAP C.1):
    a JAX test in the same worker may leave it at "pallas"."""
    mod = importlib.import_module("chitu_tpu.ops.linear")
    old = mod._OP_IMPL
    mod._OP_IMPL = "auto"
    yield
    mod._OP_IMPL = old


# ---------------------------------------------------------------------------
# utils/safetensors.py against the safetensors package
# ---------------------------------------------------------------------------

DTYPES = [torch.bfloat16, torch.float16, torch.float32, torch.float8_e4m3fn,
          torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
          torch.bool]


def _sample(dtype, shape, gen):
    if dtype == torch.bool:
        return torch.rand(shape, generator=gen) > 0.5
    if dtype.is_floating_point:
        x = torch.randn(shape, generator=gen) * 3
        return x.to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(max(info.min, -(2**31)), min(info.max, 2**31 - 1),
                         shape, generator=gen, dtype=torch.int64).to(dtype)


def _sample_set(dtype):
    """A 2-D, a 0-d and an empty tensor of `dtype`, and an odd-sized one."""
    gen = torch.Generator().manual_seed(3)
    return {f"w.{dtype}": _sample(dtype, (5, 7), gen),
            "scalar": _sample(dtype, (), gen),
            "empty": _sample(dtype, (0, 4), gen),
            "odd": _sample(dtype, (3,), gen)}


def _same(a: torch.Tensor, b: torch.Tensor):
    assert a.dtype == b.dtype and tuple(a.shape) == tuple(b.shape)
    if a.numel():
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_reader_matches_safetensors_package(tmp_path, dtype):
    want = _sample_set(dtype)
    want["f32"] = torch.arange(3, dtype=torch.float32)  # mixed element sizes
    path = str(tmp_path / "a.safetensors")
    st_save(want, path, metadata={"format": "pt"})
    r = tst.Reader(path)
    assert sorted(r.keys()) == sorted(want)
    views = {k: r.get_tensor(k) for k in want}
    for k, v in want.items():
        _same(v, views[k])
        _same(v, r.get_tensor(k))  # a second map of the same pages
    assert r.metadata() == {"format": "pt"}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_writer_read_by_safetensors_package(tmp_path, dtype):
    want = _sample_set(dtype)
    path = str(tmp_path / "b.safetensors")
    tst.save_file(want, path, metadata={"k": "v"})
    with safe_open(path, framework="pt") as f:
        assert sorted(f.keys()) == sorted(want)
        assert f.metadata() == {"k": "v"}
        for k, v in want.items():
            _same(v, f.get_tensor(k))
    entries, _, base = tst.read_header(path)
    assert base % 8 == 0
    assert all(e.begin % max(e.dtype.itemsize, 1) == 0 for e in entries.values())


def test_read_index_over_a_directory(tmp_path):
    st_save({"a": torch.ones(2)}, str(tmp_path / "m-00001.safetensors"))
    st_save({"b": torch.zeros(3)}, str(tmp_path / "m-00002.safetensors"))
    (tmp_path / "model.safetensors.index.json").write_text("{}")
    idx = tst.read_index(str(tmp_path))
    assert {k: os.path.basename(v) for k, v in idx.items()} == {
        "a": "m-00001.safetensors", "b": "m-00002.safetensors"}
    _same(torch.zeros(3), tst.get_tensor(idx["b"], "b"))
    st_save({"a": torch.ones(1)}, str(tmp_path / "m-00003.safetensors"))
    with pytest.raises(ValueError, match="is in"):
        tst.read_index(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        tst.read_index(str(tmp_path / "a"))


# ---------------------------------------------------------------------------
# quantize/packed.py against chitu_tpu/quantize/packed.py
# ---------------------------------------------------------------------------


def _jq_to_torch(q):
    return QTensor(kind=QuantKind(q.kind.value), block=q.block, **{
        n: None if getattr(q, n) is None else torch.from_numpy(np.array(getattr(q, n)))
        for n in TENSOR_FIELDS})


def _same_q(a: QTensor, b: QTensor):
    assert (a.kind, a.block) == (b.kind, b.block)
    for n in TENSOR_FIELDS:
        x, y = getattr(a, n), getattr(b, n)
        assert (x is None) == (y is None), n
        if x is not None:
            _same(x, y)


def unpack(qweight, qzeros, scales, g_idx=None):
    """The loader's AWQ / GPTQ readers (`loader_streaming.w4a16`) over
    whole host tensors, read on the CPU."""
    r = ls.LazySlice
    q = ls.w4a16(r(qweight), r(qzeros), r(scales, dtype=torch.float32),
                 None if g_idx is None else r(g_idx))
    return ls.load(q, "cpu")


@pytest.mark.parametrize("fmt", ["awq", "gptq", "gptq_act_order"])
def test_unpack_matches_jax(fmt):
    rng = np.random.default_rng(1)
    K, N, G = 256, 64, 64
    words = lambda *s: rng.integers(-(2**31), 2**31 - 1, s, dtype=np.int64).astype(np.int32)
    scales = rng.random((K // G, N)).astype(np.float16)
    if fmt == "awq":
        args = (words(K, N // 8), words(K // G, N // 8), scales)
        want = jpacked.unpack_awq(*args, group_size=G)
        got = unpack(*map(torch.from_numpy, args))
    else:
        g = np.arange(K) // G
        g = (rng.permutation(g) if fmt == "gptq_act_order" else g).astype(np.int32)
        args = (words(K // 8, N), words(K // G, N // 8), scales)
        want = jpacked.unpack_gptq(*args, group_size=G, g_idx=g)
        got = unpack(*map(torch.from_numpy, args), torch.from_numpy(g))
        assert (got.in_perm is not None) == (fmt == "gptq_act_order")
    _same_q(_jq_to_torch(want), got)


def test_pack_awq_and_gptq_invert_the_unpack():
    rng = np.random.default_rng(2)
    K, N, G = 128, 32, 32
    data = torch.from_numpy(rng.integers(0, 16, (K, N)).astype(np.int8))
    zeros = torch.from_numpy(rng.integers(1, 16, (K // G, N)).astype(np.float32))
    scales = torch.from_numpy(rng.random((K // G, N)).astype(np.float16)).float()
    q = QTensor(data=data, scale=scales, zeros=zeros, kind=QuantKind.W4A16, block=G)
    p = packed.pack_awq(q)
    jp = jpacked.pack_awq(SimpleNamespace(data=data.numpy(), zeros=zeros.numpy(),
                                          scale=scales.numpy()))
    for k in ("qweight", "qzeros", "scales"):
        _same(torch.from_numpy(jp[k]), p[k])
    _same_q(q, unpack(p["qweight"], p["qzeros"], p["scales"]))
    g = torch.from_numpy((rng.permutation(K) % (K // G)).astype(np.int32))
    p = packed.pack_gptq(data, zeros, scales, g_idx=g)
    got = unpack(p["qweight"], p["qzeros"], p["scales"], p["g_idx"])
    perm = torch.argsort(g.long(), stable=True)
    _same(data[perm], got.data)
    _same(zeros, got.zeros)


# ---------------------------------------------------------------------------
# Checkpoints of every format, written from seeded draws
# ---------------------------------------------------------------------------

LLAMA = ["models=micro-llama-debug", "infer.max_seq_len=128", "infer.page_size=16",
         "infer.max_reqs=4", "infer.stop_with_eos=false"]
# dims a multiple of 128 where blockwise fp8 q/k/v and gate/up merge
LLAMA_FP8 = LLAMA + ["models.dim=256", "models.n_heads=8", "models.n_kv_heads=4",
                     "models.inter_dim=512"]
MIXTRAL = ["models=tiny-mixtral-debug", "models.n_layers=2", "infer.max_seq_len=128",
           "infer.page_size=16", "infer.max_reqs=4", "infer.stop_with_eos=false"]
DEEPSEEK = ["models=tiny-deepseek-debug", "models.n_layers=2", "infer.max_seq_len=128",
            "infer.page_size=16", "infer.max_reqs=4", "infer.stop_with_eos=false"]
G = 64  # AWQ / GPTQ group


class Draw:
    """Seeded weights in torch's [out, in] layout."""

    def __init__(self, seed, scale=0.02):
        self.rng = np.random.default_rng(seed)
        self.scale = scale

    def __call__(self, *shape, scale=None):
        s = self.scale if scale is None else scale
        return torch.from_numpy(
            (self.rng.standard_normal(shape) * s).astype(np.float32))

    def norm(self, n):
        return 1.0 + self(n, scale=0.1)


def _dims(ovr):
    a = load_config(overrides=ovr).models
    Dh = a.head_dim or a.dim // a.n_heads
    return a, Dh


def llama_tensors(ovr, seed=0, bias=False, head=True, embed=0.02):
    a, Dh = _dims(ovr)
    d = Draw(seed)
    V, D, H, KV, F = a.vocab_size, a.dim, a.n_heads, a.n_kv_heads, a.inter_dim
    t = {"model.embed_tokens.weight": d(V, D, scale=embed), "model.norm.weight": d.norm(D)}
    if head:
        t["lm_head.weight"] = d(V, D)
    for i in range(a.n_layers):
        p = f"model.layers.{i}"
        t[f"{p}.input_layernorm.weight"] = d.norm(D)
        t[f"{p}.post_attention_layernorm.weight"] = d.norm(D)
        for proj, o, n in (("q", H * Dh, D), ("k", KV * Dh, D), ("v", KV * Dh, D),
                           ("o", D, H * Dh)):
            t[f"{p}.self_attn.{proj}_proj.weight"] = d(o, n)
        if bias:
            for proj, o in (("q", H * Dh), ("k", KV * Dh), ("v", KV * Dh)):
                t[f"{p}.self_attn.{proj}_proj.bias"] = d(o)
        for proj, o, n in (("gate", F, D), ("up", F, D), ("down", D, F)):
            t[f"{p}.mlp.{proj}_proj.weight"] = d(o, n)
    return t


def fp8_blockwise(w: torch.Tensor):
    """[out, in] -> (e4m3 [out, in], scale_inv [out/128, in/128] f32), the
    published DeepSeek layout (absmax / 448 a 128 x 128 block)."""
    O, I = w.shape
    bo, bi = -(-O // 128), -(-I // 128)
    wp = torch.zeros(bo * 128, bi * 128)
    wp[:O, :I] = w
    blocks = wp.reshape(bo, 128, bi, 128)
    scale = blocks.abs().amax(dim=(1, 3)).clamp(min=1e-8) / 448.0
    q = (blocks / scale[:, None, :, None]).reshape(bo * 128, bi * 128)[:O, :I]
    return q.to(torch.float8_e4m3fn), scale


def to_fp8(t, match):
    out = {}
    for k, v in t.items():
        if match(k):
            out[k], out[k[: -len(".weight")] + ".weight_scale_inv"] = fp8_blockwise(v)
        else:
            out[k] = v.to(torch.bfloat16)
    return out


def _pack_gptq_np(data, zeros, scales, g_idx):
    """A GPTQ checkpoint's tensors packed with numpy (independent of both
    packages' packers): qweight along in, qzeros stored as zero - 1."""
    K, N = data.shape
    qw = np.zeros((K // 8, N), np.int64)
    for r in range(K):
        qw[r // 8] |= (data[r].astype(np.int64) & 0xF) << ((r % 8) * 4)
    z = zeros.astype(np.int64) - 1
    qz = np.zeros((z.shape[0], N // 8), np.int64)
    for c in range(N):
        qz[:, c // 8] |= (z[:, c] & 0xF) << ((c % 8) * 4)
    wrap = lambda a: torch.from_numpy(np.where(a >= 2**31, a - 2**32, a).astype(np.int32))
    return {"qweight": wrap(qw), "qzeros": wrap(qz),
            "scales": torch.from_numpy(scales.astype(np.float16)),
            "g_idx": torch.from_numpy(g_idx.astype(np.int32))}


def int4_tensors(ovr, fmt, seed=0, perms=None):
    """A packed AWQ or GPTQ llama checkpoint. GPTQ act-order: q/k/v share
    one g_idx and gate/up another (`perms`: "shared", or "differ" for q
    against k/v)."""
    a, Dh = _dims(ovr)
    rng = np.random.default_rng(seed)
    t = {k: v.to(torch.bfloat16) for k, v in llama_tensors(ovr, seed).items()
         if not k.endswith("_proj.weight")}
    D, H, KV, F = a.dim, a.n_heads, a.n_kv_heads, a.inter_dim
    for i in range(a.n_layers):
        g_attn = rng.permutation(np.arange(D) // G)
        g_ffn = rng.permutation(np.arange(D) // G)
        for blk, proj, K, N in (("self_attn", "q", D, H * Dh), ("self_attn", "k", D, KV * Dh),
                                ("self_attn", "v", D, KV * Dh), ("self_attn", "o", H * Dh, D),
                                ("mlp", "gate", D, F), ("mlp", "up", D, F),
                                ("mlp", "down", F, D)):
            key = f"model.layers.{i}.{blk}.{proj}_proj"
            data = rng.integers(0, 16, (K, N)).astype(np.int8)
            zeros = rng.integers(1, 16, (K // G, N)).astype(np.float32)
            scales = (rng.random((K // G, N)) * 0.004 + 0.001).astype(np.float32)
            if fmt == "awq":
                parts = jpacked.pack_awq(SimpleNamespace(data=data, zeros=zeros, scale=scales))
                parts = {k: torch.from_numpy(np.asarray(v)) for k, v in parts.items()}
            else:
                g = np.arange(K) // G
                if perms and K == D and proj in ("q", "k", "v"):
                    g = g_attn if (perms == "shared" or proj == "q") else g_ffn
                elif perms and K == D:
                    g = g_ffn
                elif perms:
                    g = rng.permutation(g)
                parts = _pack_gptq_np(data, zeros, scales, g)
            for part, v in parts.items():
                t[f"{key}.{part}"] = v
    return t


def meta_tensors(ovr, seed=0):
    hf = llama_tensors(ovr, seed)
    a, _ = _dims(ovr)
    names = {"model.embed_tokens.weight": "tok_embeddings.weight",
             "model.norm.weight": "norm.weight", "lm_head.weight": "output.weight"}
    layer = {"input_layernorm": "attention_norm", "post_attention_layernorm": "ffn_norm",
             "self_attn.q_proj": "attention.wq", "self_attn.k_proj": "attention.wk",
             "self_attn.v_proj": "attention.wv", "self_attn.o_proj": "attention.wo",
             "mlp.gate_proj": "feed_forward.w1", "mlp.up_proj": "feed_forward.w3",
             "mlp.down_proj": "feed_forward.w2"}
    out = {}
    for k, v in hf.items():
        if k in names:
            out[names[k]] = v
            continue
        i, rest = k.split(".")[2], ".".join(k.split(".")[3:-1])
        out[f"layers.{i}.{layer[rest]}.weight"] = v
    return out


def glm4_tensors(ovr, seed=0):
    hf = llama_tensors(ovr, seed, bias=True)
    a, _ = _dims(ovr)
    out = {"transformer.embedding.word_embeddings.weight": hf["model.embed_tokens.weight"],
           "transformer.encoder.final_layernorm.weight": hf["model.norm.weight"],
           "transformer.output_layer.weight": hf["lm_head.weight"]}
    for i in range(a.n_layers):
        s, d = f"model.layers.{i}", f"transformer.encoder.layers.{i}"
        out[f"{d}.input_layernorm.weight"] = hf[f"{s}.input_layernorm.weight"]
        out[f"{d}.post_attention_layernorm.weight"] = hf[f"{s}.post_attention_layernorm.weight"]
        for kind in ("weight", "bias"):
            out[f"{d}.self_attention.query_key_value.{kind}"] = torch.cat(
                [hf[f"{s}.self_attn.{p}_proj.{kind}"] for p in "qkv"])
        out[f"{d}.self_attention.dense.weight"] = hf[f"{s}.self_attn.o_proj.weight"]
        out[f"{d}.mlp.dense_h_to_4h.weight"] = torch.cat(
            [hf[f"{s}.mlp.gate_proj.weight"], hf[f"{s}.mlp.up_proj.weight"]])
        out[f"{d}.mlp.dense_4h_to_h.weight"] = hf[f"{s}.mlp.down_proj.weight"]
    return out


def mixtral_tensors(ovr, seed=0, embed=0.02):
    a, Dh = _dims(ovr)
    d = Draw(seed)
    V, D, H, KV = a.vocab_size, a.dim, a.n_heads, a.n_kv_heads
    E, F = a.moe.n_routed_experts, a.moe.moe_inter_dim
    t = {"model.embed_tokens.weight": d(V, D, scale=embed), "model.norm.weight": d.norm(D),
         "lm_head.weight": d(V, D)}
    for i in range(a.n_layers):
        p = f"model.layers.{i}"
        t[f"{p}.input_layernorm.weight"] = d.norm(D)
        t[f"{p}.post_attention_layernorm.weight"] = d.norm(D)
        for proj, o, n in (("q", H * Dh, D), ("k", KV * Dh, D), ("v", KV * Dh, D),
                           ("o", D, H * Dh)):
            t[f"{p}.self_attn.{proj}_proj.weight"] = d(o, n)
        t[f"{p}.block_sparse_moe.gate.weight"] = d(E, D, scale=1.0)
        for e in range(E):
            q = f"{p}.block_sparse_moe.experts.{e}"
            t[f"{q}.w1.weight"], t[f"{q}.w3.weight"] = d(F, D), d(F, D)
            t[f"{q}.w2.weight"] = d(D, F)
    return t


def deepseek_tensors(ovr, seed=0, embed=0.02):
    a, _ = _dims(ovr)
    d = Draw(seed)
    mo, ml = a.moe, a.mla
    V, D, H, E, Fm = a.vocab_size, a.dim, a.n_heads, mo.n_routed_experts, mo.moe_inter_dim
    qk = ml.qk_nope_head_dim + ml.qk_rope_head_dim
    t = {"model.embed_tokens.weight": d(V, D, scale=embed), "model.norm.weight": d.norm(D),
         "lm_head.weight": d(V, D)}
    for i in range(a.n_layers):
        p = f"model.layers.{i}"
        sa = f"{p}.self_attn"
        t[f"{p}.input_layernorm.weight"] = d.norm(D)
        t[f"{p}.post_attention_layernorm.weight"] = d.norm(D)
        t[f"{sa}.q_a_proj.weight"] = d(ml.q_lora_rank, D)
        t[f"{sa}.q_a_layernorm.weight"] = d.norm(ml.q_lora_rank)
        t[f"{sa}.q_b_proj.weight"] = d(H * qk, ml.q_lora_rank)
        t[f"{sa}.kv_a_proj_with_mqa.weight"] = d(ml.kv_lora_rank + ml.qk_rope_head_dim, D)
        t[f"{sa}.kv_a_layernorm.weight"] = d.norm(ml.kv_lora_rank)
        t[f"{sa}.kv_b_proj.weight"] = d(H * (ml.qk_nope_head_dim + ml.v_head_dim),
                                        ml.kv_lora_rank)
        t[f"{sa}.o_proj.weight"] = d(D, H * ml.v_head_dim)
        if i < mo.n_dense_layers:
            for proj, o, n in (("gate", a.inter_dim, D), ("up", a.inter_dim, D),
                               ("down", D, a.inter_dim)):
                t[f"{p}.mlp.{proj}_proj.weight"] = d(o, n)
            continue
        t[f"{p}.mlp.gate.weight"] = d(E, D, scale=1.0)
        t[f"{p}.mlp.gate.e_score_correction_bias"] = d(E, scale=0.1)
        for pre in [f"{p}.mlp.shared_experts"] + [f"{p}.mlp.experts.{e}" for e in range(E)]:
            for proj, o, n in (("gate", Fm, D), ("up", Fm, D), ("down", D, Fm)):
                t[f"{pre}.{proj}_proj.weight"] = d(o, n)
    return t


def _deepseek_fp8(t):
    out = to_fp8(t, lambda k: k.endswith("_proj.weight") or k.endswith("_mqa.weight"))
    for k, v in t.items():
        if k.endswith("e_score_correction_bias"):
            out[k] = v  # f32, as published
    return out


def write(tensors, d, dtype=None, files=1):
    """safetensors files (the package's writer) in HF sharded naming, with
    an index; `dtype` casts the float tensors that are not fp8."""
    os.makedirs(d, exist_ok=True)
    cast = {k: (v.to(dtype) if dtype is not None and v.dtype == torch.float32 else v)
            .contiguous() for k, v in tensors.items()}
    keys = list(cast)
    chunks = [keys[i::files] for i in range(files)]
    weight_map = {}
    for j, chunk in enumerate(chunks):
        name = f"model-{j + 1:05d}-of-{files:05d}.safetensors"
        st_save({k: cast[k] for k in chunk}, os.path.join(d, name))
        weight_map.update({k: name for k in chunk})
    with open(os.path.join(d, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)
    return d


def write_pth(tensors, d, shards=1):
    os.makedirs(d, exist_ok=True)
    parts = [{} for _ in range(shards)]
    for k, v in tensors.items():
        dim = _meta_mp_dim(k)
        pieces = [v] * shards if dim is None or shards == 1 else torch.chunk(v, shards, dim)
        for s in range(shards):
            parts[s][k] = pieces[s].to(torch.bfloat16).clone()
    for s in range(shards):
        torch.save(parts[s], os.path.join(d, f"consolidated.{s:02d}.pth"))
    return d


def checkpoint(fmt, d):
    """-> (overrides, checkpoint dir) of one format."""
    d = str(d)
    if fmt == "hf_llama_f32":
        return LLAMA, write(llama_tensors(LLAMA), d)
    if fmt == "hf_llama_bf16":
        return LLAMA, write(llama_tensors(LLAMA), d, torch.bfloat16, files=2)
    if fmt == "hf_llama_no_head":
        return LLAMA, write(llama_tensors(LLAMA, head=False), d, torch.bfloat16)
    if fmt == "qwen2_bias":
        ovr = LLAMA + ["models.attn_bias=true"]
        return ovr, write(llama_tensors(ovr, bias=True), d, torch.bfloat16)
    if fmt == "glm4":
        ovr = LLAMA + ["models.attn_bias=true", "models.rotary_type=glm4",
                       "models.partial_rotary_factor=0.5"]
        return ovr, write(glm4_tensors(ovr), d, torch.bfloat16)
    if fmt == "meta_pth":
        ovr = LLAMA + ["models.type=llama", "models.rotary_type=llama"]
        return ovr, write_pth(meta_tensors(ovr), d)
    if fmt == "meta_pth_mp":
        ovr = LLAMA + ["models.type=llama", "models.rotary_type=llama"]
        return ovr, write_pth(meta_tensors(ovr), d, shards=2)
    if fmt == "mixtral":
        return MIXTRAL, write(mixtral_tensors(MIXTRAL), d, torch.bfloat16)
    if fmt == "deepseek_bf16":
        return DEEPSEEK, write(deepseek_tensors(DEEPSEEK), d, torch.bfloat16)
    if fmt == "deepseek_fp8":
        return DEEPSEEK, write(_deepseek_fp8(deepseek_tensors(DEEPSEEK)), d, files=2)
    if fmt == "llama_fp8":
        t = to_fp8(llama_tensors(LLAMA_FP8), lambda k: k.endswith("_proj.weight"))
        return LLAMA_FP8, write(t, d)
    if fmt == "awq":
        return LLAMA, write(int4_tensors(LLAMA, "awq"), d)
    if fmt == "gptq":
        return LLAMA, write(int4_tensors(LLAMA, "gptq"), d)
    if fmt == "gptq_act_order":
        return LLAMA, write(int4_tensors(LLAMA, "gptq", perms="shared"), d)
    raise ValueError(fmt)


def _cfgs(ovr, d, extra=()):
    o = list(ovr) + [f"models.ckpt_dir={d}", "infer.do_load=true", *extra]
    return jload(overrides=o), load_config(overrides=o)


def jax_tree(jcfg):
    """The JAX loader's tree through `params_from_numpy`."""
    tree = jload_checkpoint(jbuild(jcfg.models, jcfg), jcfg)
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree))


def port_tree(cfg):
    """The port loader's tree, laid out as `params_from_numpy` lays it out
    (a llama-family tree's "layers" flattened into the top level)."""
    model = build_model(cfg.models, cfg, device="cpu")
    tree = load_checkpoint(model, cfg, "cpu")
    if "layers" in tree:
        tree = {**{k: v for k, v in tree.items() if k != "layers"}, **tree["layers"]}
    return tree


def assert_trees_equal(want, got, path=""):
    assert sorted(want) == sorted(got), path
    for k in want:
        a, b = want[k], got[k]
        if isinstance(a, dict):
            assert_trees_equal(a, b, f"{path}{k}/")
        elif isinstance(a, QTensor):
            assert isinstance(b, QTensor), f"{path}{k}"
            _same_q(a, b)
        else:
            assert not isinstance(b, QTensor), f"{path}{k}"
            _same(a, b)


FORMATS = ["hf_llama_f32", "hf_llama_bf16", "hf_llama_no_head", "qwen2_bias", "glm4",
           "meta_pth", "meta_pth_mp", "mixtral", "deepseek_bf16", "deepseek_fp8",
           "llama_fp8", "awq", "gptq", "gptq_act_order"]


@pytest.mark.parametrize("fmt", ["deepseek_fp8", "meta_pth_mp"])
def test_iter_checkpoint_matches_jax(tmp_path, fmt):
    """The same names in the same order, the same values: the JAX reader
    yields numpy (f32 for `.pth`, e4m3 as its uint8 bytes), the port's
    reader the stored dtype."""
    from chitu_tpu.loader import iter_checkpoint as jiter
    from chitu_tpu_torch.loader import iter_checkpoint

    _, d = checkpoint(fmt, tmp_path)
    want = list(jiter(d))
    got = list(iter_checkpoint(d))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, t), (_, a) in zip(got, want):
        if t.dtype == torch.float8_e4m3fn:
            t = t.view(torch.uint8)
        a = np.asarray(a)
        ref = torch.from_numpy(a.astype(np.float32) if a.dtype.kind == "f" or
                               a.dtype.name == "bfloat16" else a.copy())
        assert torch.equal(t.to(ref.dtype), ref), k


@pytest.mark.parametrize("fmt", FORMATS)
def test_loaded_tree_matches_jax_loader(tmp_path, fmt):
    ovr, d = checkpoint(fmt, tmp_path)
    jcfg, cfg = _cfgs(ovr, d)
    got = port_tree(cfg)
    assert_trees_equal(jax_tree(jcfg), got)
    if fmt == "deepseek_fp8":
        ly = got["moe_layers"]
        assert ly["exp_gate"].kind == QuantKind.SOFT_FP8 and ly["gate_bias"].dtype == torch.float32
        assert ly["exp_gate"].data.dtype == torch.float8_e4m3fn
        assert ly["moe_gate"].dtype == torch.bfloat16
    if fmt == "gptq_act_order":
        assert got["wqkv"].in_perm is not None and got["w_gate_up"].in_perm is not None


def _jax_quantized(method, seed=4):
    """A quantized JAX tree of micro-llama-debug (f32 draw), as the JAX
    engine's on-load path makes it; W4A16 storage packed by the JAX
    package (the layout a TPU dump holds)."""
    from chitu_tpu.quantize import pack_int4_storage, quantize_params

    jcfg = jload(overrides=LLAMA + [f"quant.method={method}", "quant.quant_on_load=true"])
    m = jbuild(jcfg.models, jcfg)
    tree = quantize_params(m.init_params(jax.random.PRNGKey(seed)), jcfg.quant, m)
    return pack_int4_storage(tree) if method == "w4a16" else tree


@pytest.mark.parametrize("method", ["soft_fp8", "w4a16", "llmint8"])
def test_preprocessed_dump_matches_jax(tmp_path, method):
    """The JAX package's dump read by the port, then the port's own dump of
    that tree read back: both equal `params_from_numpy` of the tree."""
    tree = _jax_quantized(method)
    jsave_preprocessed(tree, str(tmp_path / "jax"), num_shards=2)
    want = params_from_numpy(jax.tree_util.tree_map(np.asarray, tree))
    got = load_preprocessed(str(tmp_path / "jax"), device="cpu")
    flat = {**{k: v for k, v in got.items() if k != "layers"}, **got["layers"]}
    assert_trees_equal(want, flat)
    if method == "w4a16":
        assert flat["w_gate_up"].packed
    if method == "llmint8":
        assert flat["wqkv"].oc_idx is not None and flat["wqkv"].oc_w is not None
    save_preprocessed(got, str(tmp_path / "port"), num_shards=3, layout={"merge_tp": 1})
    again = load_preprocessed(str(tmp_path / "port"), device="cpu")
    assert_trees_equal(got, again)
    meta = json.loads((tmp_path / "port" / "meta.json").read_text())
    assert len(meta["files"]) == 3 and meta["layout"] == {"merge_tp": 1}


def test_preprocessed_dump_checks_merge_tp(tmp_path):
    tree = _jax_quantized("soft_fp8")
    jsave_preprocessed(tree, str(tmp_path), layout={"merge_tp": 2})
    with pytest.raises(ValueError, match="merge_tp=2"):
        load_preprocessed(str(tmp_path), device="cpu")


def test_engine_skip_preprocess_serves_the_dump(tmp_path):
    """`skip_preprocess=true` reads `<ckpt_dir>/chitu_tpu_preprocessed`;
    its engine gives the tokens of the engine that loaded the checkpoint."""
    ovr, d = checkpoint("awq", tmp_path / "ckpt")
    ovr = ovr + [f"models.ckpt_dir={d}", "infer.do_load=true", "quant.method=w4a16"]
    eng = Engine(load_config(overrides=ovr), device="cpu")
    want = eng.generate("preprocessed", SampleParams(temperature=0.0, max_new_tokens=6))
    assert eng.model.w_gate_up.packed  # int4 storage packed after the load
    save_preprocessed(eng.model.params_tree(), os.path.join(d, "chitu_tpu_preprocessed"))
    pre = Engine(load_config(overrides=ovr + ["skip_preprocess=true"]), device="cpu")
    assert_trees_equal(eng.model.params_tree(), pre.model.params_tree())
    assert pre.generate("preprocessed", SampleParams(temperature=0.0, max_new_tokens=6)) == want


def _drop(t, key):
    t = dict(t)
    del t[key]
    return t


@pytest.mark.parametrize("case", ["missing_layer", "fp8_without_scales", "rowwise_scale"])
def test_same_errors_as_jax_loader(tmp_path, case):
    if case == "missing_layer":
        ovr, t = LLAMA, _drop(llama_tensors(LLAMA), "model.layers.1.self_attn.q_proj.weight")
    else:
        ovr = LLAMA_FP8
        t = to_fp8(llama_tensors(LLAMA_FP8), lambda k: k.endswith("_proj.weight"))
        key = "model.layers.1.self_attn.q_proj.weight_scale_inv"
        t = _drop(t, key) if case == "fp8_without_scales" else {**t, key: torch.ones(256)}
    jcfg, cfg = _cfgs(ovr, write(t, str(tmp_path)))
    with pytest.raises(ValueError) as je:
        jax_tree(jcfg)
    with pytest.raises(ValueError) as te:
        port_tree(cfg)
    assert str(te.value) == str(je.value)


def test_act_order_parts_with_differing_perms_raise(tmp_path):
    """Act-order q/k/v (and gate/up) parts whose permutations differ
    cannot merge into one leaf. They raised until the unmerged layout was
    ported (slice 13); now they load unmerged, as the JAX loader keeps
    them, equal to its tree, and the engine serves them with the JAX
    engine's logits and greedy tokens."""
    ovr, d = LLAMA, write(int4_tensors(LLAMA, "gptq", perms="differ"), str(tmp_path))
    jcfg, cfg = _cfgs(ovr, d)
    got = port_tree(cfg)
    assert "wq" in got and "wqkv" not in got and "w_gate" in got
    assert not torch.equal(got["wq"].in_perm, got["wk"].in_perm)
    assert_trees_equal(jax_tree(jcfg), got)
    eng = Engine(cfg, device="cpu")
    assert not eng.model.merged and eng.model.wq.in_perm is not None
    p = SampleParams(temperature=0.0, max_new_tokens=6)
    assert len(eng.generate("act order", p)) == 6
    # teacher-forced logits on the JAX loader's tree with its dense leaves
    # in f32: the JAX engine cannot serve this tree on the CPU (its int4
    # product is bf16 x bf16 -> f32, which XLA's CPU backend lacks)
    import jax.numpy as jnp
    from chitu_tpu.kvcache.paged import PagedKVCache as JCache

    model = jbuild(jcfg.models, jcfg)
    f32 = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
        jload_checkpoint(model, jcfg))
    page, ids = 16, IDS[:24]
    n, T = len(ids), 64
    spec = model.kv_cache_spec()
    cache = JCache(spec["n_layers"], T // page + 1, page, spec["kv_heads"],
                   spec["head_dim"], dtype=jnp.float32)
    tok = jnp.zeros((T,), jnp.int32).at[:n].set(jnp.asarray(ids))
    want, _ = model.prefill(
        f32, cache.arrays, tok, jnp.arange(T // page + 1, dtype=jnp.int32),
        jnp.int32(0), jnp.int32(n), page_size=page, attn_impl="xla",
        return_all_logits=True)
    eng.model.load_params(params_from_numpy(jax.tree_util.tree_map(np.asarray, f32)))
    assert not eng.model.merged
    np.testing.assert_allclose(all_logits(eng, ids), np.asarray(want[:n]),
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# Engines on loaded checkpoints
# ---------------------------------------------------------------------------

# With every weight drawn at 0.02 the two engines' bf16 logits differ by
# about 0.7 % of a row (their sums run in other orders), and the top two
# logits of a random row nearly tie often enough that a greedy choice
# flipped within 6 tokens. The engine cases draw the embedding at 1.0: the
# residual stream carries it, the layers add their 2 % to it, and their
# rounding noise stays far below the gaps a choice (or a router) decides.
ENGINE_CASES = {
    "llama": lambda d: (LLAMA, write(llama_tensors(LLAMA, 9, embed=1.0), d, torch.bfloat16)),
    "mixtral": lambda d: (MIXTRAL, write(mixtral_tensors(MIXTRAL, 9, embed=1.0), d,
                                         torch.bfloat16)),
    "deepseek_fp8": lambda d: (DEEPSEEK, write(_deepseek_fp8(deepseek_tensors(
        DEEPSEEK, 9, embed=1.0)), d)),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_greedy_matches_jax_engine(tmp_path, case):
    ovr, d = ENGINE_CASES[case](str(tmp_path))
    jcfg, cfg = _cfgs(ovr, d)
    prompts = ["the quick brown fox", "a", "loaded from disk " * 4]
    jeng = JEngine(jcfg)
    jr = [jeng.submit(p, JSampleParams(temperature=0.0, max_new_tokens=6)) for p in prompts]
    jeng.run_until_complete()
    eng = Engine(cfg, device="cpu")
    tr = [eng.submit(p, SampleParams(temperature=0.0, max_new_tokens=6)) for p in prompts]
    eng.run_until_complete()
    got = [list(r.async_stream.tokens) for r in tr]
    assert all(len(t) == 6 for t in got)
    assert got == [list(r.async_stream.tokens) for r in jr]
    if case == "deepseek_fp8":
        assert "exp_gu" in eng.model.moe_layers and eng.degraded == []
        assert isinstance(eng.model.moe_layers["wkv_b"], QTensor)


def test_engine_without_checkpoint_still_refuses_prequantized_random_weights():
    with pytest.raises(NotImplementedError, match="quant_on_load"):
        Engine(load_config(overrides=LLAMA + ["quant.method=w4a16"]), device="cpu")


# ---------------------------------------------------------------------------
# Teacher-forced logits against transformers
# ---------------------------------------------------------------------------

IDS = [int(x) for x in np.random.default_rng(0).integers(5, 500, 48)]
HF_DIMS = dict(vocab_size=512, hidden_size=128, intermediate_size=256,
               num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=4,
               max_position_embeddings=256, tie_word_embeddings=False)
HF_OVR = ["models=micro-llama-debug", "models.dim=128", "models.inter_dim=256",
          "models.n_layers=2", "models.n_heads=8", "models.n_kv_heads=4",
          "models.vocab_size=512", "infer.max_seq_len=128", "infer.page_size=16"]


def all_logits(eng, ids):
    """Teacher-forced prefill logits [n, V] through the port's model."""
    model, page = eng.model, eng.cfg.infer.page_size
    spec = model.kv_cache_spec()
    n, T = len(ids), 64
    cache = PagedKVCache(spec["n_layers"], T // page + 1, page, spec["kv_heads"],
                         spec["head_dim"], kv_dim=spec.get("kv_dim", 0),
                         layer_groups=spec.get("layer_groups"))
    tok = torch.zeros(T, dtype=torch.int32)
    tok[:n] = torch.tensor(ids)
    with torch.no_grad():
        logits, _ = model.prefill(cache.arrays, tok, torch.arange(T // page + 1, dtype=torch.int32),
                                  0, n, page, return_all_logits=True)
    return logits[:n].float().numpy()


def check_parity(eng, hf, top1=0.95, rel_tol=0.05):
    got = all_logits(eng, IDS)
    with torch.no_grad():
        want = hf(torch.tensor([IDS])).logits[0].float().numpy()
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= top1
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < rel_tol, rel
    return rel


def _unpermute(w, n_heads):
    out, din = w.shape
    return w.view(n_heads, 2, out // n_heads // 2, din).transpose(1, 2).reshape(out, din)


def _hf_case(case, d):
    """-> (transformers model, overrides or a config) with the checkpoint
    written in d."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    if case in ("llama", "meta_pth", "llama_f16"):
        hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(**HF_DIMS)).eval()
        ovr = HF_OVR + ["models.rotary_type=hf-llama"]
        if case == "llama_f16":
            hf.half().save_pretrained(d, safe_serialization=True)
            hf.float()
        elif case == "llama":
            hf.save_pretrained(d, safe_serialization=True)
        else:
            sd = hf.state_dict()
            t = {"tok_embeddings.weight": sd["model.embed_tokens.weight"],
                 "norm.weight": sd["model.norm.weight"], "output.weight": sd["lm_head.weight"]}
            for i in range(2):
                s, p = f"model.layers.{i}", f"layers.{i}"
                t[f"{p}.attention_norm.weight"] = sd[f"{s}.input_layernorm.weight"]
                t[f"{p}.ffn_norm.weight"] = sd[f"{s}.post_attention_layernorm.weight"]
                t[f"{p}.attention.wq.weight"] = _unpermute(sd[f"{s}.self_attn.q_proj.weight"], 8)
                t[f"{p}.attention.wk.weight"] = _unpermute(sd[f"{s}.self_attn.k_proj.weight"], 4)
                t[f"{p}.attention.wv.weight"] = sd[f"{s}.self_attn.v_proj.weight"]
                t[f"{p}.attention.wo.weight"] = sd[f"{s}.self_attn.o_proj.weight"]
                t[f"{p}.feed_forward.w1.weight"] = sd[f"{s}.mlp.gate_proj.weight"]
                t[f"{p}.feed_forward.w3.weight"] = sd[f"{s}.mlp.up_proj.weight"]
                t[f"{p}.feed_forward.w2.weight"] = sd[f"{s}.mlp.down_proj.weight"]
            torch.save(t, os.path.join(d, "consolidated.00.pth"))
            ovr = HF_OVR + ["models.type=llama", "models.rotary_type=llama"]
        return hf, ovr
    if case == "qwen2":
        hf = transformers.Qwen2ForCausalLM(transformers.Qwen2Config(**HF_DIMS)).eval()
        hf.save_pretrained(d, safe_serialization=True)
        return hf, HF_OVR + ["models.rotary_type=hf-llama", "models.attn_bias=true"]
    if case == "mixtral":
        hf = transformers.MixtralForCausalLM(transformers.MixtralConfig(
            **HF_DIMS, num_local_experts=4, num_experts_per_tok=2)).eval()
        hf.save_pretrained(d, safe_serialization=True)
        return hf, ["models=tiny-mixtral-debug", "models.dim=128", "models.inter_dim=256",
                    "models.n_layers=2", "models.n_heads=8", "models.n_kv_heads=4",
                    "models.vocab_size=512", "models.moe.n_routed_experts=4",
                    "models.moe.moe_inter_dim=256", "infer.max_seq_len=128",
                    "infer.page_size=16"]
    if case == "glm4":
        hf = transformers.GlmForCausalLM(transformers.GlmConfig(
            **HF_DIMS, head_dim=16, partial_rotary_factor=0.5, attention_bias=True,
            pad_token_id=0)).eval()
        sd = hf.state_dict()
        t = {"transformer.embedding.word_embeddings.weight": sd["model.embed_tokens.weight"],
             "transformer.encoder.final_layernorm.weight": sd["model.norm.weight"],
             "transformer.output_layer.weight": sd["lm_head.weight"]}
        for i in range(2):
            s, p = f"model.layers.{i}", f"transformer.encoder.layers.{i}"
            t[f"{p}.input_layernorm.weight"] = sd[f"{s}.input_layernorm.weight"]
            t[f"{p}.post_attention_layernorm.weight"] = sd[f"{s}.post_attention_layernorm.weight"]
            for kind in ("weight", "bias"):
                t[f"{p}.self_attention.query_key_value.{kind}"] = torch.cat(
                    [sd[f"{s}.self_attn.{x}_proj.{kind}"] for x in "qkv"])
            t[f"{p}.self_attention.dense.weight"] = sd[f"{s}.self_attn.o_proj.weight"]
            t[f"{p}.mlp.dense_h_to_4h.weight"] = sd[f"{s}.mlp.gate_up_proj.weight"]
            t[f"{p}.mlp.dense_4h_to_h.weight"] = sd[f"{s}.mlp.down_proj.weight"]
        st_save({k: v.contiguous() for k, v in t.items()}, os.path.join(d, "model.safetensors"))
        return hf, HF_OVR + ["models.rotary_type=glm4", "models.partial_rotary_factor=0.5",
                             "models.attn_bias=true"]
    if case == "deepseek":
        hf = transformers.DeepseekV3ForCausalLM(transformers.DeepseekV3Config(
            **{**HF_DIMS, "num_hidden_layers": 3, "num_attention_heads": 4,
               "num_key_value_heads": 4},
            moe_intermediate_size=128, first_k_dense_replace=1, n_routed_experts=8,
            num_experts_per_tok=2, n_shared_experts=1, n_group=4, topk_group=2,
            routed_scaling_factor=2.5, norm_topk_prob=True, q_lora_rank=32,
            kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
            rope_interleave=True, rope_scaling=None)).eval()
        hf.save_pretrained(d, safe_serialization=True)
        from chitu_tpu_torch.config import MLAArgs, MoEArgs

        cfg = load_config(overrides=DEEPSEEK[:1] + ["infer.max_seq_len=128",
                                                     "infer.page_size=16"])
        m = dataclasses.replace(
            cfg.models, dim=128, inter_dim=256, n_layers=3, n_heads=4, n_kv_heads=4,
            vocab_size=512, rope_scaling=None,
            moe=MoEArgs(n_routed_experts=8, n_shared_experts=1, n_activated_experts=2,
                        n_expert_groups=4, n_limited_groups=2, score_func="sigmoid",
                        route_scale=2.5, moe_inter_dim=128, n_dense_layers=1,
                        norm_topk_prob=True),
            mla=MLAArgs(q_lora_rank=32, kv_lora_rank=64, qk_nope_head_dim=32,
                        qk_rope_head_dim=16, v_head_dim=32))
        return hf, dataclasses.replace(cfg, models=m)
    raise ValueError(case)


@pytest.mark.parametrize("case", ["llama", "qwen2", "meta_pth", "glm4", "mixtral",
                                  "deepseek"])
def test_logits_match_transformers(tmp_path, case):
    hf, ovr = _hf_case(case, str(tmp_path))
    load = [f"models.ckpt_dir={tmp_path}", "infer.do_load=true"]
    if isinstance(ovr, list):
        cfg = load_config(overrides=ovr + load)
    else:  # a DeepSeek config built field by field, as the JAX test builds it
        cfg = dataclasses.replace(
            ovr, models=dataclasses.replace(ovr.models, ckpt_dir=str(tmp_path)),
            infer=dataclasses.replace(ovr.infer, do_load=True))
    # DeepSeek: sigmoid routing flips and near-tied random logits, the JAX
    # test's limits (tests/test_hf_parity.py:207-212)
    limits = (0.9, 0.08) if case == "deepseek" else (0.95, 0.05)
    check_parity(Engine(cfg, device="cpu"), hf, *limits)


def test_f16_checkpoint_loads_as_bf16(tmp_path):
    """A float16 checkpoint: the JAX loader keeps f16 leaves (under the
    default `keep_dtype_in_checkpoint`), the port casts them to bf16 (its
    GEMMs take one dtype). Every port leaf equals the JAX leaf cast to
    bf16, and the logits stay within the parity limits of transformers'
    f32 forward (ROADMAP C records the measured error)."""
    hf, ovr = _hf_case("llama_f16", str(tmp_path))
    jcfg, cfg = _cfgs(ovr, str(tmp_path))
    want = jax_tree(jcfg)
    assert want["wqkv"].dtype == torch.float16
    got = port_tree(cfg)
    assert_trees_equal({k: v.to(torch.bfloat16) for k, v in want.items()}, got)
    check_parity(Engine(cfg, device="cpu"), hf)
