"""Checkpoint loading: format adapters -> the port's parameter tree.

Counterpart of `chitu_tpu/loader.py` (reference: chitu/backend.py:311-481
and models/model.py:297-399), the eager single-device paths: HF
safetensors and Meta `.pth` checkpoints, name remapping per family, the
[out, in] -> [in, out] transposes, AWQ/GPTQ packed projections and
blockwise-fp8 projections as QTensors, and the preprocessed dump
(`save_preprocessed` / `load_preprocessed`, reference:
script/preprocess_and_save.py).

Every checkpoint tensor stays a view of its mapped file until a leaf
takes it: each stacked leaf is allocated on the device once and filled
there one layer (or one expert) at a time, transposed and cast on the
device, so the host holds no copy of the weights. The tree is the one
`models.llama.params_from_numpy` gives for the JAX loader's tree:
{"embed", "norm", "lm_head", "layers": {...}} with the projections
merged (`wqkv`, `w_gate_up`, `b_qkv`), since the port takes the merged
layout only.

dtype: every float leaf that is not fp8 becomes bfloat16. The JAX
loader keeps f16 leaves as f16 under `keep_dtype_in_checkpoint` and
lets `jnp.dot` promote f16 x bf16; `torch.matmul` takes no mixed dtypes,
so the port casts them (ROADMAP C records the difference).

Not ported here: the streamed shard loads (`loader_streaming.py` and the
`_load_*_streaming` paths, ROADMAP A), which exist for multi-device
bring-up.
"""

from __future__ import annotations

import itertools
import json
import os
import re
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from chitu_tpu_torch.ops.qtensor import TENSOR_FIELDS, QTensor, QuantKind
from chitu_tpu_torch.parallel.sharding import even_range, shard_tensor
from chitu_tpu_torch.utils import get_logger
from chitu_tpu_torch.utils.safetensors import Reader, save_file

logger = get_logger()


# ---------------------------------------------------------------------------
# Raw tensor access
# ---------------------------------------------------------------------------


# MP-sharded Meta checkpoints: concatenation dim per tensor family
# ([out, in] torch layout; column-parallel splits out=0, row-parallel
# in=1, ParallelEmbedding the hidden dim=1; norms are replicated)
_META_MP_CAT = {
    "attention.wq": 0, "attention.wk": 0, "attention.wv": 0,
    "feed_forward.w1": 0, "feed_forward.w3": 0, "output": 0,
    "attention.wo": 1, "feed_forward.w2": 1, "tok_embeddings": 1,
}


def _meta_mp_dim(key: str):
    for fam, dim in _META_MP_CAT.items():
        if fam in key:
            return dim
    return None  # replicated (norms, rope freqs)


class Checkpoint:
    """Every tensor of a checkpoint directory by name, read lazily: the
    `*.safetensors` files through mapped views, else Meta
    `consolidated*.pth` files through `torch.load(mmap=True)`, whose mp
    shards join along each family's parallel dim. `nbytes` counts the
    stored bytes of every tensor handed out."""

    def __init__(self, ckpt_dir: str):
        self.nbytes = 0
        self._st: Optional[Reader] = None
        self._pth: List[Dict[str, torch.Tensor]] = []
        if any(f.endswith(".safetensors") for f in os.listdir(ckpt_dir)):
            self._st = Reader(ckpt_dir)
            return
        files = sorted(
            f for f in os.listdir(ckpt_dir)
            if re.match(r"consolidated.*\.pth", f)
        )
        if not files:
            raise FileNotFoundError(
                f"no .safetensors or consolidated*.pth under {ckpt_dir}"
            )
        self._pth = [
            torch.load(os.path.join(ckpt_dir, f), map_location="cpu",
                       mmap=True, weights_only=True)
            for f in files
        ]

    def keys(self) -> List[str]:
        return self._st.keys() if self._st is not None else list(self._pth[0])

    def __contains__(self, key: str) -> bool:
        return key in (self._st.index if self._st is not None else self._pth[0])

    def shape(self, key: str) -> Tuple[int, ...]:
        if self._st is not None:
            return self._st.info(key).shape
        return tuple(self.get(key, count=False).shape)

    def get(self, key: str, count: bool = True) -> torch.Tensor:
        """The stored tensor on the host (a view of its mapped pages where
        the format allows: drop it once copied), in its stored dtype."""
        if self._st is not None:
            t = self._st.get_tensor(key)
        elif len(self._pth) == 1 or _meta_mp_dim(key) is None:
            t = self._pth[0][key]
        else:
            t = torch.cat([sd[key] for sd in self._pth], dim=_meta_mp_dim(key))
        if count:
            self.nbytes += t.numel() * t.element_size()
        return t


def iter_checkpoint(ckpt_dir: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """Every (name, tensor) of a checkpoint, in file order: views of the
    mapped safetensors files, or the Meta `.pth` tensors with mp shards
    joined."""
    ck = Checkpoint(ckpt_dir)
    for key in ck.keys():
        yield key, ck.get(key)


# ---------------------------------------------------------------------------
# HF name mapping (llama family)
# ---------------------------------------------------------------------------

# HF checkpoint key patterns -> (tree path, transpose). Linear weights are
# stored [out, in] in HF/torch; the port's layout is [in, out].
_HF_LLAMA_RULES: List[Tuple[str, Tuple[str, ...], bool]] = [
    (r"model\.embed_tokens\.weight", ("embed",), False),
    (r"model\.norm\.weight", ("norm",), False),
    (r"lm_head\.weight", ("lm_head",), True),
    (r"model\.layers\.(\d+)\.input_layernorm\.weight", ("layers", "attn_norm"), False),
    (r"model\.layers\.(\d+)\.post_attention_layernorm\.weight", ("layers", "ffn_norm"), False),
    (r"model\.layers\.(\d+)\.self_attn\.q_proj\.weight", ("layers", "wq"), True),
    (r"model\.layers\.(\d+)\.self_attn\.k_proj\.weight", ("layers", "wk"), True),
    (r"model\.layers\.(\d+)\.self_attn\.v_proj\.weight", ("layers", "wv"), True),
    (r"model\.layers\.(\d+)\.self_attn\.o_proj\.weight", ("layers", "wo"), True),
    (r"model\.layers\.(\d+)\.self_attn\.q_proj\.bias", ("layers", "bq"), False),
    (r"model\.layers\.(\d+)\.self_attn\.k_proj\.bias", ("layers", "bk"), False),
    (r"model\.layers\.(\d+)\.self_attn\.v_proj\.bias", ("layers", "bv"), False),
    (r"model\.layers\.(\d+)\.mlp\.gate_proj\.weight", ("layers", "w_gate"), True),
    (r"model\.layers\.(\d+)\.mlp\.up_proj\.weight", ("layers", "w_up"), True),
    (r"model\.layers\.(\d+)\.mlp\.down_proj\.weight", ("layers", "w_down"), True),
]

# Meta-Llama original naming (reference: chitu/models/model_llama.py)
_META_LLAMA_RULES: List[Tuple[str, Tuple[str, ...], bool]] = [
    (r"tok_embeddings\.weight", ("embed",), False),
    (r"norm\.weight", ("norm",), False),
    (r"output\.weight", ("lm_head",), True),
    (r"layers\.(\d+)\.attention_norm\.weight", ("layers", "attn_norm"), False),
    (r"layers\.(\d+)\.ffn_norm\.weight", ("layers", "ffn_norm"), False),
    (r"layers\.(\d+)\.attention\.wq\.weight", ("layers", "wq"), True),
    (r"layers\.(\d+)\.attention\.wk\.weight", ("layers", "wk"), True),
    (r"layers\.(\d+)\.attention\.wv\.weight", ("layers", "wv"), True),
    (r"layers\.(\d+)\.attention\.wo\.weight", ("layers", "wo"), True),
    (r"layers\.(\d+)\.feed_forward\.w1\.weight", ("layers", "w_gate"), True),
    (r"layers\.(\d+)\.feed_forward\.w3\.weight", ("layers", "w_up"), True),
    (r"layers\.(\d+)\.feed_forward\.w2\.weight", ("layers", "w_down"), True),
]

# HF projection names -> the tree's
_PROJ = {
    "q_proj": "wq", "k_proj": "wk", "v_proj": "wv", "o_proj": "wo",
    "gate_proj": "w_gate", "up_proj": "w_up", "down_proj": "w_down",
}


def _match_rules(rules, key):
    for pat, path, transpose in rules:
        m = re.fullmatch(pat, key)
        if m:
            layer = int(m.group(1)) if m.groups() else None
            return path, layer, transpose
    return None, None, False


def _target_dtype(cfg, name: str) -> torch.dtype:
    """The dtype of a float leaf that is not fp8: bfloat16 (see the module
    docstring on `keep_dtype_in_checkpoint`)."""
    return torch.bfloat16


# ---------------------------------------------------------------------------
# Device placement
# ---------------------------------------------------------------------------


def to_device(t: torch.Tensor, device, dtype: Optional[torch.dtype] = None,
              transpose: bool = False) -> torch.Tensor:
    """One stored tensor onto the device as it is stored, then transposed
    (2-D only) and cast there. fp8 moves and transposes as its bytes."""
    fp8 = t.dtype == torch.float8_e4m3fn
    x = (t.view(torch.uint8) if fp8 else t).to(device)
    if transpose and x.dim() == 2:
        x = x.T
    x = x.contiguous()
    if fp8:
        x = x.view(torch.float8_e4m3fn)
    if dtype is not None and x.dtype != dtype and x.is_floating_point():
        x = x.to(dtype)
    if x.numel() and x.data_ptr() == t.data_ptr():
        # still the mapped file's pages (a CPU load): a leaf owns its memory
        x = x.clone()
    return x


def as_e4m3(t: torch.Tensor) -> torch.Tensor:
    """fp8 weight bytes as stored (e4m3, or their uint8 lanes) -> e4m3."""
    if t.dtype == torch.uint8:
        return t.view(torch.float8_e4m3fn)
    return t.to(torch.float8_e4m3fn)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def fill_stacked(lead: Tuple[int, ...], make: Callable[[tuple], Any]):
    """A stacked leaf of shape `lead + piece shape`, allocated once on the
    piece's device and filled piece by piece: `make(idx)` returns the
    piece at index `idx` (a tensor or a QTensor), and only one piece lives
    beside the leaf. QTensor pieces keep their kind and block; when any
    has an `in_perm` (act-order GPTQ) every piece gets a row, the identity
    where it has none."""
    out, perms, sig = None, [], None
    for idx in itertools.product(*map(range, lead)):
        p = make(idx)
        q = isinstance(p, QTensor)
        s = (q, p.kind, p.block, p.data.shape) if q else (q, p.shape, p.dtype)
        if out is None:
            sig = s
            if q:
                out = p.without("in_perm")._map(
                    lambda t: torch.empty(
                        (*lead, *t.shape), dtype=t.dtype, device=t.device)
                )
            else:
                out = torch.empty((*lead, *p.shape), dtype=p.dtype,
                                  device=p.device)
        if s != sig:
            raise ValueError(
                f"stacked leaf at {idx}: the piece differs from the first "
                "(quantized and dense layers mixed, or another shape, kind "
                "or group size)"
            )
        if q:
            for name in TENSOR_FIELDS:
                if name != "in_perm" and getattr(p, name) is not None:
                    _bytes(getattr(out, name)[idx]).copy_(_bytes(getattr(p, name)))
            perms.append(p.in_perm)
        else:
            _bytes(out[idx]).copy_(_bytes(p))
        del p
    if isinstance(out, QTensor) and any(v is not None for v in perms):
        # a permutation row spans the whole input (a row-parallel shard
        # holds fewer rows than it indexes)
        K = next(v for v in perms if v is not None).shape[-1]
        rows = [
            v if v is not None
            else torch.arange(K, dtype=torch.int32, device=out.data.device)
            for v in perms
        ]
        out.in_perm = torch.stack(rows).reshape(*lead, K)
    return out


def fp8_qtensor(data: torch.Tensor, scale_inv: torch.Tensor) -> QTensor:
    """A blockwise-fp8 projection on the device: e4m3 [out, in] + its
    `weight_scale_inv` [out/128, in/128] -> a SOFT_FP8 QTensor, data
    [in, out], scale [in/128, out/128] f32 (`_maybe_fp8` of the JAX
    loader)."""
    return QTensor(
        data=to_device(as_e4m3(data), scale_inv.device, transpose=True),
        scale=scale_inv.float().T.contiguous(),
        kind=QuantKind.SOFT_FP8,
        block=128,
    )


def merge_llama_leaves(layers: Dict[str, Any], model=None) -> Dict[str, Any]:
    """The model's layout, in place (`TPLayout.assemble`): when it merges
    (always without a model), wq/wk/wv -> wqkv, bq/bk/bv -> b_qkv, and but
    for MoE expert stacks w_gate/w_up -> w_gate_up, dense or quantized;
    parts that cannot merge stay unmerged."""
    from chitu_tpu_torch.models.llama import TPLayout

    lay = getattr(model, "layout", None) or TPLayout()
    return lay.assemble(layers)


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------


def stage_layers(model, stack: str = "layers") -> List[int]:
    """The layers of `stack` that the model's pipeline stage holds (every
    layer on one stage)."""
    lay = getattr(model, "layout", None)
    n = (model.args.n_layers if stack == "layers"
         else model.n_dense if stack == "dense_layers" else model.n_moe)
    r = lay.stage.ranges.get(stack) if lay is not None else None
    if stack == "moe_layers":
        base = model.n_dense
        return [base + i for i in range(*(r or (0, n)))]
    return list(range(*(r or (0, n))))


def layers_to_read(model) -> Tuple[List[int], bool]:
    """(the layers of the "layers" stack to read, whether the stage holds
    any): a pipeline stage that holds none (fewer layers than stages)
    reads layer 0 for its leaves' shapes and cuts them to none after
    (`no_layers`)."""
    layers = stage_layers(model)
    return (layers, True) if layers else ([0], False)


def no_layers(leaves: Dict[str, Any]) -> Dict[str, Any]:
    """Each stacked leaf cut to none of its layers, owning no storage."""
    def cut(t):
        return t[:0].clone()

    return {k: v._map(cut) if isinstance(v, QTensor) else cut(v)
            for k, v in leaves.items()}


def rank_view(lay, name: Optional[str], view: torch.Tensor,
              transpose: bool = False) -> torch.Tensor:
    """The rank's slice of a mapped view of one piece of the leaf `name`
    (stored [out, in] when `transpose`) under the layout's tensor-parallel
    cut, before it is copied; the view itself on one rank or without a
    name."""
    if lay is None or lay.tp <= 1 or name is None:
        return view
    spec = lay.part_spec(name, view.dim())
    if transpose and view.dim() == 2:
        spec = spec[::-1]
    return shard_tensor(view, spec, lay.rank, lay.tp)


def rank_experts(lay, n_experts: int) -> List[int]:
    """The experts a rank holds under expert parallelism: its contiguous
    range, E // tp of them, the first E % tp ranks one more
    (`sharding.even_range`)."""
    if lay is None or lay.tp <= 1:
        return list(range(n_experts))
    return list(range(*even_range(n_experts, lay.rank, lay.tp)))


def holds(model, name: str) -> bool:
    """Does the model's pipeline stage hold the top-level leaf `name`?"""
    lay = getattr(model, "layout", None)
    return lay is None or lay.stage.holds(name)


def load_llama_params(model, cfg, device=None) -> Dict[str, Any]:
    """Assemble the llama-family parameter tree from `model.args.ckpt_dir`
    on `device` (the model's by default): the layers of the model's
    pipeline stage, and the embedding, norm and head where it holds
    them."""
    from chitu_tpu_torch.quantize.packed import unpack_awq, unpack_gptq

    a = model.args
    dev = torch.device(device) if device is not None else model.device
    ck = Checkpoint(a.ckpt_dir)
    rules = _META_LLAMA_RULES if a.type == "llama" else _HF_LLAMA_RULES
    L = a.n_layers
    bf16 = _target_dtype(cfg, "")

    flat: Dict[str, Tuple[str, bool]] = {}  # name -> (key, transpose)
    staged: Dict[str, List[Optional[Tuple[str, bool]]]] = {}
    # AWQ/GPTQ packed projections: (layer, name) -> {qweight, ...: key}
    packed: Dict[Tuple[int, str], Dict[str, str]] = {}
    # fp8 checkpoints: blockwise weight scales, (layer, name) -> key
    fp8_scales: Dict[Tuple[int, str], str] = {}

    t0 = time.time()
    for key in ck.keys():
        pm = re.fullmatch(
            r"model\.layers\.(\d+)\.(self_attn|mlp)\.(\w+)\.(qweight|qzeros|scales|g_idx)",
            key,
        )
        if pm and pm.group(3) in _PROJ:
            packed.setdefault((int(pm.group(1)), _PROJ[pm.group(3)]), {})[
                pm.group(4)] = key
            continue
        sm = re.fullmatch(
            r"model\.layers\.(\d+)\.(self_attn|mlp)\.(\w+)"
            r"\.weight_scale(_inv)?",
            key,
        )
        if sm:
            shape = ck.shape(key)
            if sm.group(3) not in _PROJ or len(shape) != 2:
                # rowwise / unknown fp8 scale layouts: refuse rather than
                # load unscaled fp8 weights that generate garbage
                raise ValueError(
                    f"unsupported fp8 scale layout for {key!r} "
                    f"(shape {shape}); expected blockwise "
                    "weight_scale_inv [out_blocks, in_blocks]"
                )
            fp8_scales[(int(sm.group(1)), _PROJ[sm.group(3)])] = key
            continue
        if key.endswith(("weight_scale", "weight_scale_inv")):
            raise ValueError(
                f"fp8 scale key {key!r} matched no loader rule; refusing "
                "to load fp8 weights without their scales"
            )
        path, layer, transpose = _match_rules(rules, key)
        if path is None:
            logger.debug("skipping checkpoint key %s", key)
            continue
        if layer is None:
            flat[path[0]] = (key, transpose)
        else:
            staged.setdefault(path[1], [None] * L)[layer] = (key, transpose)

    lay = getattr(model, "layout", None)
    cut = lay is not None and lay.tp > 1
    layers, held = layers_to_read(model)
    n = len(layers)

    def take(key, dtype=None, transpose=False, name=None):
        # the rank's slice of the mapped view, before it is copied
        view = rank_view(lay, name, ck.get(key), transpose)
        return to_device(view, dev, dtype, transpose)

    def local(name, q):
        # a quantized layer is assembled on the device, then cut
        return lay.local(name, q).contiguous() if cut else q

    params: Dict[str, Any] = {"layers": {}}
    ly = params["layers"]
    for name, (key, transpose) in flat.items():
        if holds(model, name):
            params[name] = take(key, bf16, transpose, name)
    if "lm_head" not in flat and not a.tie_word_embeddings and holds(
            model, "lm_head"):
        # tied checkpoints without an explicit head
        key, transpose = flat["embed"]
        params["lm_head"] = take(key, bf16, transpose, "embed").T.contiguous()

    if packed:
        # offline-quantized checkpoint (AWQ / GPTQ; reference load paths:
        # backend.py:321-347): unpacked on the device into W4A16 QTensors
        by_name: Dict[str, List[Optional[Dict[str, str]]]] = {}
        for (layer, name), parts in packed.items():
            by_name.setdefault(name, [None] * L)[layer] = parts

        def unpack(parts):
            qw, sc = take(parts["qweight"]), take(parts["scales"])
            qz = take(parts["qzeros"])
            # AWQ packs the out dim ([in, out/8]); GPTQ the in dim ([in/8, out])
            if qw.shape[1] * 8 == sc.shape[1]:
                return unpack_awq(qw, qz, sc, group_size=qw.shape[0] // sc.shape[0])
            g_idx = take(parts["g_idx"]) if "g_idx" in parts else None
            return unpack_gptq(qw, qz, sc, group_size=qw.shape[0] * 8 // sc.shape[0],
                               g_idx=g_idx)

        for name, vals in by_name.items():
            missing = [i for i in layers if vals[i] is None]
            if missing:
                raise ValueError(f"packed ckpt missing {name} layers {missing}")
            staged.pop(name, None)
            ly[name] = fill_stacked(
                (n,), lambda idx, v=vals, nm=name: local(
                    nm, unpack(v[layers[idx[0]]])))

    fp8_names = {name for (_, name) in fp8_scales}
    for name, pieces in staged.items():
        missing = [i for i in layers if pieces[i] is None]
        if missing:
            raise ValueError(f"checkpoint missing {name} for layers {missing}")
        if name in fp8_names:
            # fp8 weights + blockwise scales -> SOFT_FP8 QTensor stacks;
            # silently dropping the scales would load unscaled fp8 garbage
            sc_missing = [i for i in layers if (i, name) not in fp8_scales]
            if sc_missing:
                raise ValueError(
                    f"fp8 checkpoint missing {name} scales for layers "
                    f"{sc_missing}"
                )
            ly[name] = fill_stacked((n,), lambda idx, nm=name, p=pieces: local(
                nm, fp8_qtensor(take(p[layers[idx[0]]][0]),
                                take(fp8_scales[(layers[idx[0]], nm)]))))
            continue
        ly[name] = fill_stacked(
            (n,), lambda idx, p=pieces, nm=name: take(
                p[layers[idx[0]]][0], bf16, p[layers[idx[0]]][1], nm))
    logger.info("read %d tensors (%.2f GB) in %.1fs", len(ck.keys()),
                ck.nbytes / 1e9, time.time() - t0)
    merge_llama_leaves(ly, model)
    if not held:
        params["layers"] = no_layers(ly)
    return params


def load_checkpoint(model, cfg, device=None) -> Dict[str, Any]:
    """Entry point used by the engine (reference: backend.py:311-394): the
    preprocessed dump under `<ckpt_dir>/chitu_tpu_preprocessed` when
    `skip_preprocess` is set and it exists, else the family's loader (HF
    Llama / Qwen2 / Meta, GLM-4 by `rotary_type`, Mixtral, DeepSeek)."""
    from chitu_tpu_torch import loaders_moe

    a = model.args
    pre = os.path.join(a.ckpt_dir or "", "chitu_tpu_preprocessed")
    if cfg.skip_preprocess and os.path.isdir(pre):
        return load_preprocessed(pre, model=model, device=device)
    if a.type == "mixtral":
        return loaders_moe.load_mixtral_params(model, cfg, device)
    if a.type == "deepseek-v3":
        return loaders_moe.load_deepseek_params(model, cfg, device)
    if a.rotary_type == "glm4":
        return loaders_moe.load_glm4_params(model, cfg, device)
    return load_llama_params(model, cfg, device)


# ---------------------------------------------------------------------------
# Preprocess-and-save (reference: script/preprocess_and_save.py)
# ---------------------------------------------------------------------------

# dtype names in meta.json: the JAX package's (numpy) names
_DT_NAME = {
    torch.bfloat16: "bfloat16", torch.float16: "float16",
    torch.float32: "float32", torch.float8_e4m3fn: "float8_e4m3fn",
    torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
    torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool",
}
_DT_BY_NAME = {v: k for k, v in _DT_NAME.items()}


def save_preprocessed(
    params: Dict[str, Any],
    out_dir: str,
    num_shards: int = 1,
    layout: Optional[Dict[str, Any]] = None,
):
    """Dump the fully transformed tree for fast startup. QTensor leaves
    keep their structure through `#qt.<field>` key suffixes, with kind and
    block in `meta.json`; the keys are the tree's paths joined by `/`.

    `num_shards > 1` spreads the keys over `model.shard{r}of{N}.safetensors`
    files, size-balanced. `layout` records what the bytes cannot say:
    `merge_tp`, the chunk count of the merged qkv / gate-up columns (1 in
    the port). meta.json also lists the files this dump wrote, so a dump
    into a directory holding an older one's shards reads only its own."""
    os.makedirs(out_dir, exist_ok=True)
    tensors: Dict[str, torch.Tensor] = {}
    meta: Dict[str, Any] = {"dtypes": {}, "qtensors": {}}

    def put(key: str, t: torch.Tensor):
        meta["dtypes"][key] = _DT_NAME[t.dtype]
        tensors[key] = t

    def walk(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}{k}/")
            return
        key = prefix.rstrip("/")
        if isinstance(tree, QTensor):
            meta["qtensors"][key] = {"kind": tree.kind.value, "block": tree.block}
            for name in TENSOR_FIELDS:
                if getattr(tree, name) is not None:
                    put(f"{key}#qt.{name}", getattr(tree, name))
            return
        put(key, tree)

    walk(params)
    buckets: List[Dict[str, torch.Tensor]] = [{} for _ in range(max(num_shards, 1))]
    sizes = [0] * len(buckets)
    for key, t in sorted(tensors.items(), key=lambda kv: -kv[1].numel() * kv[1].element_size()):
        r = sizes.index(min(sizes))  # greedy size-balanced assignment
        buckets[r][key] = t
        sizes[r] += t.numel() * t.element_size()
    files: List[str] = []
    for r, bucket in enumerate(buckets):
        if bucket:
            fname = ("model.safetensors" if len(buckets) == 1 else
                     f"model.shard{r:03d}of{num_shards:03d}.safetensors")
            files.append(fname)
            save_file(bucket, os.path.join(out_dir, fname))
    meta["files"] = files
    meta["layout"] = layout or {}
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f)


def load_preprocessed(out_dir: str, model=None, device=None) -> Dict[str, Any]:
    """Load a preprocessed tree (this package's dump or the JAX
    package's), each leaf straight to `device` (the model's, else the
    CPU). The JAX package stores bf16 and e4m3 leaves as their uint16 /
    uint8 lanes: meta.json's dtypes restore them. A llama-family dump
    holding unmerged projections (the JAX package keeps quantized q/k/v
    and gate/up unmerged) is merged as the loader merges."""
    with open(os.path.join(out_dir, "meta.json")) as f:
        meta = json.load(f)
    dtypes = meta.get("dtypes", {})
    qmeta = meta.get("qtensors", {})
    reader = Reader(out_dir, files=meta.get("files"))

    # merged projections are chunked per merge_tp (rank-major when the
    # dump was made under tensor parallelism): a model splits them into
    # their parts again (`TPLayout.place`), and cuts its rank's slices
    saved_mtp = int(meta.get("layout", {}).get("merge_tp", 1))
    lay = getattr(model, "layout", None)
    merged_keys = any("wqkv" in k or "w_gate_up" in k for k in reader.keys())
    if saved_mtp != 1 and merged_keys and lay is None:
        raise ValueError(
            f"preprocessed dump stores merged projections with "
            f"merge_tp={saved_mtp} but the engine expects merge_tp=1: "
            f"re-run preprocess_and_save with infer.tp_size=1 (the "
            f"rank-major merged column layout is tp-specific)"
        )
    if device is None:
        device = model.device if model is not None else torch.device("cpu")
    cut = lay is not None and (lay.tp > 1 or saved_mtp != 1 or not lay.merged
                               or lay.stage.pp > 1)
    # a leaf that is cut stays a view of the mapped file until its slice
    # is copied to the device
    dest = torch.device("cpu") if cut else device

    def leaf(key):
        t = reader.get_tensor(key)
        want = _DT_BY_NAME.get(dtypes.get(key, ""), t.dtype)
        if want != t.dtype:
            if want.itemsize != t.element_size():
                raise ValueError(f"{key}: stored {t.dtype}, meta.json says {want}")
            t = t.view(want)
        return t if cut else to_device(t, dest)

    tree: Dict[str, Any] = {}
    qparts: Dict[str, Dict[str, torch.Tensor]] = {}

    def insert(key, val):
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    for key in reader.keys():
        if "#qt." in key:
            base, field = key.split("#qt.")
            qparts.setdefault(base, {})[field] = leaf(key)
        else:
            insert(key, leaf(key))
    for base, fields in qparts.items():
        info = qmeta[base]
        insert(base, QTensor(kind=QuantKind(info["kind"]), block=int(info["block"]),
                             **{n: fields.get(n) for n in TENSOR_FIELDS}))
    if cut and "layers" in tree:
        flat = {k: v for k, v in tree.items() if k != "layers"}
        flat.update(tree.pop("layers"))
        out: Dict[str, Any] = {}
        for k in list(flat):
            for n, v in lay.place(k, flat.pop(k), saved_mtp).items():
                out[n] = (v.to(device).contiguous() if isinstance(v, QTensor)
                          else to_device(v, device))
        ly = {k: out.pop(k) for k in list(out) if k in model.LAYER_LEAVES}
        tree = {**out, "layers": lay.assemble(ly)}
    elif cut:
        # DeepSeek's two stacks: the stage's layers and the rank's slices
        # (`MLALayout.tree`), then the device
        def dev(t):
            if isinstance(t, dict):
                return {k: dev(v) for k, v in t.items()}
            if isinstance(t, QTensor):
                return t.to(device).contiguous()
            return to_device(t, device)

        tree = dev(lay.tree(tree))
    elif "layers" in tree:
        merge_llama_leaves(tree["layers"], model)
    return tree
