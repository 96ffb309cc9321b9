"""Streamed shard loads (`chitu_tpu_torch/loader_streaming.py`): under a
tp=2 layout each rank reads from a checkpoint only its own slice of every
leaf, in every format the port loads. The counterpart of
`tests/test_streaming_load.py`, on the CPU in one process: each rank's
layout is set on a model built for one rank (no world of processes), as
`tests/test_torch_tp.py::test_loader_cuts_rank_slices` does.

Checkpoints are written from numpy draws of a fixed seed
(`tests/test_torch_loader.py`'s writers) at tiny widths. Held:
- each rank's tree equals the JAX package's streaming loader's tree
  (`load_checkpoint(model, cfg, mesh)` on a tp=2 mesh of the virtual CPU
  devices, gathered) cut for that rank by `params_from_numpy`, bit for
  bit, QTensor views (`rows`, `cols`) included;
- it equals the whole-then-cut tree: the one-rank load of the same files,
  unmerged, each leaf cut by the layout (`lay.local`) and merged again,
  which is what the loader did before it streamed;
- `placement_stats()`: the bytes a rank read are, tensor by tensor, the
  whole of a replicated tensor, or its share of a cut one plus at most
  one word, group or block on its cut edge (and no more than the whole);
  they add up to `total_bytes`; the largest buffer it copied is smaller
  than the whole piece of the leaf it belongs to;
- at tp == mp a Meta `.pth` rank reads its cut leaves from its own
  `consolidated.NN.pth` alone.
The edge geometry (`inter_dim` 200, AWQ / GPTQ groups of 8) puts the FFN
cut at 100 inside a word (AWQ's packed columns, GPTQ's zero points), a
group (8) and a 128 x 128 fp8 block.
"""

import dataclasses
import importlib
import os
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import test_torch_loader as tl
from chitu_tpu.models import build_model as jbuild
from chitu_tpu.parallel import make_mesh
from chitu_tpu_torch.loader_streaming import (
    LazySlice,
    placement_stats,
    reset_placement_stats,
)
from chitu_tpu_torch.models.deepseek_v3 import MLALayout
from chitu_tpu_torch.models.llama import TPLayout, params_from_numpy
from chitu_tpu_torch.ops.qtensor import TENSOR_FIELDS, QTensor
from chitu_tpu_torch.utils.safetensors import read_header

TP = 2
EDGE_F = 200  # the FFN cut at 100: inside a word, a group of 8, a block
EDGE_G = 8


@pytest.fixture(autouse=True)
def _jax_op_impl_auto():
    """The JAX op_impl switch at "auto" (ROADMAP C.1)."""
    mod = importlib.import_module("chitu_tpu.ops.linear")
    old = mod._OP_IMPL
    mod._OP_IMPL = "auto"
    yield
    mod._OP_IMPL = old


def _edge(fmt, d):
    """-> (overrides, dir) of a checkpoint in the edge geometry."""
    ovr = tl.LLAMA + [f"models.inter_dim={EDGE_F}"]
    if fmt == "edge_fp8":
        ovr = tl.LLAMA_FP8 + [f"models.inter_dim={EDGE_F}"]
        t = tl.to_fp8(tl.llama_tensors(ovr), lambda k: k.endswith("_proj.weight"))
        return ovr, tl.write(t, str(d))
    old = tl.G
    tl.G = EDGE_G
    try:
        kind = "awq" if fmt == "edge_awq" else "gptq"
        return ovr, tl.write(tl.int4_tensors(ovr, kind), str(d))
    finally:
        tl.G = old


def checkpoint(fmt, d):
    return _edge(fmt, d) if fmt.startswith("edge_") else tl.checkpoint(fmt, d)


def _cfgs(ovr, d, tp=1):
    return tl._cfgs(ovr, d, extra=[f"infer.tp_size={tp}"])


def layout(model, rank, tp, merged=None):
    """Rank `rank`'s layout of `tp` on a model built for one rank (the
    merge decision of `LlamaForCausalLM._init_tp` under auto)."""
    a = model.args
    if isinstance(model.layout, MLALayout):
        return MLALayout(rank, tp, a.n_heads)
    div = a.n_heads % tp == 0 and a.n_kv_heads % tp == 0 and model.inter_dim % tp == 0
    return TPLayout(rank, tp, a.n_heads, a.n_kv_heads, model.head_dim,
                    model.inter_dim, a.vocab_size,
                    merged=div if merged is None else merged,
                    moe=model.layout.moe)


def _flat(tree):
    if "layers" in tree:
        return {**{k: v for k, v in tree.items() if k != "layers"}, **tree["layers"]}
    return tree


def port_load(ovr, d, rank=0, tp=1, merged=None):
    """The port loader under rank `rank`'s layout -> (tree, layout,
    placement_stats, the host buffers read: [(file, key, bytes)])."""
    _, cfg = _cfgs(ovr, d)
    model = tl.build_model(cfg.models, cfg, device="cpu")
    model.layout = lay = layout(model, rank, tp, merged)
    reads = []
    host = LazySlice.host

    def spy(self, box=None):
        v = host(self, box)
        reads.append((os.path.basename(self.source), self.key,
                      v.numel() * v.element_size()))
        return v

    with mock.patch.object(LazySlice, "host", spy):
        reset_placement_stats()
        tree = tl.load_checkpoint(model, cfg, "cpu")
        stats = placement_stats()
    return _flat(tree), lay, stats, reads


def same(want, got, path=""):
    """Bit equality of two trees, QTensor views included."""
    assert sorted(want) == sorted(got), path
    for k in want:
        a, b, p = want[k], got[k], f"{path}{k}"
        if isinstance(a, dict):
            same(a, b, p + "/")
        elif isinstance(a, QTensor):
            assert isinstance(b, QTensor), p
            assert (a.kind, a.block, a.rows, a.cols) == (b.kind, b.block, b.rows, b.cols), p
            for n in TENSOR_FIELDS:
                x, y = getattr(a, n), getattr(b, n)
                assert (x is None) == (y is None), (p, n)
                if x is not None:
                    tl._same(x, y)
        else:
            assert not isinstance(b, QTensor), p
            tl._same(a, b)


def jax_tree(ovr, d):
    """The JAX package's loader on a tp=2 mesh, gathered -> (numpy tree,
    its merge_tp)."""
    jcfg, _ = _cfgs(ovr, d, TP)
    m = jbuild(jcfg.models, jcfg)
    tree = tl.jload_checkpoint(m, jcfg, make_mesh(1, 1, TP))
    return jax.tree_util.tree_map(lambda x: np.asarray(jax.device_get(x)), tree), \
        getattr(m, "merge_tp", 1)


def whole_then_cut(ovr, d, lay):
    """The one-rank load of the same files, each leaf cut to `lay`'s slice
    after it is whole, then merged where `lay` merges."""
    tree, one, _, _ = port_load(ovr, d, merged=False)
    if isinstance(lay, MLALayout):
        return lay.tree(tree)
    out = {k: lay.local(k, v) for k, v in tree.items()}
    ly = {k: out.pop(k) for k in list(out) if k not in ("embed", "norm", "lm_head")}
    return {**out, **lay.assemble(ly)}


# the JAX reference and the one-rank loads, once per format
_CACHE = {}


def loaded(fmt, tmp_path_factory):
    if fmt not in _CACHE:
        d = tmp_path_factory.mktemp(fmt)
        ovr, d = checkpoint(fmt, d)
        ranks = [port_load(ovr, d, r, TP) for r in range(TP)]
        _CACHE[fmt] = dict(ovr=ovr, d=d, ranks=ranks)
    return _CACHE[fmt]


FORMATS = ["awq", "gptq", "gptq_act_order", "llama_fp8", "deepseek_fp8",
           "meta_pth_mp", "glm4", "edge_awq", "edge_gptq", "edge_fp8"]


@pytest.mark.parametrize("fmt", FORMATS)
def test_rank_trees_equal_the_jax_streamed_tree(fmt, tmp_path_factory):
    c = loaded(fmt, tmp_path_factory)
    jtree, mtp = jax_tree(c["ovr"], c["d"])
    for tree, lay, _, _ in c["ranks"]:
        same(params_from_numpy(jtree, lay, mtp), tree, f"rank {lay.rank}: ")


@pytest.mark.parametrize("fmt", FORMATS + ["hf_llama_bf16", "mixtral"])
def test_rank_trees_equal_the_whole_then_cut_tree(fmt, tmp_path_factory):
    c = loaded(fmt, tmp_path_factory)
    for tree, lay, _, _ in c["ranks"]:
        same(whole_then_cut(c["ovr"], c["d"], lay), tree, f"rank {lay.rank}: ")


# ---------------------------------------------------------------------------
# What each rank read
# ---------------------------------------------------------------------------

COL, ROW = 0, 1  # the cut dim of a stored [out, in] projection


def _stored(d):
    """(file, key) -> (shape, bytes) of every tensor of a checkpoint."""
    out = {}
    for f in os.listdir(d):
        p = os.path.join(d, f)
        if f.endswith(".safetensors"):
            for k, e in read_header(p)[0].items():
                out[(f, k)] = (e.shape, e.nbytes)
        elif f.endswith(".pth"):
            for k, t in torch.load(p, mmap=True, weights_only=True).items():
                out[(f, k)] = (tuple(t.shape), t.numel() * t.element_size())
    return out


def _proj(key):
    """"col" / "row" for a projection the llama layout cuts, else None."""
    for p in ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj", "q_b_proj",
              "kv_b_proj",
              "query_key_value", "dense_h_to_4h", "wq.", "wk.", "wv.", "w1.", "w3."):
        if p in key:
            return "col"
    for p in ("o_proj", "down_proj", "self_attention.dense.", "dense_4h_to_h",
              "wo.", "w2."):
        if p in key:
            return "row"
    return None


def cut_rule(fmt, key, shape, group, experts):
    """How a rank reads a stored tensor: ("whole",), ("none",) (another
    rank's expert), ("gather",) (act-order GPTQ's rows of a row-parallel
    weight: the words from its first row's to its last's), or ("cut",
    dim, unit): its share along `dim` plus at most `unit` rows of it (a
    word, a group, a block) on its cut edge."""
    if "experts." in key and "shared" not in key:
        return ("whole",) if int(key.split("experts.")[1].split(".")[0]) in experts \
            else ("none",)
    if any(n in key for n in ("norm", "mlp.gate.", "moe.gate.", "g_idx",
                              "q_a_proj", "kv_a_proj")):
        return ("whole",)
    if any(n in key for n in ("embed", "output", "lm_head")):
        return ("cut", 0, 1)
    kind = _proj(key) or ("col" if "shared_experts" in key and "down" not in key
                          else "row" if "shared_experts" in key else None)
    if kind is None:
        raise KeyError(key)
    part = key.rsplit(".", 1)[1]
    if part in ("qweight", "qzeros", "scales"):
        awq = fmt.endswith("awq")
        if kind == "col":  # the packed or plain out dim is the last
            return ("cut", 1, 1)
        if part == "qweight" and fmt == "gptq_act_order":
            return ("gather",)
        rows = group if part == "qweight" and awq else group // 8 if part == "qweight" else 1
        return ("cut", 0, rows)
    if key.endswith("bias"):
        return ("cut", 0, 1)
    block = 1 if part == "weight_scale_inv" else 128 if "fp8" in fmt else 1
    return ("cut", COL if kind == "col" else ROW, block)


def read_bounds(fmt, d, rank):
    """Each read tensor's (file, key) -> (rule, least, most bytes) for
    rank `rank` of TP."""
    group = EDGE_G if fmt.startswith("edge_") and fmt != "edge_fp8" else tl.G
    from chitu_tpu_torch.parallel.sharding import even_range

    E = 16 if "deepseek" in fmt else 8
    experts = set(range(*even_range(E, rank, TP)))
    out = {}
    for (f, key), (shape, n) in _stored(d).items():
        rule = cut_rule(fmt, key, shape, group, experts)
        if rule[0] == "whole":
            lo = hi = n
        elif rule[0] == "none":
            lo = hi = 0
        elif rule[0] == "gather":
            lo, hi = n // TP, n
        else:
            dim, unit = rule[1], rule[2]
            row = n // shape[dim]
            lo, hi = n // TP, min(n, n // TP + row * unit)
        out[(f, key)] = (rule, lo, hi)
    return out


@pytest.mark.parametrize("fmt", [f for f in FORMATS if f != "meta_pth_mp"]
                         + ["hf_llama_bf16", "mixtral"])
def test_each_rank_reads_its_share_and_the_edges(fmt, tmp_path_factory):
    """(The Meta mp files: `test_meta_rank_reads_its_own_mp_file`.)"""
    c = loaded(fmt, tmp_path_factory)
    covered = {}
    for tree, lay, stats, reads in c["ranks"]:
        bounds = read_bounds(fmt, c["d"], lay.rank)
        got = {}
        for f, key, n in reads:
            got[(f, key)] = got.get((f, key), 0) + n
        assert sum(got.values()) == stats["total_bytes"], lay.rank
        for fk, (rule, lo, hi) in bounds.items():
            n = got.get(fk, 0)
            covered[fk] = covered.get(fk, 0) + n
            assert lo <= n <= hi, (lay.rank, fk, rule, n, lo, hi)
        assert set(got) <= set(bounds)
        # the largest copy: no whole piece of a leaf the layout cuts
        cut = [(n, fk) for fk, (rule, lo, hi) in bounds.items()
               if rule[0] == "cut" for n in [_stored(c["d"])[fk][1]]]
        assert stats["max_shard_bytes"] <= max(hi for _, _, hi in bounds.values())
        assert stats["max_shard_bytes"] < max(cut)[0], (stats, max(cut))
    for fk, (rule, lo, hi) in read_bounds(fmt, c["d"], 0).items():
        if rule[0] == "cut":  # every byte of a cut tensor read by a rank
            assert covered[fk] >= _stored(c["d"])[fk][1], fk


def test_max_shard_is_below_the_whole_piece(tmp_path_factory):
    """The one-rank load copies the largest whole piece (Llama fp8's
    embedding, bf16 [V, D], in one buffer); a tp=2 rank copies half of
    it, and reads about half the bytes."""
    c = loaded("llama_fp8", tmp_path_factory)
    _, _, one, _ = port_load(c["ovr"], c["d"])
    a, _ = tl._dims(c["ovr"])
    assert one["max_shard_bytes"] == a.vocab_size * a.dim * 2
    for _, _, stats, _ in c["ranks"]:
        assert stats["max_shard_bytes"] * TP == one["max_shard_bytes"]
        assert stats["total_bytes"] < one["total_bytes"] * 0.55


def test_meta_rank_reads_its_own_mp_file(tmp_path_factory):
    """tp == mp: rank r's column- and row-parallel leaves come from
    consolidated.0r.pth alone; the embedding (mp-split by its hidden dim,
    tp-split by the vocabulary) reads the rank's rows of both files, the
    norms file 0's. Its bytes are half the files' but for the norms."""
    c = loaded("meta_pth_mp", tmp_path_factory)
    stored = _stored(c["d"])
    norms = sum(n for (f, k), (_, n) in stored.items() if "norm" in k)
    for tree, lay, stats, reads in c["ranks"]:
        own = f"consolidated.{lay.rank:02d}.pth"
        files = {}
        for f, key, n in reads:
            files.setdefault(key, set()).add(f)
        for key, fs in files.items():
            if _proj(key) is not None or key.startswith("output"):
                assert fs == {own}, (lay.rank, key, fs)
            elif "norm" in key:
                assert fs == {"consolidated.00.pth"}, (key, fs)
            else:
                assert key.startswith("tok_embeddings") and len(fs) == 2, key
        total = sum(n for _, n in stored.values())
        assert stats["total_bytes"] == (total - norms) // TP + norms // TP


def test_preprocessed_dump_streams_per_rank(tmp_path_factory):
    """A preprocessed dump (already views until cut) at tp=2: each rank
    copies its share of the dump's bytes but the leaves it holds whole
    (the norms)."""
    from chitu_tpu_torch.loader import save_preprocessed

    d = tmp_path_factory.mktemp("pre")
    ovr, d = tl.checkpoint("hf_llama_bf16", d)
    tree, *_ = port_load(ovr, d)
    pre = os.path.join(d, "chitu_tpu_preprocessed")
    save_preprocessed({**{k: v for k, v in tree.items() if k in ("embed", "norm", "lm_head")},
                       "layers": {k: v for k, v in tree.items()
                                  if k not in ("embed", "norm", "lm_head")}}, pre)
    whole = sum(e.nbytes for e in read_header(os.path.join(pre, "model.safetensors"))[0].values())
    norms = sum(v.numel() * v.element_size() for k, v in tree.items() if "norm" in k)
    _, cfg = _cfgs(ovr + ["skip_preprocess=true"], d)
    for r in range(TP):
        model = tl.build_model(cfg.models, cfg, device="cpu")
        model.layout = layout(model, r, TP)
        reset_placement_stats()
        got = _flat(tl.load_checkpoint(model, cfg, "cpu"))
        assert placement_stats()["total_bytes"] == (whole - norms) // TP + norms
        same(whole_then_cut(ovr, d, model.layout), got)


def test_act_order_row_cut_reads_the_words_over_its_rows(tmp_path_factory):
    """Act-order GPTQ's row-parallel weights: a rank's rows are those of
    its groups, spread over the layer by the g_idx; it copies the packed
    words from its first row's to its last's (counted as read) and
    unpacks only its rows, so its largest copy is that word range, never
    the unpacked layer."""
    c = loaded("gptq_act_order", tmp_path_factory)
    stored = _stored(c["d"])
    for tree, lay, stats, reads in c["ranks"]:
        for f, key, n in reads:
            if key.endswith("down_proj.qweight"):
                assert n <= stored[(f, key)][1]
        K = tree["w_down"].data.shape[-2]
        assert K * 2 == tl._dims(c["ovr"])[0].inter_dim


@pytest.mark.parametrize("fmt", ["awq", "gptq_act_order", "edge_gptq", "llama_fp8",
                                 "deepseek_fp8", "meta_pth_mp"])
def test_chunked_reads_equal_whole_reads(fmt, tmp_path_factory, monkeypatch):
    """Transposed reads and unpacks above `CHUNK_BYTES` go to the device in
    chunks (at full width: the head, a large e4m3 projection, a packed
    layer); with chunks of 1 KiB every such read here is chunked, and the
    rank's tree is the same, bit for bit, its bytes read the same, in
    more copies, none larger."""
    import chitu_tpu_torch.loader_streaming as ls

    c = loaded(fmt, tmp_path_factory)
    copies, to_device = [], ls.to_device

    def counted(t, *a, **k):
        copies.append(t.numel() * t.element_size())
        return to_device(t, *a, **k)

    monkeypatch.setattr(ls, "to_device", counted)
    for tree, lay, stats, _ in c["ranks"]:
        port_load(c["ovr"], c["d"], lay.rank, TP)
        whole = len(copies)
        copies.clear()
        with monkeypatch.context() as m:
            m.setattr(ls, "CHUNK_BYTES", 1024)
            got, _, chunked, _ = port_load(c["ovr"], c["d"], lay.rank, TP)
        same(tree, got, f"rank {lay.rank}: ")
        assert chunked["total_bytes"] == stats["total_bytes"]
        assert chunked["max_shard_bytes"] <= stats["max_shard_bytes"]
        assert len(copies) > whole, (len(copies), whole)
        copies.clear()
