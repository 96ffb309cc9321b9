"""Sharding rules: a full parameter leaf -> one rank's shard.

Pipeline stages first (`StageSlice`, the `'pp'` entry on the layer dim of
every stacked leaf in the JAX package's `param_partition_specs`): stage
p of pp holds a contiguous range of L // pp layers of every stack (the
first L % pp stages one more; a stage may hold none), its QTensor
scales, zeros, permutations and outlier rows cut along the same layer
dim; stage 0 holds the embedding, the last stage the final norm and
the head (and the embedding again when the head is tied to it). Then the
tensor-parallel cut of each leaf:

Counterpart of `chitu_tpu/parallel/sharding.py` (reference:
chitu/tensor_parallel.py:20-208): ColumnParallelLinear shards the out
dim, RowParallelLinear the in dim (the model sums the partial products),
VocabParallelEmbedding the vocab dim. There a PartitionSpec places a
global array over a mesh; here the same spec cuts rank r's slice out of
a full tensor, and the rank holds nothing else.

A spec is a tuple with one entry a dim: None (whole), "tp" (tp equal
slices), "ep" (contiguous ranges of an expert dim that tp need not
divide: the first E % tp ranks hold one expert more), or ("tp", units):
the dim is `units` equal units (heads) and rank r takes units
[r * units / tp, (r + 1) * units / tp) when tp divides them; when units
divide tp instead, each unit is held by tp / units consecutive ranks (KV
heads fewer than ranks: rank r holds head r * units // tp). A dim the
spec cannot split replicates, with a loud warning on large arrays
(`safe_spec`).

A quantized weight whose cut falls inside a quantization block (Qwen2-72B's
`w_down` at tp2: 14,784 rows a rank, 115.5 blocks of 128) keeps the
whole blocks over its slice and a view of its own rows or columns
(`QTensor.rows` / `cols`, read by `ops.linear`); the JAX package keeps
the data sharded and replicates the scale there instead.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from chitu_tpu_torch.ops.qtensor import TENSOR_FIELDS, QTensor, unpack_int4
from chitu_tpu_torch.utils import get_logger

Spec = Tuple[Any, ...]

# arrays at or above this element count get a loud warning when a spec
# axis is dropped: silently replicating a large weight wastes per-device
# memory exactly where sharding matters
_REPLICATE_WARN_ELEMS = 1 << 22


def even_range(n: int, index: int, parts: int) -> Tuple[int, int]:
    """Part `index` of n items cut into `parts` contiguous ranges, the
    first n % parts of them one longer (8 over 3: 3, 3, 2)."""
    per, extra = divmod(n, parts)
    start = index * per + min(index, extra)
    return start, start + per + (index < extra)


def _units(entry, size: int) -> Optional[int]:
    if entry is None:
        return None
    if entry == "tp":
        return size
    axis, units = entry
    assert axis == "tp", entry
    return units


def dim_range(size: int, entry, rank: int, tp: int):
    """(start, stop) of rank's slice of a dim under one spec entry, or None
    when the dim stays whole. "ep" (the experts of an expert stack): a
    contiguous range of size // tp, the first size % tp ranks one more
    (`even_range`)."""
    if entry == "ep":
        return even_range(size, rank, tp) if tp > 1 else None
    units = _units(entry, size)
    if units is None or tp <= 1 or size % units:
        return None
    per = size // units
    if units % tp == 0:
        n = units // tp
        return rank * n * per, (rank + 1) * n * per
    if tp % units == 0:
        u = rank * units // tp
        return u * per, (u + 1) * per
    return None


def safe_spec(spec: Spec, shape: Sequence[int], tp: int) -> Spec:
    """The spec with the entries dropped whose dim cannot be split over tp
    (the JAX package's `safe_named_sharding`): a model whose head count
    does not divide tp replicates those dims, and a large array that
    replicates is named in a warning."""
    fixed = []
    for i, size in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        if entry is not None and dim_range(size, entry, 0, tp) is None:
            if tp > 1 and math.prod(shape) >= _REPLICATE_WARN_ELEMS:
                get_logger().warning(
                    "sharding: dropping axis %r on dim %d of shape %s (not "
                    "divisible by %d ranks): the array REPLICATES",
                    entry, i, tuple(shape), tp,
                )
            entry = None
        fixed.append(entry)
    return tuple(fixed)


def shard_tensor(t: torch.Tensor, spec: Spec, rank: int, tp: int) -> torch.Tensor:
    """Rank's slice of a dense tensor (a view)."""
    for dim, entry in enumerate(safe_spec(spec, t.shape, tp)):
        r = dim_range(t.shape[dim], entry, rank, tp)
        if r is not None:
            t = t.narrow(dim, r[0], r[1] - r[0])
    return t


def _block(q: QTensor, t, dim: int) -> int:
    """The quantization block of the aux `t` (scale or zeros) along the
    data's dim `dim` (-2 rows, -1 columns): 1 when the aux is per element
    there, 0 when it has no such dim (a per-out-channel scale's rows)."""
    if t is None:
        return 1
    if t.dim() < q.data.dim():
        return 0 if dim == -2 else 1
    return 1 if t.shape[dim] == q.data.shape[dim] else q.block


def _cover(q: QTensor, dim: int, start: int, stop: int):
    """Stored rows / columns [start, stop) -> the whole blocks over them:
    (a, z), the data range, and the aux's range of each field."""
    n = q.data.shape[dim]
    b = max(_block(q, q.scale, dim), _block(q, q.zeros, dim), 1)
    a, z = start // b * b, min(-(-stop // b) * b, n)
    aux = {}
    for f in ("scale", "zeros"):
        t = getattr(q, f)
        if t is None or _block(q, t, dim) == 0:
            continue
        bt = _block(q, t, dim)
        aux[f] = (a // bt, -(-z // bt))
    return a, z, aux


def _narrowed(q: QTensor, dim: int, a: int, z: int, aux) -> dict:
    out = dict(data=q.data.narrow(dim, a, z - a))
    for f, (s, e) in aux.items():
        out[f] = getattr(q, f).narrow(dim, s, e - s)
    return out


def narrow_rows(q: QTensor, start: int, stop: int) -> QTensor:
    """Logical rows [start, stop) of a [(L,) in, out] quantized weight:
    the whole blocks over them, viewed (`QTensor.rows`) when the cut falls
    inside a block. The LLM.int8 outlier rows stay whole in count: the
    channels outside the cut have their rows zeroed and their indices
    made local, so the partial outlier term is summed by the same
    all-reduce as the GEMM's."""
    r0 = q.rows[0] if q.rows is not None else 0
    ps, pe = r0 + start, r0 + stop
    a, z, aux = _cover(q, -2, ps, pe)
    view = (ps - a, pe - a)
    out = replace(q, **_narrowed(q, -2, a, z, aux),
                  rows=None if view == (0, z - a) else view)
    if q.oc_idx is not None:
        idx, ocw = q.oc_idx, q.oc_w
        held = (idx >= a) & (idx < z)
        idx = torch.where(held, idx - a, torch.zeros_like(idx))
        ocw = torch.where(held[..., None], ocw, torch.zeros_like(ocw))
        out = replace(out, oc_idx=idx, oc_w=ocw)
    return out


def narrow_cols(q: QTensor, start: int, stop: int) -> QTensor:
    """Logical columns [start, stop) of a [(L,) in, out] quantized weight:
    the whole blocks over them, viewed (`QTensor.cols`) when a cut falls
    inside a block (or the weight is a concatenation of such views);
    `oc_w` keeps the stored columns."""
    segs = q.cols or ((0, q.data.shape[-1]),)
    keep, at = [], 0
    for u, v in segs:
        lo, hi = max(start, at), min(stop, at + v - u)
        if lo < hi:
            keep.append((u + lo - at, u + hi - at))
        at += v - u
    a, z, aux = _cover(q, -1, keep[0][0], max(e for _, e in keep))
    keep = tuple((u - a, v - a) for u, v in keep)
    kw = _narrowed(q, -1, a, z, aux)
    if q.oc_w is not None:
        kw["oc_w"] = q.oc_w.narrow(-1, a, z - a)
    return replace(q, **kw, cols=None if keep == ((0, z - a),) else keep)


def shard_qtensor(q: QTensor, spec: Spec, rank: int, tp: int) -> QTensor:
    """Rank's shard of a quantized weight [(L,) in, out]: its leading dims
    (layers, experts) cut exactly; its rows and columns through
    `narrow_rows` / `narrow_cols` (whole quantization blocks over the
    rank's slice: a cut inside a block costs at most a block on each cut
    edge, and the rank's product is exactly its slice's); blockwise and
    groupwise scales and zeros with the blocks, per-out-channel scales
    along the out dim only; packed int4 is unpacked first (the engine
    packs the shard again). `in_perm` (act-order GPTQ) stays whole: a
    row-parallel act-order weight gathers its input over the group first
    (`LlamaForCausalLM._row_linear`)."""
    q = unpack_int4(q) if q.packed else q
    nd = q.data.dim()
    shape = q.shape
    spec = safe_spec(spec, shape, tp)
    for d in range(nd - 2):
        r = dim_range(shape[d], spec[d], rank, tp)
        if r is None:
            continue
        kw = dict(data=q.data.narrow(d, r[0], r[1] - r[0]))
        for f in ("scale", "zeros"):
            t = getattr(q, f)
            if t is not None:
                kw[f] = t.narrow(d, r[0], r[1] - r[0])
        q = replace(q, **kw)
    r = dim_range(shape[-2], spec[-2], rank, tp)
    if r is not None:
        q = narrow_rows(q, *r)
    r = dim_range(shape[-1], spec[-1], rank, tp)
    if r is not None:
        q = narrow_cols(q, *r)
    return q


def narrow_out(leaf, start: int, stop: int):
    """Columns [start, stop) of a [(L,) in, out] weight, dense or quantized
    (`narrow_cols`: views; packed int4 unpacked first); `in_perm` and
    `oc_idx` stay whole, `oc_w` keeps the columns."""
    if not isinstance(leaf, QTensor):
        return leaf.narrow(-1, start, stop - start)
    return narrow_cols(unpack_int4(leaf) if leaf.packed else leaf, start, stop)


def _tensors(t):
    if isinstance(t, QTensor):
        return [x for x in (getattr(t, n) for n in TENSOR_FIELDS) if x is not None]
    return [t]


def owned(part, whole):
    """`part`, each tensor of it copied that is a view into `whole`'s
    memory (a stage's layers, a rank's slice): the caller keeps it and
    lets the whole leaf go. A tensor of `whole` itself is kept as it is."""
    mine = {id(x) for x in _tensors(whole)}
    held = {x.untyped_storage().data_ptr() for x in _tensors(whole)}

    def keep(t):
        if id(t) in mine or t.untyped_storage().data_ptr() not in held:
            return t
        return t.clone()

    return part._map(keep) if isinstance(part, QTensor) else keep(part)


def shard_leaf(leaf, spec: Spec, rank: int, tp: int):
    """Rank's shard of one leaf, dense or quantized, made contiguous (it
    owns its storage: the full leaf can go)."""
    if isinstance(leaf, QTensor):
        return shard_qtensor(leaf, spec, rank, tp).contiguous()
    return shard_tensor(leaf, spec, rank, tp).contiguous()


@dataclass(frozen=True)
class StageSlice:
    """What one pipeline stage holds: a layer range (start, stop) of each
    stack ("layers"; DeepSeek's "dense_layers" and "moe_layers"; a stack
    absent from `ranges` is held whole), and which of the embedding
    (`embed`) and the final norm and head (`head`) it holds. The default
    holds everything: one stage."""

    stage: int = 0
    pp: int = 1
    ranges: Dict[str, Tuple[int, int]] = field(default_factory=dict)
    embed: bool = True
    head: bool = True

    @classmethod
    def of(cls, stage: int, pp: int, stacks: Dict[str, int],
           tied: bool = False, first_only: Sequence[str] = ()):
        """Stage `stage` of `pp` over `stacks` ({name: layers}): each stack
        cut into pp contiguous ranges, the first n % pp of them one layer
        longer (8 layers over 3 stages: 3, 3, 2; 1 over 2: 1, 0), but
        those in `first_only`, held whole on stage 0 and not at all
        elsewhere. A stage may hold no layer of a stack: it relays the
        hidden state as it came (the JAX package replicates such a stack
        and runs it in sequence, chitu_tpu/parallel/pipeline.py:195-221)."""
        ranges = {}
        for name, n in stacks.items():
            if name in first_only:
                ranges[name] = (0, n) if stage == 0 else (0, 0)
                continue
            ranges[name] = even_range(n, stage, pp)
        last = stage == pp - 1
        return cls(stage, pp, ranges, embed=stage == 0 or (tied and last),
                   head=last)

    def count(self, stack: str, n: int) -> int:
        """Layers of `stack` (n in all) this stage holds."""
        r = self.ranges.get(stack)
        return n if r is None else r[1] - r[0]

    def holds(self, name: str) -> bool:
        """Does this stage hold the top-level leaf or the stack `name` (any
        of its layers)?"""
        if name in self.ranges:
            start, stop = self.ranges[name]
            return stop > start
        if name == "embed":
            return self.embed
        if name in ("norm", "lm_head"):
            return self.head
        return True

    def cut(self, stack: str, leaf):
        """The stage's layers of one stacked leaf (a QTensor's every field
        along its leading layer dim): a view, which the caller copies its
        slice of (`owned`) so that the whole leaf can go."""
        r = self.ranges.get(stack)
        if r is None or r == (0, leaf.shape[0]):
            return leaf
        return leaf[r[0]:r[1]]
