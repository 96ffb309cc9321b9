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
slices), or ("tp", units): the dim is `units` equal units (heads) and
rank r takes units [r * units / tp, (r + 1) * units / tp) when tp
divides them; when units divide tp instead, each unit is held by
tp / units consecutive ranks (KV heads fewer than ranks: rank r holds
head r * units // tp). A dim the spec cannot split replicates, with a
loud warning on large arrays (`safe_spec`).
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
    when the dim stays whole."""
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


def qtensor_aux_spec(data_ndim: int, spec: Spec, aux_ndim: int) -> Spec:
    """Spec of a QTensor's scale / zeros from its data's: blockwise and
    groupwise auxiliaries have the data's rank and dims; per-out-channel
    ones (W8A16 / W8A8 [.., out]) drop the in dim, so a row-parallel
    weight replicates its scale."""
    entries = (list(spec) + [None] * data_ndim)[:data_ndim]
    if aux_ndim >= data_ndim:
        return tuple(entries)
    dropped = entries[:-2] + [entries[-1]]
    return tuple(dropped[:aux_ndim])


def shard_tensor(t: torch.Tensor, spec: Spec, rank: int, tp: int) -> torch.Tensor:
    """Rank's slice of a dense tensor (a view)."""
    for dim, entry in enumerate(safe_spec(spec, t.shape, tp)):
        r = dim_range(t.shape[dim], entry, rank, tp)
        if r is not None:
            t = t.narrow(dim, r[0], r[1] - r[0])
    return t


def _aux_range(r, data_size: int, aux_size: int, what: str):
    """The aux dim's slice under a data dim's slice: the same one when the
    aux is per element, else whole blocks (refused when a shard boundary
    falls inside a quantization block)."""
    if r is None:
        return None
    if aux_size == data_size:
        return r
    b = -(-data_size // aux_size)
    start, stop = r
    if start % b or (stop % b and stop != data_size):
        raise NotImplementedError(
            f"{what}: a shard boundary at rows/columns {start}:{stop} falls "
            f"inside a quantization block of {b}; this tensor-parallel "
            "degree cannot split it"
        )
    return start // b, -(-stop // b)


def shard_qtensor(q: QTensor, spec: Spec, rank: int, tp: int,
                  name: str = "") -> QTensor:
    """Rank's shard of a quantized weight [(L,) in, out]: data by the spec;
    blockwise / groupwise scales and zeros with it, per-out-channel scales
    along the out dim only; packed int4 is unpacked first (the engine
    packs the shard again). `in_perm` (act-order GPTQ) stays whole: a
    row-parallel act-order weight gathers its input over the group first
    (`LlamaForCausalLM._row_linear`). The LLM.int8 outlier rows stay
    whole in count: under a column split `oc_w` loses the columns the
    rank does not hold; under a row split each rank keeps only the
    outlier channels it holds (the others' rows zeroed, their indices
    made local), so the partial outlier term is summed by the same
    all-reduce as the GEMM's."""
    q = unpack_int4(q) if q.packed else q
    nd = q.data.dim()
    spec = safe_spec(spec, q.data.shape, tp)
    ranges = [dim_range(q.data.shape[d], spec[d], rank, tp) for d in range(nd)]

    def aux(t, what):
        if t is None:
            return None
        # the data dim each aux dim follows (a per-out-channel aux has no
        # in dim)
        dims = list(range(nd)) if t.dim() == nd else (
            list(range(nd - 2)) + [nd - 1])
        for ad, entry in enumerate(qtensor_aux_spec(nd, spec, t.dim())):
            if entry is None:
                continue
            dd = dims[ad]
            r = _aux_range(ranges[dd], q.data.shape[dd], t.shape[ad],
                           f"{name} {what}")
            t = t.narrow(ad, r[0], r[1] - r[0])
        return t

    out = replace(
        q, data=shard_tensor(q.data, spec, rank, tp),
        scale=aux(q.scale, "scale"), zeros=aux(q.zeros, "zeros"),
    )
    if q.oc_idx is not None:
        idx, ocw = q.oc_idx, q.oc_w
        rin, rout = ranges[nd - 2], ranges[nd - 1]
        if rin is not None:
            held = (idx >= rin[0]) & (idx < rin[1])
            idx = torch.where(held, idx - rin[0], torch.zeros_like(idx))
            ocw = torch.where(held[..., None], ocw, torch.zeros_like(ocw))
        if rout is not None:
            ocw = ocw.narrow(-1, rout[0], rout[1] - rout[0])
        out = replace(out, oc_idx=idx, oc_w=ocw)
    return out


def narrow_out(leaf, start: int, stop: int, name: str = ""):
    """Columns [start, stop) of a [(L,) in, out] weight, dense or quantized
    (a view; packed int4 unpacked first): scales and zeros with them,
    blockwise scales only on whole blocks; `in_perm` and `oc_idx` stay
    whole, `oc_w` keeps the columns."""
    if not isinstance(leaf, QTensor):
        return leaf.narrow(-1, start, stop - start)
    q = unpack_int4(leaf) if leaf.packed else leaf
    n = q.data.shape[-1]

    def aux(t, what):
        if t is None:
            return None
        r = _aux_range((start, stop), n, t.shape[-1], f"{name} {what}")
        return t.narrow(-1, r[0], r[1] - r[0])

    return replace(
        q, data=q.data.narrow(-1, start, stop - start),
        scale=aux(q.scale, "scale"), zeros=aux(q.zeros, "zeros"),
        oc_w=None if q.oc_w is None else q.oc_w.narrow(-1, start, stop - start),
    )


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


def shard_leaf(leaf, spec: Spec, rank: int, tp: int, name: str = ""):
    """Rank's shard of one leaf, dense or quantized, made contiguous (it
    owns its storage: the full leaf can go)."""
    if isinstance(leaf, QTensor):
        return shard_qtensor(leaf, spec, rank, tp, name).contiguous()
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
            per, extra = divmod(n, pp)
            start = stage * per + min(stage, extra)
            ranges[name] = (start, start + per + (stage < extra))
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
