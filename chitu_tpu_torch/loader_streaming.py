"""Streamed shard loads: each rank reads from a checkpoint only the bytes of
its own slice of every leaf.

Counterpart of `chitu_tpu/loader_streaming.py`, and of the placement
statistics of `chitu_tpu/parallel/sharding.py:99-112`. A reader stands for
one checkpoint tensor as the parameter tree lays it out ([in, out] for a
projection stored [out, in]) without reading it. It has a `shape`, and it
narrows like a tensor (`narrow(dim, start, length)`), so the sharding
rules that cut a loaded leaf (`sharding.shard_tensor`, and `narrow_rows`
/ `narrow_cols` on a `QTensor` whose fields are readers: whole
quantization blocks over a cut) cut a reader the same way, before
anything is read. `read` then copies the slice's host buffer (a view of
the mapped file where the format allows) through `to_device`, the
loaders' one host-to-device copy, and finishes it on the device
(transpose, cast, unpack). So a rank copies its own slice, and neither its
device nor its host ever holds a whole piece of a leaf that the layout
cuts; `placement_stats` counts what it copied.

The JAX readers and their counterparts here:
- `LazySlice`: a mapped view (`utils.safetensors.Reader.get_tensor`, or a
  tensor of a Meta `.pth` file under `torch.load(mmap=True)`).
- `LazyWindow`: a reader's window along one dim; `narrow` makes one.
- `LazyConcat`: the mp parts of a Meta `.pth` tensor along its family's
  parallel dim; a slice reads only the parts it overlaps.
- `LazyUnpack4`: AWQ / GPTQ int32 words. A slice copies the whole words
  over it (packed bytes) and unpacks them on the device at a nibble
  offset (`quantize.packed.unpack_nibbles`). `LazyGather` adds
  act-order GPTQ's row order, which the JAX streaming loader does not
  stream (it falls back to its eager loader).
- `LazyStack`: none. The loaders fill each stacked leaf layer by layer
  (`loader.fill_stacked`), each layer from its own reader.
- `lazy_rank_major`: none. The port cuts each part of a merged leaf and
  merges the rank's parts after the copy (`TPLayout.assemble`).
- `reader_index`: `utils.safetensors.read_index(path, files=...)`.
- `HostArray`, `np_view_dtype`, `_raw_view`: none. They exist because
  numpy holds no bf16 or e4m3; torch holds both.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from chitu_tpu_torch.ops.qtensor import QTensor, QuantKind
from chitu_tpu_torch.quantize.packed import AWQ_ORDER, act_order_perm, unpack_nibbles

Box = Tuple[Tuple[int, int], ...]  # (start, stop) of every dim
# a transposed read larger than this goes to the device in row chunks of
# about this many bytes, each transposed into its place in the leaf, and
# an unpack runs on chunks of words whose int32 nibbles take about this
# many bytes: the device holds one chunk beside the leaf, not a second
# copy of the rank's piece
CHUNK_BYTES = 64 << 20

_STATS = {"max_shard_bytes": 0, "total_bytes": 0}


def reset_placement_stats():
    """Zero this process's counters of the loaders' copies."""
    for k in _STATS:
        _STATS[k] = 0


def placement_stats() -> dict:
    """Since the last reset, in this process (one rank):
    `max_shard_bytes`, the largest single host buffer the loaders copied
    to the device, and `total_bytes`, the bytes they read from
    checkpoints (every copied buffer, and what was read on the host
    alone: a GPTQ g_idx)."""
    return dict(_STATS)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def note_read(t: torch.Tensor) -> torch.Tensor:
    """Count a host buffer read from a checkpoint but not copied."""
    _STATS["total_bytes"] += _nbytes(t)
    return t


def to_device(t: torch.Tensor, device, dtype: Optional[torch.dtype] = None,
              transpose: bool = False, read: bool = True) -> torch.Tensor:
    """The loaders' one host-to-device copy: a stored tensor onto the
    device as it is stored, then transposed (2-D only) and cast there;
    fp8 moves and transposes as its bytes. Counted in `placement_stats`
    (`read`: the buffer came from a checkpoint, not made on the host)."""
    n = _nbytes(t)
    _STATS["max_shard_bytes"] = max(_STATS["max_shard_bytes"], n)
    if read:
        _STATS["total_bytes"] += n
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


def _full(shape) -> Box:
    return tuple((0, s) for s in shape)


class Lazy:
    """A checkpoint tensor as the tree lays it out, not yet read: `shape`,
    `dtype` (of the leaf on the device), `narrow`, and `read(box,
    device)`, the box's slice on the device."""

    shape: Tuple[int, ...] = ()
    dtype: torch.dtype = torch.bfloat16

    def dim(self) -> int:
        return len(self.shape)

    def narrow(self, dim: int, start: int, length: int) -> "LazyWindow":
        return LazyWindow(self, dim, start, start + length)

    def read(self, box: Box, device) -> torch.Tensor:
        raise NotImplementedError

    def load(self, device) -> torch.Tensor:
        return self.read(_full(self.shape), device)


class LazySlice(Lazy):
    """A mapped view of a stored tensor, presented transposed (2-D only:
    stored [out, in], presented [in, out]) and in `dtype` (floats are cast
    on the device, after the copy; e4m3 stored as uint8 lanes is viewed).
    `source` and `key` name the file it maps and the tensor there."""

    def __init__(self, view: torch.Tensor, transpose: bool = False,
                 dtype: Optional[torch.dtype] = None, source: str = "",
                 key: str = ""):
        self.view = view
        self.transpose = transpose and view.dim() == 2
        shape = tuple(view.shape)
        self.shape = shape[::-1] if self.transpose else shape
        self.dtype = view.dtype if dtype is None else dtype
        self.source, self.key = source, key

    def host(self, box: Optional[Box] = None) -> torch.Tensor:
        """The box's slice as stored: a view of the mapped pages."""
        v = self.view
        box = _full(self.shape) if box is None else box
        for d, (s, e) in enumerate(box[::-1] if self.transpose else box):
            if (s, e) != (0, v.shape[d]):
                v = v.narrow(d, s, e - s)
        return as_e4m3(v) if self.dtype == torch.float8_e4m3fn else v

    def read(self, box: Box, device) -> torch.Tensor:
        v = self.host(box)
        cast = self.dtype if self.dtype.is_floating_point else None
        if not self.transpose or _nbytes(v) <= CHUNK_BYTES:
            return to_device(v, device, cast, self.transpose)
        fp8 = v.dtype == torch.float8_e4m3fn
        out = torch.empty((v.shape[1], v.shape[0]), device=device,
                          dtype=torch.uint8 if fp8 else cast or v.dtype)
        step = max(1, CHUNK_BYTES // (v.shape[1] * v.element_size()))
        for a in range(0, v.shape[0], step):
            t = to_device(v[a:a + step], device)
            out[:, a:a + t.shape[0]].copy_((t.view(torch.uint8) if fp8 else t).T)
            del t
        return out.view(torch.float8_e4m3fn) if fp8 else out


class LazyWindow(Lazy):
    """Rows [start, stop) along `axis` of a reader: nothing is read."""

    def __init__(self, base: Lazy, axis: int, start: int, stop: int):
        axis %= len(base.shape)
        if not 0 <= start <= stop <= base.shape[axis]:
            raise ValueError(f"window [{start}, {stop}) of dim {axis} of "
                             f"{tuple(base.shape)}")
        if isinstance(base, LazyWindow):
            box, base = list(base.box), base.base
        else:
            box = list(_full(base.shape))
        at = box[axis][0]
        box[axis] = (at + start, at + stop)
        self.base, self.box = base, tuple(box)
        self.shape = tuple(e - s for s, e in self.box)
        self.dtype = base.dtype

    def _abs(self, box: Box) -> Box:
        return tuple((a + s, a + e) for (a, _), (s, e) in zip(self.box, box))

    def host(self, box: Optional[Box] = None) -> torch.Tensor:
        return self.base.host(self._abs(_full(self.shape) if box is None else box))

    def read(self, box: Box, device) -> torch.Tensor:
        return self.base.read(self._abs(box), device)


class LazyConcat(Lazy):
    """Readers side by side along `axis` (the mp parts of a Meta `.pth`
    tensor). A slice reads the parts it overlaps, each its own part of
    the slice, into one buffer on the device."""

    def __init__(self, parts: Sequence[Lazy], axis: int):
        self.parts = list(parts)
        self.axis = axis % len(parts[0].shape)
        self.offsets = [0]
        for p in self.parts:
            self.offsets.append(self.offsets[-1] + p.shape[self.axis])
        shape = list(parts[0].shape)
        shape[self.axis] = self.offsets[-1]
        self.shape, self.dtype = tuple(shape), parts[0].dtype

    def read(self, box: Box, device) -> torch.Tensor:
        ax = self.axis
        s, e = box[ax]
        pieces = []
        for p, lo, hi in zip(self.parts, self.offsets, self.offsets[1:]):
            a, z = max(s, lo), min(e, hi)
            if a < z:
                sub = list(box)
                sub[ax] = (a - lo, z - lo)
                pieces.append((p, tuple(sub), a - s))
        if len(pieces) == 1:
            return pieces[0][0].read(pieces[0][1], device)
        out = None
        for p, sub, at in pieces:
            t = p.read(sub, device)
            if out is None:
                shape = list(t.shape)
                shape[ax] = e - s
                out = torch.empty(shape, dtype=t.dtype, device=t.device)
            out.narrow(ax, at, t.shape[ax]).copy_(t)
            del t
        return out


class LazyUnpack4(Lazy):
    """int32 words packing 8 nibbles along `axis` (AWQ qweight / qzeros:
    the last dim; GPTQ qweight: the first) -> the nibble values, `order`
    each nibble's place in its word, in `dtype` plus `bias` (GPTQ's zero
    points are stored as zero - 1). A slice copies the whole words over
    it and unpacks them on the device: a cut inside a word reads that
    word."""

    def __init__(self, words: Lazy, axis: int, order, dtype=torch.int8,
                 bias: float = 0.0):
        self.words, self.axis = words, axis % len(words.shape)
        self.order = tuple(order)
        shape = list(words.shape)
        shape[self.axis] *= 8
        self.shape, self.dtype, self.bias = tuple(shape), dtype, bias

    def read(self, box: Box, device) -> torch.Tensor:
        s, e = box[self.axis]
        w0 = s // 8
        wbox = list(box)
        wbox[self.axis] = (w0, -(-e // 8))
        words = self.words.read(tuple(wbox), device)
        shape = list(words.shape)
        shape[self.axis] = e - s
        out = torch.empty(shape, dtype=self.dtype, device=words.device)
        c = 1 if self.axis == 0 else 0  # chunks along a dim the packing leaves
        step = max(1, CHUNK_BYTES // (32 * words.numel() // words.shape[c]))
        for a in range(0, words.shape[c], step):
            part = words.narrow(c, a, min(step, words.shape[c] - a))
            out.narrow(c, a, part.shape[c]).copy_(unpack_nibbles(
                part, self.order, self.axis, s - 8 * w0, e - s))
        del words
        return out + self.bias if self.bias else out


class LazyGather(Lazy):
    """The rows of a `LazyUnpack4` packed along its rows (GPTQ qweight) in
    another order: row i is stored row `rows[i]` (act-order GPTQ, rows
    sorted by group). A slice copies the words from its first stored
    row's to its last's and picks its rows' nibbles on the device. Under
    a shuffled g_idx a row-parallel slice's rows lie all over the layer,
    so those words are most of the layer's (ROADMAP C, streamed loads)."""

    def __init__(self, base: LazyUnpack4, rows: torch.Tensor):
        if base.axis != 0:
            raise ValueError("LazyGather reorders the rows a reader packs")
        self.base, self.rows = base, rows.to(torch.int64)
        self.shape, self.dtype = (int(rows.shape[0]), *base.shape[1:]), base.dtype

    def read(self, box: Box, device) -> torch.Tensor:
        (s, e), rest = box[0], box[1:]
        rows = self.rows[s:e]
        w0, w1 = int(rows.min()) // 8, int(rows.max()) // 8 + 1
        words = self.base.words.read(((w0, w1), *rest), device)
        at = to_device(rows - 8 * w0, words.device, read=False)
        out = torch.empty((e - s, *words.shape[1:]), dtype=torch.int8,
                          device=words.device)
        for j, o in enumerate(self.base.order):
            sel = at % 8 == j
            out[sel] = ((words[at[sel] // 8] >> (4 * o)) & 0xF).to(torch.int8)
        del words
        out = out.to(self.dtype)
        return out + self.base.bias if self.base.bias else out


def w4a16(qweight: LazySlice, qzeros: LazySlice, scales: Lazy,
          g_idx: Optional[LazySlice] = None) -> QTensor:
    """An AWQ or GPTQ projection's stored tensors -> a W4A16 QTensor of
    readers in the layout of `quantize.packed` (data [in, out] nibbles,
    scale and zeros [in/G, out] f32; `scales` read in f32; GPTQ's zero
    points stored as zero - 1). AWQ packs the out dim ([in, out/8]), GPTQ the in dim
    ([in/8, out]). An act-order g_idx is read whole on the host: its sort
    is the rows' order and the leaf's `in_perm`, whole on every rank."""
    if qweight.shape[1] * 8 == scales.shape[1]:
        return QTensor(
            data=LazyUnpack4(qweight, -1, AWQ_ORDER),
            scale=scales,
            zeros=LazyUnpack4(qzeros, -1, AWQ_ORDER, torch.float32),
            kind=QuantKind.W4A16,
            block=qweight.shape[0] // scales.shape[0],
        )
    group = qweight.shape[0] * 8 // scales.shape[0]
    data = LazyUnpack4(qweight, 0, range(8))
    perm = None
    if g_idx is not None:
        perm = act_order_perm(note_read(g_idx.host()), group, scales.shape[0])
    return QTensor(
        data=data if perm is None else LazyGather(data, perm),
        scale=scales,
        zeros=LazyUnpack4(qzeros, -1, range(8), torch.float32, bias=1.0),
        kind=QuantKind.W4A16,
        block=group,
        in_perm=None if perm is None else perm.to(torch.int32),
    )


def load(piece, device):
    """A reader, or a QTensor of readers (cut or whole) -> its tensors on
    the device. A plain tensor in a QTensor (act-order GPTQ's `in_perm`,
    made on the host) is copied as made, not counted as read."""
    if isinstance(piece, QTensor):
        return piece._map(lambda t: load(t, device))
    if isinstance(piece, Lazy):
        return piece.load(device)
    return to_device(piece, device, read=False)
