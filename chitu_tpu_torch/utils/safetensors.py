"""The safetensors file format, read and written with PyTorch alone.

The port's loader (`chitu_tpu_torch/loader.py`) reads checkpoints and
writes preprocessed dumps through this module, so it needs neither the
`safetensors` package nor `ml_dtypes`. The format:

- 8 bytes: the header's length N, a little-endian u64;
- N bytes: a JSON object mapping each tensor's name to its `dtype`,
  `shape` and `data_offsets` ([begin, end) in the byte buffer), plus an
  optional `"__metadata__"` object of strings;
- the byte buffer: each tensor's bytes, row-major, little-endian.

A reader maps each tensor's pages on demand (`mmap`, copy-on-write, so
the buffer is writable and no page is ever written back) and hands out
a view of them: nothing is read until a tensor's bytes are used, and the
pages go with the last view. The writer streams one tensor at a time, so
a tensor on the GPU crosses to the host on its own.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import torch

DTYPES: Dict[str, torch.dtype] = {
    "BOOL": torch.bool,
    "U8": torch.uint8,
    "I8": torch.int8,
    "I16": torch.int16,
    "U16": torch.uint16,
    "I32": torch.int32,
    "U32": torch.uint32,
    "I64": torch.int64,
    "U64": torch.uint64,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "F32": torch.float32,
    "F64": torch.float64,
    "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
}
NAMES: Dict[torch.dtype, str] = {v: k for k, v in DTYPES.items()}
_MAX_HEADER = 100 * 1024 * 1024  # the reference implementation's limit


class TensorInfo:
    """One header entry: dtype, shape and byte range in the buffer."""

    __slots__ = ("dtype", "shape", "begin", "end")

    def __init__(self, dtype: torch.dtype, shape: Tuple[int, ...],
                 begin: int, end: int):
        self.dtype, self.shape, self.begin, self.end = dtype, shape, begin, end

    @property
    def nbytes(self) -> int:
        return self.end - self.begin


def read_header(path: str) -> Tuple[Dict[str, TensorInfo], Dict[str, str], int]:
    """-> (tensor entries by name, metadata, offset of the byte buffer)."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file (short header)")
        (n,) = struct.unpack("<Q", head)
        if n > _MAX_HEADER:
            raise ValueError(f"{path}: header of {n} bytes is too large")
        raw = f.read(n)
    if len(raw) != n:
        raise ValueError(f"{path}: truncated header")
    header = json.loads(raw)
    meta = header.pop("__metadata__", None) or {}
    size = os.path.getsize(path) - 8 - n
    entries = {}
    for name, e in header.items():
        if e["dtype"] not in DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {e['dtype']}")
        dtype = DTYPES[e["dtype"]]
        shape = tuple(int(s) for s in e["shape"])
        begin, end = (int(o) for o in e["data_offsets"])
        numel = 1
        for s in shape:
            numel *= s
        if end - begin != numel * dtype.itemsize or not 0 <= begin <= end <= size:
            raise ValueError(
                f"{path}: tensor {name!r} {e['dtype']}{list(shape)} has a "
                f"byte range [{begin}, {end}) that does not fit its shape "
                f"or the file"
            )
        entries[name] = TensorInfo(dtype, shape, begin, end)
    return entries, meta, 8 + n


class SafetensorsFile:
    """One file: `get_tensor` maps the pages of one tensor and returns a
    view of them; the map goes when the last view of it does, so a loader
    that keeps no view holds no page of the file."""

    def __init__(self, path: str):
        self.path = path
        self.entries, self.metadata, self._base = read_header(path)

    def get_tensor(self, name: str) -> torch.Tensor:
        e = self.entries[name]
        numel = e.nbytes // e.dtype.itemsize
        if numel == 0:
            return torch.empty(e.shape, dtype=e.dtype)
        start = self._base + e.begin
        lo = start // mmap.ALLOCATIONGRANULARITY * mmap.ALLOCATIONGRANULARITY
        with open(self.path, "rb") as f:
            # ACCESS_COPY: a writable private map, which torch.frombuffer
            # takes without a warning; nothing is written back to the file
            mm = mmap.mmap(f.fileno(), start + e.nbytes - lo,
                           access=mmap.ACCESS_COPY, offset=lo)
        flat = torch.frombuffer(mm, dtype=e.dtype, count=numel, offset=start - lo)
        return flat.view(e.shape)


def read_index(path: str, files: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Tensor name -> file, for one file or for a directory: the `files`
    given (names relative to it), else every `*.safetensors`, files in
    sorted order and names sorted within a file (the order of the
    `safetensors` package's `safe_open(...).keys()`). A name found in two
    files raises."""
    if os.path.isfile(path):
        paths = [path]
    else:
        names = sorted(
            files if files is not None
            else (f for f in os.listdir(path) if f.endswith(".safetensors"))
        )
        if not names:
            raise FileNotFoundError(f"no .safetensors under {path}")
        paths = [os.path.join(path, f) for f in names]
    index: Dict[str, str] = {}
    for p in paths:
        for name in sorted(read_header(p)[0]):
            if name in index:
                raise ValueError(f"tensor {name!r} is in {index[name]} and {p}")
            index[name] = p
    return index


class Reader:
    """Every tensor of a file or directory by name, over mapped files."""

    def __init__(self, path: str, files: Optional[Iterable[str]] = None):
        self.index = read_index(path, files)
        self._files: Dict[str, SafetensorsFile] = {}

    def _file(self, name: str) -> SafetensorsFile:
        p = self.index[name]
        if p not in self._files:
            self._files[p] = SafetensorsFile(p)
        return self._files[p]

    def keys(self) -> List[str]:
        return list(self.index)

    def __contains__(self, name: str) -> bool:
        return name in self.index

    def info(self, name: str) -> TensorInfo:
        return self._file(name).entries[name]

    def get_tensor(self, name: str) -> torch.Tensor:
        return self._file(name).get_tensor(name)

    def metadata(self) -> Dict[str, str]:
        out: Dict[str, str] = {}
        for p in dict.fromkeys(self.index.values()):
            out.update(SafetensorsFile(p).metadata)
        return out


def get_tensor(path: str, name: str) -> torch.Tensor:
    """One tensor of one file, as a view of the mapped file."""
    return SafetensorsFile(path).get_tensor(name)


def save_file(
    tensors: Mapping[str, torch.Tensor],
    path: str,
    metadata: Optional[Mapping[str, str]] = None,
):
    """Write `tensors` (on any device) to `path`, one at a time: a tensor
    crosses to the host, is written and is dropped before the next. The
    buffer holds the tensors by decreasing element size, then by name, so
    every tensor starts on a multiple of its element size."""
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    off = 0
    for name in order:
        t = tensors[name]
        if t.dtype not in NAMES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} has no safetensors name")
        n = t.numel() * t.element_size()
        header[name] = {
            "dtype": NAMES[t.dtype],
            "shape": list(t.shape),
            "data_offsets": [off, off + n],
        }
        off += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)  # the buffer starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in order:
            t = tensors[name].detach()
            if t.numel():
                b = t.reshape(-1).contiguous().view(torch.uint8).cpu()
                f.write(memoryview(b.numpy()))
