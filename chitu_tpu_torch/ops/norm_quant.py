"""Per-token int8 activation quantization, alone and fused with RMSNorm:
the two CUDA kernels of `csrc/norm_quant.cu`, their wrappers and their
plain PyTorch versions.

Counterpart of `chitu_tpu/ops/pallas_norm_quant.py`:

- `rms_norm_quant` (B11): `y = x * rsqrt(mean(x^2) + eps) * w`, then
  per-token symmetric int8 of y. The W8A8 path normalizes and quantizes in
  one pass, and the int8 GEMM takes (values, scales) directly.
- `quant_acts` (B12): per-token symmetric int8 of x as it is (mid-FFN
  activations, and the attention output in front of a W8A8 `wo`).
- `acts_absmax` + `quant_acts_given` (B12 on a row-parallel input under
  tensor parallelism): each rank holds a slice of every row, so the
  per-token scale must come from the whole row. The first gives each
  row's absmax of the slice, the caller takes the max over the group,
  and the second quantizes the slice under that absmax: bit for bit the
  whole row's B12, cut to the slice (a max does not round).

Both in f32: `amax = max(|y|)` floored at 1e-8, `s = amax / 127`,
`q = clip(rint(y / s), -127, 127)` with round-half-to-even and a true
division of y by s. (On the card `amax / 127.0` is amax times the f32
reciprocal of 127, in the kernel as in PyTorch's CUDA division by a
scalar and in XLA's compiled TPU kernel; on the CPU PyTorch divides.) A wrapper runs its plain version only for tensors on the CPU;
for CUDA tensors it launches its kernel or raises. Every wrapper launches
one kernel, `norm_quant_kernel` (the row-parallel ones in its PARTIAL and
GIVEN modes), planned from shapes by `acts_plan`.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from chitu_tpu_torch.ops import cuda_build
from chitu_tpu_torch.ops.cuda_build import LAUNCHES
from chitu_tpu_torch.ops.gemm_plan import sm_count

for _name in ("rms_norm_quant", "quant_acts", "acts_absmax",
              "quant_acts_given"):
    LAUNCHES.setdefault(_name, 0)


@dataclass
class QuantizedActs:
    """Per-token symmetric int8 activations: values + scales."""

    data: torch.Tensor  # [T, D] int8
    scale: torch.Tensor  # [T] f32

    @property
    def shape(self):
        return self.data.shape

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        return (self.data.float() * self.scale[:, None]).to(dtype)


def _quantize_rows(y: torch.Tensor, amax=None) -> QuantizedActs:
    """Per-token int8 of f32 rows under each row's absmax, or under
    `amax` [T] when given (the whole rows' of a slice)."""
    if amax is None:
        amax = y.abs().amax(dim=-1, keepdim=True)
    else:
        amax = amax.float()[:, None]
    s = amax.clamp_min(1e-8) / 127.0
    q = torch.round(y / s).clamp(-127, 127).to(torch.int8)
    return QuantizedActs(data=q, scale=s[:, 0])


def rms_norm_quant_plain(
    x: torch.Tensor, w: torch.Tensor, eps: float
) -> QuantizedActs:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return _quantize_rows(xf * torch.rsqrt(var + eps) * w.float())


def quant_acts_plain(x: torch.Tensor) -> QuantizedActs:
    return _quantize_rows(x.float())


def acts_absmax_plain(x: torch.Tensor) -> torch.Tensor:
    return x.float().abs().amax(dim=-1)


def quant_acts_given_plain(x: torch.Tensor, amax: torch.Tensor) -> QuantizedActs:
    return _quantize_rows(x.float(), amax)


# ---------------------------------------------------------------------------
# the kernel's plan, from shapes alone
# ---------------------------------------------------------------------------

VEC = 8  # bf16 a 16-byte vector
MAX_CLUSTER = 8  # the portable cluster size
MAX_THREADS = 512  # a CTA (csrc/norm_quant.cu MAX_THREADS)
VECS = (1, 2, 4, 8)  # vectors a thread the kernel is built for
CTA_THREADS = 256  # threads a row slot, and a CTA, at most but for wide rows
ROWS_VECS = 4  # vectors a thread aimed at when rows are many
CLUSTER_MIN_VECS = 3072  # at few rows, a wider row splits over a cluster
CLUSTER_VECS = 1024  # ... one rank a slice of this many vectors
SM_THREADS = 2048  # threads an SM holds: the grid


@dataclass(frozen=True)
class ActsPlan:
    """How `norm_quant_kernel` runs a [T, D] launch: a row split over a
    cluster of `cluster` CTAs, each rank's slice (`slice` 16-byte vectors)
    held by a slot of `threads` threads with `vecs` vectors each; `rows`
    slots a CTA; `grid` CTAs walk the ceil(T / rows) row groups
    grid-stride, a cluster a group at a time."""

    cluster: int
    threads: int
    rows: int
    vecs: int
    slice: int
    grid: int

    @property
    def regime(self) -> str:
        return "cluster" if self.cluster > 1 else "rows"


@functools.lru_cache(maxsize=1024)
def acts_plan(T: int, D: int, sms: int) -> ActsPlan:
    """The plan of a [T, D] launch on a card of `sms` SMs, from the timings
    of `scripts/torch_acts_ablate.py` on an H100 (PERF.md). A row's slice
    goes to a slot of up to CTA_THREADS threads, with 1 vector a thread or
    more at few rows (2T <= sms: the shortest chain a row) and ROWS_VECS
    or more at many (fewer, busier threads). At few rows only a row wider
    than CLUSTER_MIN_VECS vectors (24,576 bf16) splits over a cluster of
    ranks of CLUSTER_VECS vectors: a cluster's barriers cost more than a
    split saves at narrower rows. Narrow rows share a CTA, and the grid is
    sized to the card. x's alignment moves only each row's head and tail
    scalars, which the kernel finds from the row's address, so it does not
    enter the plan. Memoized on its arguments (never on addresses)."""
    if T <= 0 or D <= 0:
        raise NotImplementedError(f"norm_quant: no rows or no width ({T}, {D})")
    nv = max(1, D // VEC)
    few = 2 * T <= sms
    cluster = 1
    if few and nv > CLUSTER_MIN_VECS:
        cluster = min(MAX_CLUSTER, -(-nv // CLUSTER_VECS))
    while -(-nv // cluster) > MAX_THREADS * VECS[-1]:
        cluster += 1
    if cluster > MAX_CLUSTER:
        raise NotImplementedError(f"norm_quant: a row of {D} is too wide")
    sl = -(-nv // cluster)
    aim = 1 if few else ROWS_VECS
    threads = min(CTA_THREADS, (-(-sl // aim) + 31) // 32 * 32)
    if threads * VECS[-1] < sl:
        threads = (-(-sl // VECS[-1]) + 31) // 32 * 32
    vecs = next(v for v in VECS if threads * v >= sl)
    rows = 1
    if cluster == 1:
        rows = max(1, min(CTA_THREADS // threads, -(-T // sms)))
    groups = -(-T // rows)
    per_sm = max(1, SM_THREADS // (rows * threads))
    grid = cluster * min(groups, sms * per_sm)
    return ActsPlan(cluster, threads, rows, vecs, sl, grid)


def plan_for(x: torch.Tensor) -> ActsPlan:
    """The plan of a launch on the CUDA tensor x [T, D]."""
    T, D = x.shape
    return acts_plan(T, D, sm_count(torch, x.device))


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("norm_quant")
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.chitu_norm_quant.argtypes = [P, P, P, P, I, I, F] + [I] * 6 + [P]
        lib.chitu_norm_quant.restype = ctypes.c_int
        lib.chitu_quant_rowmax.argtypes = [P, P, P, P, I, I] + [I] * 7 + [P]
        lib.chitu_quant_rowmax.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _launch(kernel: str, x: torch.Tensor, w, eps: float) -> QuantizedActs:
    if x.dim() != 2:
        raise ValueError(f"x must be [T, D], got {tuple(x.shape)}")
    T, D = x.shape
    dev = x.device
    cuda_build.check("x", x, torch.bfloat16, dev, align=2)
    if w is not None:
        cuda_build.check("w", w, torch.bfloat16, dev, (D,), align=2)
    plan = plan_for(x)
    xq = torch.empty((T, D), dtype=torch.int8, device=dev)
    s = torch.empty((T,), dtype=torch.float32, device=dev)
    rc = _lib().chitu_norm_quant(
        cuda_build.ptr(x), cuda_build.ptr(w), cuda_build.ptr(xq),
        cuda_build.ptr(s), T, D, float(eps), plan.cluster, plan.threads,
        plan.rows, plan.vecs, plan.slice, plan.grid, cuda_build.stream(dev),
    )
    cuda_build.raise_on(rc, kernel)
    LAUNCHES[kernel] += 1
    return QuantizedActs(data=xq, scale=s)


# the row-parallel modes of `chitu_quant_rowmax`
PARTIAL, GIVEN = 1, 2


def _launch_rowmax(kernel: str, x: torch.Tensor, amax, mode: int):
    if x.dim() != 2:
        raise ValueError(f"x must be [T, D], got {tuple(x.shape)}")
    T, D = x.shape
    dev = x.device
    cuda_build.check("x", x, torch.bfloat16, dev, align=2)
    plan = plan_for(x)
    if mode == GIVEN:
        cuda_build.check("amax", amax, torch.float32, dev, (T,))
        xq = torch.empty((T, D), dtype=torch.int8, device=dev)
        s = torch.empty((T,), dtype=torch.float32, device=dev)
    else:
        amax = torch.empty((T,), dtype=torch.float32, device=dev)
        xq = s = None
    rc = _lib().chitu_quant_rowmax(
        cuda_build.ptr(x), cuda_build.ptr(amax), cuda_build.ptr(xq),
        cuda_build.ptr(s), T, D, mode, plan.cluster, plan.threads,
        plan.rows, plan.vecs, plan.slice, plan.grid, cuda_build.stream(dev),
    )
    cuda_build.raise_on(rc, kernel)
    LAUNCHES[kernel] += 1
    return amax if mode == PARTIAL else QuantizedActs(data=xq, scale=s)


def acts_absmax(x: torch.Tensor) -> torch.Tensor:
    """Each row's absmax [T] f32 of [T, D] activations (a rank's slice of
    row-parallel rows), unfloored."""
    if not x.is_cuda:
        return acts_absmax_plain(x)
    return _launch_rowmax("acts_absmax", x, None, PARTIAL)


def quant_acts_given(x: torch.Tensor, amax: torch.Tensor) -> QuantizedActs:
    """Per-token int8 of [T, D] activations under a given absmax [T] f32
    a row (the whole rows', of which x holds a slice)."""
    if not x.is_cuda:
        return quant_acts_given_plain(x, amax)
    return _launch_rowmax("quant_acts_given", x, amax, GIVEN)


def rms_norm_quant(
    x: torch.Tensor,  # [T, D]
    w: torch.Tensor,  # [D]
    eps: float,
) -> QuantizedActs:
    """Fused rmsnorm(x) * w -> per-token int8 (values, scales)."""
    if not x.is_cuda:
        return rms_norm_quant_plain(x, w, eps)
    return _launch("rms_norm_quant", x, w, eps)


def quant_acts(x: torch.Tensor) -> QuantizedActs:
    """Per-token int8 quantization of [T, D] activations (no norm)."""
    if not x.is_cuda:
        return quant_acts_plain(x)
    return _launch("quant_acts", x, None, 0.0)
