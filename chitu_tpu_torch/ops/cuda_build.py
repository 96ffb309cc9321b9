"""Build and binding of the hand-written CUDA kernels, shared by every
kernel wrapper module.

Each source under `chitu_tpu_torch/csrc/` has a plain C interface and is
compiled by nvcc for sm_90a into its own shared library,
`chitu_tpu_torch/build/<name>-<hash of flags, source and headers>.so`, at
first use, and loaded with ctypes. The headers (`csrc/*.cuh`) are shared
between sources, so all of them enter every hash. `build_all()` starts one nvcc per source, all
at once. `LAUNCHES` counts kernel launches by wrapper name: a wrapper adds
one where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, List, Tuple

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
SOURCES = ("attention", "quant_gemm", "norm_quant", "moe_gemm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

# launches of each kernel since the last reset_launch_counts()
LAUNCHES: Dict[str, int] = {}

_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> Tuple[str, str]:
    src = os.path.join(CSRC, name + ".cu")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(
        os.path.join(CSRC, n) for n in os.listdir(CSRC) if n.endswith(".cuh")
    )
    for path in (src, *headers):
        with open(path, "rb") as f:
            h.update(f.read())
    return src, os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build_all(names=SOURCES) -> List[str]:
    """Compile every named source whose exact build is missing, all nvcc
    processes running at once; returns the libraries' paths."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs, paths = [], []
    for name in names:
        src, so = _target(name)
        paths.append(so)
        if os.path.exists(so):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        jobs.append((name, proc, tmp, so))
    failed = []
    for name, proc, tmp, so in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}.cu: nvcc failed ({proc.returncode}):\n{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The library built from csrc/<name>.cu (built now if missing)."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(build_all((name,))[0])
    return _LIBS[name]


def check(name: str, t: torch.Tensor, dtype, device, shape=None):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def raise_on(rc: int, kernel: str):
    if rc == 100000:
        raise NotImplementedError(f"{kernel}: geometry not supported by the kernel")
    if rc:
        raise RuntimeError(
            f"{kernel} launch failed: {torch.cuda.get_device_name()} "
            f"cudaError {rc}"
        )


def stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)
