"""The port stands alone: every module of chitu_tpu_torch imports with
jax and chitu_tpu blocked (and without PyYAML, aiohttp, pydantic,
safetensors, transformers, tokenizers or ml_dtypes, which the GPU machine
lacks), so does chip_smoke.py, and the engine never falls back to the CPU
on its own."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORTS = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "chitu_tpu", "yaml", "aiohttp", "pydantic",
             "safetensors", "transformers", "tokenizers", "ml_dtypes"):
    sys.modules[name] = None  # any import of these now raises ImportError
import chitu_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(
    chitu_tpu_torch.__path__, "chitu_tpu_torch.")
    if not m.name.endswith("__main__")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
from chitu_tpu_torch import load_config
load_config(overrides=["models=Llama-3-8B-Instruct"])
leaked = sorted(k for k in sys.modules if k.split(".")[0] in (
    "jax", "chitu_tpu", "safetensors", "transformers", "tokenizers", "ml_dtypes")
                and sys.modules[k] is not None)
assert not leaked, leaked
print(len(mods))
"""


def test_every_module_imports_without_jax_or_chitu_tpu():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORTS], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip().splitlines()[-1]) >= 20


def test_engine_without_device_never_runs_on_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from chitu_tpu_torch import load_config
    from chitu_tpu_torch.engine import Engine

    cfg = load_config(overrides=["models=micro-llama-debug",
                                 "infer.max_seq_len=128", "infer.max_reqs=2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg)


def test_chip_smoke_fails_without_a_device(tmp_path):
    """Without CUDA the smoke script exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
