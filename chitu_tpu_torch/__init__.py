"""chitu-tpu on PyTorch and CUDA: the LLM inference and serving engine of
`chitu_tpu/`, ported to one NVIDIA Hopper GPU.

The JAX package stays the reference each part of this one is tested
against. This package imports `torch` and never `jax` or `chitu_tpu`.
"""

__version__ = "0.1.0"

from chitu_tpu_torch.config import EngineConfig, ModelArgs, load_config
from chitu_tpu_torch.task import SampleParams, Task, TaskPool, UserRequest
