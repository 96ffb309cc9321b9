"""Multi-GPU serving: the rank grid, the process group and its
collectives, and the sharding rules that cut a full parameter tree into
one rank's shard.

Counterpart of `chitu_tpu/parallel/`. Ported: tensor parallelism of the
Llama family (`mesh`, `distributed`, `sharding`). Not ported yet, in the
order later slices take them: pipeline and data parallelism
(`chitu_tpu/parallel/pipeline.py`), expert parallelism for Mixtral and
DeepSeek under TP, ring prefill and ring KV (`ring.py`,
`ops/attention_ring.py`), and streamed loads (`loader_streaming.py`).
"""

from chitu_tpu_torch.parallel.mesh import (  # noqa: F401
    RankGrid,
    make_mesh,
    mesh_from_config,
)
