"""Multi-GPU serving: the rank grid, the process group and its
collectives, and the sharding rules that cut a full parameter tree into
one rank's shard.

Counterpart of `chitu_tpu/parallel/`. Ported: tensor parallelism of
every family (expert parallelism for Mixtral and DeepSeek), pipeline
parallelism (`mesh`, `distributed`, `sharding`, `pipeline`: the stage
relay and the microbatch-pipelined decode), and data parallelism with
the ring KV pool and ring prefill (`distributed.DPGroup`, `ring`,
`ops/attention_ring.py`). Not ported yet: streamed loads
(`loader_streaming.py`).
"""

from chitu_tpu_torch.parallel.mesh import (  # noqa: F401
    RankGrid,
    make_mesh,
    mesh_from_config,
)
