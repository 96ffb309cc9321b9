"""Multi-GPU serving: the rank grid, the process group and its
collectives, and the sharding rules that cut a full parameter tree into
one rank's shard.

Counterpart of `chitu_tpu/parallel/`. Ported: tensor parallelism of the
Llama family and pipeline parallelism of every family (`mesh`,
`distributed`, `sharding`, `pipeline`: the stage relay and the
microbatch-pipelined decode). Not ported yet, in the order later slices
take them: expert parallelism for Mixtral and DeepSeek under TP, then
ring prefill and ring KV with data parallelism (`ring.py`,
`ops/attention_ring.py`), and streamed loads (`loader_streaming.py`).
"""

from chitu_tpu_torch.parallel.mesh import (  # noqa: F401
    RankGrid,
    make_mesh,
    mesh_from_config,
)
