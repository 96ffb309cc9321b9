"""The rank grid.

Counterpart of `chitu_tpu/parallel/mesh.py`. A JAX mesh names the axes
of a device array; here the same axes name a grid of processes, one
rank a process, rank = (d * pp + p) * tp + t, so the ranks of one
tensor-parallel group are consecutive:
- "dp": data parallel (replicas);
- "pp": pipeline stages (the layer stack);
- "tp": tensor parallel (weight shards; expert parallelism will live on
  the same axis, as it does in the JAX package).

Only `tp` is served so far; `dp` or `pp` above 1 raise and name the
slice that brings them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

NEXT_SLICE = {
    "dp": "data parallelism comes with the PP/DP slice (ROADMAP A.1)",
    "pp": "pipeline parallelism comes with the PP/DP slice (ROADMAP A.1)",
}


@dataclass(frozen=True)
class RankGrid:
    dp: int = 1
    pp: int = 1
    tp: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.pp * self.tp


def make_mesh(dp: int = 1, pp: int = 1, tp: int = 1,
              ranks: Optional[int] = None) -> RankGrid:
    """The grid over `ranks` processes (the whole world by default, one
    when no process group is up), with the JAX package's error when there
    are too few."""
    if ranks is None:
        from chitu_tpu_torch.parallel.distributed import process_count

        ranks = process_count()
    need = dp * pp * tp
    if ranks < need:
        raise ValueError(
            f"need {need} devices for dp={dp} pp={pp} tp={tp}, have {ranks}"
        )
    for axis, n in (("dp", dp), ("pp", pp)):
        if n > 1:
            raise NotImplementedError(f"{axis}_size={n}: {NEXT_SLICE[axis]}")
    return RankGrid(dp, pp, tp)


def mesh_from_config(cfg, ranks: Optional[int] = None) -> Optional[RankGrid]:
    i = cfg.infer
    if i.dp_size * i.pp_size * i.tp_size <= 1:
        return None
    return make_mesh(i.dp_size, i.pp_size, i.tp_size, ranks)
