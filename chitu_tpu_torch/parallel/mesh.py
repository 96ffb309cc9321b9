"""The rank grid.

Counterpart of `chitu_tpu/parallel/mesh.py`. A JAX mesh names the axes
of a device array; here the same axes name a grid of processes, one
rank a process, rank = (d * pp + p) * tp + t, so the ranks of one
tensor-parallel group are consecutive:
- "dp": data parallel (replicas; the ring KV pool stripes its pages over
  them, ring prefill its prompt's tokens);
- "pp": pipeline stages (the layer stack, cut into pp equal ranges);
- "tp": tensor parallel (weight shards; expert parallelism lives on the
  same axis, as it does in the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


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
    return RankGrid(dp, pp, tp)


def mesh_from_config(cfg, ranks: Optional[int] = None) -> Optional[RankGrid]:
    i = cfg.infer
    if i.dp_size * i.pp_size * i.tp_size <= 1:
        return None
    return make_mesh(i.dp_size, i.pp_size, i.tp_size, ranks)
