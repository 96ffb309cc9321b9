"""Multi-process bring-up, the collectives of tensor parallelism and the
pipeline's stage relay.

Counterpart of `chitu_tpu/parallel/distributed.py` (reference:
chitu/backend.py:88-89 init_process_group, script/srun_multi_node.sh;
the stage relay of chitu/executor.py:179-299). The JAX package runs one
program over a global mesh and lets XLA insert the collectives; here
every rank is a process that holds its shard of the weights and calls
the collectives itself, over `torch.distributed`.

The world is pp x tp ranks, rank = p * tp + t (`parallel.mesh`): stage p
holds a range of the layers, and its tp ranks form one tensor-parallel
group (`dist.new_group`; every rank creates every group, in one order).
The control plane stays what the JAX package describes: every rank runs
the same host state machine, so every rank derives the same schedule
from the same request stream. Rank 0 (stage 0, t 0: the controller)
takes the requests and broadcasts them, step by step, over the world,
with every decision that reads the host clock (`TPGroup.decide`): ranks
that launched different programs would deadlock in the next collective.

The backend follows the device map: `nccl` when every rank has a card of
its own, `gloo` when ranks share a card or run on the CPU. Both carry
every collective used here on CUDA tensors: an all-reduce (the f32 sum
after row-parallel projections, and the gathers, done as the sum of
zero-padded buffers, which is exact), a broadcast (the stage relay and
the tokens of the sampling stage), and an object broadcast on a CPU
group. gloo has no point-to-point `send` / `recv` of CUDA tensors, so
the relay is a broadcast inside a two-rank group {(p, t), (p + 1, t)}
(`StageRelay`), the same call on either backend.
"""

from __future__ import annotations

import atexit
import datetime
import os
import socket
import subprocess
import sys
import threading
import time
from typing import List, Optional

import torch
import torch.distributed as dist

from chitu_tpu_torch.utils import get_logger, init_logger

logger = get_logger()

_GROUP: Optional["TPGroup"] = None
# the bound of every collective, the followers' wait for rank 0's next
# step included: an idle server must not time out. Test and smoke worlds
# are bounded by their launchers, which kill every rank.
DEFAULT_TIMEOUT_S = 86400.0


def _settings(cfg):
    infer = cfg.infer
    coord = infer.coordinator or os.environ.get("CHITU_TPU_COORDINATOR", "")
    n_proc = infer.num_processes
    if n_proc <= 1:
        n_proc = int(os.environ.get("CHITU_TPU_NUM_PROCESSES", "1"))
    pid = infer.process_id
    if pid < 0:
        pid = int(os.environ.get("CHITU_TPU_PROCESS_ID", "0"))
    return coord, n_proc, pid


def rank_device(device, rank: int) -> torch.device:
    """Rank r's device: `cuda:(r % device_count)` unless the caller asked
    for the CPU."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return torch.device("cuda", rank % torch.cuda.device_count())


def backend_for(device: torch.device, world: int) -> str:
    """nccl when every rank has its own card; gloo when ranks share one
    (NCCL refuses two ranks of a communicator on one device) or run on
    the CPU."""
    if device.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def maybe_initialize(cfg, device=None) -> bool:
    """Join the process group when configured (infer.coordinator /
    num_processes / process_id, or the CHITU_TPU_COORDINATOR,
    CHITU_TPU_NUM_PROCESSES, CHITU_TPU_PROCESS_ID variables). The
    coordinator is `host:port` (a TCP rendezvous) or a `file://` URL.
    Returns True when multi-process."""
    global _GROUP
    coord, n_proc, pid = _settings(cfg)
    if n_proc <= 1:
        return False
    if not coord:
        # half-configured multi-process must not silently serve 1/N of
        # the model from each process
        raise ValueError(
            f"num_processes={n_proc} but no coordinator: set "
            "infer.coordinator=host:port (or CHITU_TPU_COORDINATOR)"
        )
    if _GROUP is not None and _GROUP.world_size == n_proc:
        return True
    dev = rank_device(device, pid)
    backend = backend_for(dev, n_proc)
    init_logger(rank=pid)
    if not dist.is_initialized():
        url = coord if "://" in coord else f"tcp://{coord}"
        logger.info(
            "torch.distributed.init_process_group(%s, %s, world_size=%d, "
            "rank=%d)", backend, url, n_proc, pid,
        )
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=url, world_size=n_proc, rank=pid,
            timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S),
        )
    _GROUP = TPGroup(dev, cfg.infer.pp_size)
    logger.info("rank %d of %d (stage %d of %d, TP rank %d of %d) on %s, "
                "backend %s", _GROUP.world_rank, _GROUP.world_size,
                _GROUP.stage, _GROUP.pp, _GROUP.rank, _GROUP.size, dev,
                _GROUP.backend)
    return True


def shutdown():
    """Leave the process group (the engine's group goes with it)."""
    global _GROUP
    _GROUP = None
    if dist.is_initialized():
        dist.destroy_process_group()


def tp_group() -> Optional["TPGroup"]:
    return _GROUP


def is_controller() -> bool:
    """Rank 0 runs the scheduler's inputs and the HTTP server (reference:
    rank-0 special-casing, chitu_main.py:42-45, serve.py:226-233)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


class TPGroup:
    """This rank's place in the world: its tensor-parallel group (the tp
    ranks of its pipeline stage; the whole world when pp is 1), the
    collectives the model and the engine call, and, under pp > 1, the
    stage relay (`relay`). `rank` and `size` are the rank's index in its
    TP group and that group's size; `world_rank` is its rank in the
    world."""

    def __init__(self, device: torch.device, pp: int = 1):
        self.world_rank = dist.get_rank()
        self.world_size = dist.get_world_size()
        if pp < 1 or self.world_size % pp:
            raise ValueError(
                f"a world of {self.world_size} ranks cannot hold {pp} "
                "pipeline stages of equal tensor-parallel groups")
        self.pp = pp
        self.size = self.world_size // pp
        self.rank = self.world_rank % self.size
        self.stage = self.world_rank // self.size
        self.backend = dist.get_backend()
        self.device = device
        # host objects travel on a CPU group: gloo itself, or a gloo
        # group beside nccl
        self.obj_group = (
            None if self.backend == "gloo" else dist.new_group(backend="gloo")
        )
        # the stage's TP group (None: the world, when it is the only
        # stage); every rank makes every stage's group, in stage order
        self.pg = None
        if pp > 1 and self.size > 1:
            for p in range(pp):
                g = dist.new_group(ranks=list(range(p * self.size,
                                                    (p + 1) * self.size)))
                if p == self.stage:
                    self.pg = g
        self.relay = StageRelay(self) if pp > 1 else None

    def all_reduce_f32(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the TP group in f32 (the JAX package's `psum_f32`:
        exact for bf16 partial sums), back in x's dtype."""
        y = x.to(torch.float32, copy=True)
        dist.all_reduce(y, group=self.pg)
        return y.to(x.dtype)

    def gather_last(self, local: torch.Tensor, start: int,
                    total: int) -> torch.Tensor:
        """Every TP rank's slice [..., start:start + n] of the last dim,
        joined into [..., total] on every rank of the group, in f32: the
        all-reduce of zero-padded buffers (exact: each entry has one
        nonzero term)."""
        buf = torch.zeros((*local.shape[:-1], total), dtype=torch.float32,
                          device=local.device)
        buf[..., start:start + local.shape[-1]] = local
        dist.all_reduce(buf, group=self.pg)
        return buf

    def decide(self, value):
        """Rank 0's `value` (a picklable host decision: a window length,
        a step's requests and clock) on every rank of the world: what
        differs from rank to rank must not steer the program a rank
        launches."""
        box = [value if self.world_rank == 0 else None]
        dist.broadcast_object_list(box, src=0, group=self.obj_group)
        return box[0]


class StageRelay:
    """The pipeline's links (reference: the PipeTensorExecutor relay,
    chitu/executor.py:179-299; the JAX package's ring `ppermute` over
    'pp', chitu_tpu/parallel/pipeline.py): the hidden state from stage p
    to stage p + 1 within TP index t, the sampled tokens from the last
    stage back to stage 0 (the ring's closing link), and the sampling
    stage's results to the whole world. Each link is a broadcast in a
    two-rank group; the links are ordered (0, 1), (1, 2), ...,
    (pp - 2, pp - 1), (pp - 1, 0), and a rank that takes two links in one
    phase takes them in that order, so no cycle of waits can form."""

    def __init__(self, world: TPGroup):
        pp, tp, t = world.pp, world.size, world.rank
        self.pp, self.tp, self.stage = pp, tp, world.stage
        self.first, self.last = world.stage == 0, world.stage == pp - 1
        self.world_rank = world.world_rank
        # the world rank of stage p at this TP index
        self.at = lambda p: p * tp + t
        # the sampling stage's first rank: the source of the tokens
        self.sampler = (pp - 1) * tp
        edges = [(a, a + 1) for a in range(pp - 1)]
        if pp > 2:
            edges.append((pp - 1, 0))
        self.links = {}
        for ti in range(tp):
            for a, b in edges:
                g = dist.new_group(ranks=sorted((a * tp + ti, b * tp + ti)))
                if ti == t:
                    self.links[(a, b)] = g
        # pp 2: the ring's closing link is the one forward link
        self.back = self.links[(pp - 1, 0) if pp > 2 else (0, 1)]

    def send_next(self, x: torch.Tensor):
        """The hidden state to stage p + 1 (not on the last stage)."""
        dist.broadcast(x.contiguous(), src=self.world_rank,
                       group=self.links[(self.stage, self.stage + 1)])

    def recv_prev(self, buf: torch.Tensor) -> torch.Tensor:
        """Stage p - 1's hidden state, into `buf` (not on stage 0)."""
        dist.broadcast(buf, src=self.at(self.stage - 1),
                       group=self.links[(self.stage - 1, self.stage)])
        return buf

    def send_first(self, x: torch.Tensor):
        """The last stage's tokens to stage 0 (the ring's closing link)."""
        dist.broadcast(x.contiguous(), src=self.world_rank, group=self.back)

    def recv_last(self, buf: torch.Tensor) -> torch.Tensor:
        """On stage 0: the last stage's tokens, into `buf`."""
        dist.broadcast(buf, src=self.at(self.pp - 1), group=self.back)
        return buf

    def from_last(self, x: Optional[torch.Tensor], shape, dtype,
                  device) -> torch.Tensor:
        """The sampling stage's tensor on every rank of the world: `x` on
        the last stage (all its TP ranks hold the same values), a buffer
        of `shape` elsewhere."""
        buf = x.contiguous() if x is not None else torch.empty(
            shape, dtype=dtype, device=device)
        dist.broadcast(buf, src=self.sampler)
        return buf


# ---------------------------------------------------------------------------
# one command, N ranks on one host
# ---------------------------------------------------------------------------


def local_coordinator() -> str:
    """A free TCP port on the loopback."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


# the ranks this process started (`spawn_ranks`)
_CHILDREN: List[subprocess.Popen] = []


def _reap():
    for p in _CHILDREN:
        if p.poll() is None:
            p.kill()
            p.wait()


def end_world(why: str):
    """End this process now, with code 1, and the ranks it started: a rank
    that left the lockstep would leave the others waiting in a
    collective."""
    logger.critical("ending the world of ranks: %s", why)
    _reap()
    os._exit(1)


def spawn_ranks(cmd: List[str], n: int, coordinator: str,
                first: int = 1) -> List[subprocess.Popen]:
    """Start ranks first..n-1 as `cmd` with the rendezvous in their
    environment; they are killed when this process exits. The caller is
    rank 0 (first=1) or starts it too (first=0)."""
    procs = []
    for r in range(first, n):
        e = dict(os.environ)
        e.update(CHITU_TPU_COORDINATOR=coordinator,
                 CHITU_TPU_NUM_PROCESSES=str(n), CHITU_TPU_PROCESS_ID=str(r))
        procs.append(subprocess.Popen(cmd, env=e))
    if not _CHILDREN:
        atexit.register(_reap)
    _CHILDREN.extend(procs)
    return procs


def _watch(procs: List[subprocess.Popen]):
    while True:
        for p in procs:
            if p.poll() not in (None, 0):
                end_world(f"a rank it started exited with {p.returncode}")
        time.sleep(1.0)


def serve_local(argv: List[str], n: int):
    """`python -m chitu_tpu_torch infer.tp_size=N ...` (or
    `infer.pp_size=P`, N = P x tp_size) on one host: start
    ranks 1..N-1 as copies of this command and become rank 0, which ends
    when one of them fails."""
    coord = local_coordinator()
    procs = spawn_ranks([sys.executable, "-m", "chitu_tpu_torch", *argv], n,
                        coord)
    threading.Thread(target=_watch, args=(procs,), daemon=True).start()
    os.environ.update(CHITU_TPU_COORDINATOR=coord,
                      CHITU_TPU_NUM_PROCESSES=str(n),
                      CHITU_TPU_PROCESS_ID="0")
