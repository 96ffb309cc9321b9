"""Multi-process bring-up, the collectives of tensor parallelism, the
pipeline's stage relay and the data-parallel replicas' ring.

Counterpart of `chitu_tpu/parallel/distributed.py` (reference:
chitu/backend.py:88-89 init_process_group, script/srun_multi_node.sh;
the stage relay of chitu/executor.py:179-299). The JAX package runs one
program over a global mesh and lets XLA insert the collectives; here
every rank is a process that holds its shard of the weights and calls
the collectives itself, over `torch.distributed`.

The world is dp x pp x tp ranks, rank = (d * pp + p) * tp + t
(`parallel.mesh`): replica d is a whole copy of the pp x tp layout,
stage p of it holds a range of the layers, and its tp ranks form one
tensor-parallel group (`dist.new_group`; every rank creates every group,
in one order). The dp ranks of one (stage, TP index) form its dp group
(`DPGroup`): the ring KV pool merges its decode partials there, the
MoE layer gathers its token split there, and ring prefill passes K/V
slices around it. The control plane stays what the JAX package
describes: every rank runs the same host state machine, so every rank
derives the same schedule from the same request stream. Rank 0 (replica
0, stage 0, t 0: the controller) takes the requests and broadcasts them,
step by step, over the world, with every decision that reads the host
clock (`TPGroup.decide`): ranks that launched different programs would
deadlock in the next collective. Replica 0's sampling rank is the one
sampler of record: its tokens go to every rank (`TPGroup.from_sampler`),
so no replica's stream parts from another's.

The backend follows the device map: `nccl` when every rank has a card of
its own, `gloo` when ranks share a card or run on the CPU. Both carry
every collective used here on CUDA tensors: an all-reduce (the f32 sum
after row-parallel projections, the max of a W8A8 row-parallel input's
per-token absmax, and the TP group's gathers, done as the sum of
zero-padded buffers, which is exact), an all-gather (the dp
group's: the ring KV decode's partials, the MoE token split's rows), a
broadcast (the stage relay and
the tokens of the sampling stage), and an object broadcast on a CPU
group. gloo has no point-to-point `send` / `recv` of CUDA tensors, so
the relay is a broadcast inside a two-rank group {(p, t), (p + 1, t)}
(`StageRelay`), the same call on either backend, and so is each link of
the dp ring (`DPGroup.pass_on`).
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
        if (_GROUP.pp, _GROUP.dp) != (cfg.infer.pp_size, cfg.infer.dp_size):
            # another layout of the same world (a later engine of these
            # processes): every rank makes its groups anew, in one order
            _GROUP = TPGroup(_GROUP.device, cfg.infer.pp_size,
                             cfg.infer.dp_size)
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
    _GROUP = TPGroup(dev, cfg.infer.pp_size, cfg.infer.dp_size)
    logger.info("rank %d of %d (replica %d of %d, stage %d of %d, TP rank "
                "%d of %d) on %s, backend %s", _GROUP.world_rank,
                _GROUP.world_size, _GROUP.replica, _GROUP.dp, _GROUP.stage,
                _GROUP.pp, _GROUP.rank, _GROUP.size, dev, _GROUP.backend)
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
    ranks of its replica's pipeline stage; the whole world when dp and pp
    are 1), the collectives the model and the engine call, under pp > 1
    the stage relay (`relay`), and under dp > 1 the dp group of its
    (stage, TP index) (`dp_group`). `rank` and `size` are the rank's index
    in its TP group and that group's size; `stage` its pipeline stage,
    `replica` its dp index; `world_rank` is its rank in the world."""

    def __init__(self, device: torch.device, pp: int = 1, dp: int = 1):
        self.world_rank = dist.get_rank()
        self.world_size = dist.get_world_size()
        if pp < 1 or dp < 1 or self.world_size % (pp * dp):
            raise ValueError(
                f"a world of {self.world_size} ranks cannot hold {dp} "
                f"replicas of {pp} pipeline stages of equal "
                "tensor-parallel groups")
        self.pp, self.dp = pp, dp
        self.size = self.world_size // (pp * dp)
        self.rank = self.world_rank % self.size
        self.stage = self.world_rank // self.size % pp
        self.replica = self.world_rank // (self.size * pp)
        # replica 0's sampling rank (its last stage's first TP rank)
        self.sampler = (pp - 1) * self.size
        self.backend = dist.get_backend()
        self.device = device
        # host objects travel on a CPU group: gloo itself, or a gloo
        # group beside nccl
        self.obj_group = (
            None if self.backend == "gloo" else dist.new_group(backend="gloo")
        )
        # the TP group of this replica's stage (None: the world, when it
        # is the only one); every rank makes every (replica, stage)'s
        # group, in rank order
        self.pg = None
        if pp * dp > 1 and self.size > 1:
            for ds in range(pp * dp):
                g = dist.new_group(ranks=list(range(ds * self.size,
                                                    (ds + 1) * self.size)))
                if ds == self.world_rank // self.size:
                    self.pg = g
        self.relay = StageRelay(self) if pp > 1 else None
        self.dp_group = DPGroup(self) if dp > 1 else None

    @property
    def needs_relay(self) -> bool:
        """Do the sampler's tokens have to reach other ranks (another
        stage, another replica)? Under tp alone every rank samples the
        same logits."""
        return self.pp > 1 or self.dp > 1

    def from_sampler(self, x: Optional[torch.Tensor], shape, dtype,
                     device) -> torch.Tensor:
        """Replica 0's sampling-stage tensor on every rank of the world:
        `x` where the rank samples (its values are replaced by the
        sampler's), a buffer of `shape` elsewhere."""
        buf = x.contiguous() if x is not None else torch.empty(
            shape, dtype=dtype, device=device)
        dist.broadcast(buf, src=self.sampler)
        return buf

    def all_reduce_f32(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the TP group in f32 (the JAX package's `psum_f32`:
        exact for bf16 partial sums), back in x's dtype."""
        y = x.to(torch.float32, copy=True)
        dist.all_reduce(y, group=self.pg)
        return y.to(x.dtype)

    def max_(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max over the TP group, in place (a row-parallel
        input's per-token absmax, [T] f32: each rank holds a slice of the
        row, and a max is exact in any order)."""
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.pg)
        return x

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
        pp, tp, t, d = world.pp, world.size, world.rank, world.replica
        self.pp, self.tp, self.stage = pp, tp, world.stage
        self.first, self.last = world.stage == 0, world.stage == pp - 1
        self.world_rank = world.world_rank
        self.world = world
        # the world rank of stage p of this replica at this TP index
        self.at = lambda p: (d * pp + p) * tp + t
        # replica 0's sampling stage's first rank: the source of the tokens
        self.sampler = world.sampler
        edges = [(a, a + 1) for a in range(pp - 1)]
        if pp > 2:
            edges.append((pp - 1, 0))
        self.links = {}
        for di in range(world.dp):
            for ti in range(tp):
                for a, b in edges:
                    at = lambda p: (di * pp + p) * tp + ti  # noqa: E731
                    g = dist.new_group(ranks=sorted((at(a), at(b))))
                    if (di, ti) == (d, t):
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


class DPGroup:
    """The dp ranks of one (stage, TP index): rank (d * pp + p) * tp + t
    for d in 0..dp-1, `rank` = d (the JAX package's 'dp' mesh axis, as
    the ring ops see it). Its collectives: the all-reduces of the ring KV
    decode's combine (`max_`, `sum_`), the gather of the MoE token split
    and of decode partials (`gather`), a broadcast from one replica
    (`broadcast_from`), and the ring link of ring prefill (`pass_on`):
    replica d's held slice to replica d + 1 (mod dp). Each link is a
    broadcast in a two-rank group, taken in one fixed order, links
    (0, 1), (1, 2), ..., (dp - 1, 0): replica 0 sends on its first link
    and then receives on its last, every other replica receives first and
    then sends, so the waits form a chain, never a cycle."""

    def __init__(self, world: TPGroup):
        dp, pp, tp = world.dp, world.pp, world.size
        p, t = world.stage, world.rank
        self.size, self.rank = dp, world.replica
        self.at = lambda d: (d * pp + p) * tp + t
        self.pg = None
        for pi in range(pp):
            for ti in range(tp):
                g = dist.new_group(ranks=[(d * pp + pi) * tp + ti
                                          for d in range(dp)])
                if (pi, ti) == (p, t):
                    self.pg = g
        edges = [(a, a + 1) for a in range(dp - 1)]
        if dp > 2:
            edges.append((dp - 1, 0))
        links = {}
        for pi in range(pp):
            for ti in range(tp):
                for a, b in edges:
                    at = lambda d: (d * pp + pi) * tp + ti  # noqa: E731
                    g = dist.new_group(ranks=sorted((at(a), at(b))))
                    if (pi, ti) == (p, t):
                        links[(a, b)] = g
        # dp 2: one link carries both directions
        link = lambda a, b: links.get((a, b)) or links[(b, a)]  # noqa: E731
        d = self.rank
        self.fwd = link(d, (d + 1) % dp)
        self.back = link((d - 1) % dp, d)

    def max_(self, x: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.pg)
        return x

    def sum_(self, x: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(x, group=self.pg)
        return x

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every replica's `x` -> [dp, *x.shape] f32 on every rank of the
        group, in replica order (one all-gather: each rank sends its own
        part once, where an all-reduce of zero-padded buffers would move
        all dp parts)."""
        x = x.float().contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.pg)
        return torch.stack(parts)

    def broadcast_from(self, x: torch.Tensor, d: int) -> torch.Tensor:
        """Replica d's `x` (a buffer of its shape elsewhere) on every rank
        of the group, in place."""
        dist.broadcast(x, src=self.at(d), group=self.pg)
        return x

    def pass_on(self, held: torch.Tensor, incoming: torch.Tensor
                ) -> torch.Tensor:
        """One ring step: `held` to replica d + 1, replica d - 1's held
        slice into `incoming` (its own buffer: no rank overwrites a slice
        before it has passed it on) -> incoming."""
        d, n = self.rank, self.size
        prev, nxt = (d - 1) % n, (d + 1) % n
        if d == 0:
            dist.broadcast(held, src=self.at(d), group=self.fwd)
            dist.broadcast(incoming, src=self.at(prev), group=self.back)
        else:
            dist.broadcast(incoming, src=self.at(prev), group=self.back)
            dist.broadcast(held, src=self.at(d), group=self.fwd)
        return incoming


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
    `infer.pp_size=P`, `infer.dp_size=D`: n = D x P x tp_size) on one
    host: start ranks 1..n-1 as copies of this command and become rank 0,
    which ends when one of them fails."""
    coord = local_coordinator()
    procs = spawn_ranks([sys.executable, "-m", "chitu_tpu_torch", *argv], n,
                        coord)
    threading.Thread(target=_watch, args=(procs,), daemon=True).start()
    os.environ.update(CHITU_TPU_COORDINATOR=coord,
                      CHITU_TPU_NUM_PROCESSES=str(n),
                      CHITU_TPU_PROCESS_ID="0")
