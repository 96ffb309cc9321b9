"""Multi-process bring-up and the collectives of tensor parallelism.

Counterpart of `chitu_tpu/parallel/distributed.py` (reference:
chitu/backend.py:88-89 init_process_group, script/srun_multi_node.sh).
The JAX package runs one program over a global mesh and lets XLA insert
the collectives; here every rank is a process that holds its shard of
the weights and calls the collectives itself, over `torch.distributed`.

The control plane stays what the JAX package describes: every rank runs
the same host state machine, so every rank derives the same schedule
from the same request stream. Rank 0 (the controller) takes the requests
and broadcasts them, step by step, with every decision that reads the
host clock (`TPGroup.decide`): ranks that launched different programs
would deadlock in the next collective.

The backend follows the device map: `nccl` when every rank has a card of
its own, `gloo` when ranks share a card or run on the CPU. Both carry
the collectives used here on CUDA tensors: an all-reduce (the f32 sum
after row-parallel projections, and the gathers, done as the sum of
zero-padded buffers, which is exact) and an object broadcast on a CPU
group.
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
    if _GROUP is not None and _GROUP.size == n_proc:
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
    _GROUP = TPGroup(dev)
    logger.info("rank %d of %d on %s, backend %s", _GROUP.rank, _GROUP.size,
                dev, _GROUP.backend)
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
    """The tensor-parallel group (the whole world in this slice): its
    rank, size, backend and the collectives the model and the engine
    call."""

    def __init__(self, device: torch.device):
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self.backend = dist.get_backend()
        self.device = device
        # host objects travel on a CPU group: gloo itself, or a gloo
        # group beside nccl
        self.obj_group = (
            None if self.backend == "gloo" else dist.new_group(backend="gloo")
        )

    def all_reduce_f32(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over ranks in f32 (the JAX package's `psum_f32`: exact for
        bf16 partial sums), back in x's dtype."""
        y = x.to(torch.float32, copy=True)
        dist.all_reduce(y)
        return y.to(x.dtype)

    def gather_last(self, local: torch.Tensor, start: int,
                    total: int) -> torch.Tensor:
        """Every rank's slice [..., start:start + n] of the last dim, joined
        into [..., total] on every rank, in f32: the all-reduce of
        zero-padded buffers (exact: each entry has one nonzero term)."""
        buf = torch.zeros((*local.shape[:-1], total), dtype=torch.float32,
                          device=local.device)
        buf[..., start:start + local.shape[-1]] = local
        dist.all_reduce(buf)
        return buf

    def decide(self, value):
        """Rank 0's `value` (a picklable host decision: a window length,
        a step's requests and clock) on every rank: what differs from rank
        to rank must not steer the program a rank launches."""
        box = [value if self.rank == 0 else None]
        dist.broadcast_object_list(box, src=0, group=self.obj_group)
        return box[0]


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
    logger.critical("ending the tensor-parallel world: %s", why)
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
    """`python -m chitu_tpu_torch infer.tp_size=N ...` on one host: start
    ranks 1..N-1 as copies of this command and become rank 0, which ends
    when one of them fails."""
    coord = local_coordinator()
    procs = spawn_ranks([sys.executable, "-m", "chitu_tpu_torch", *argv], n,
                        coord)
    threading.Thread(target=_watch, args=(procs,), daemon=True).start()
    os.environ.update(CHITU_TPU_COORDINATOR=coord,
                      CHITU_TPU_NUM_PROCESSES=str(n),
                      CHITU_TPU_PROCESS_ID="0")
