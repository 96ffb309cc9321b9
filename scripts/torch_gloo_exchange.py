#!/usr/bin/env python3
"""What one gloo all-reduce costs between ranks that share a card.

    python3 scripts/torch_gloo_exchange.py [ranks]   # default 2

Starts `ranks` processes on one CUDA device, joined over gloo (the
backend the port picks when ranks share a card), and on every rank in
lockstep times an f32 all-reduce of a CUDA tensor of 1 KiB to 16 MiB two
ways, 100 calls each after 10 warm ones, each call timed on the host
from a synchronized start to the result back on the device: gloo on the
CUDA tensor itself, and staged through the host (a copy to a pinned CPU
buffer, gloo on that, a copy back); and the dp group's gather of a
rank's part of that size both ways `DPGroup.gather` could take it: the
all-reduce of zero-padded [ranks, size] buffers, and one all-gather.
Rank 0 prints the card's name and power limit and one JSON line: the
median microseconds of each way by size (the gathers' by the size of a
rank's part).
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
SIZES = [256, 4096, 65536, 262144, 1048576, 4194304]  # f32 elements


def rank_main():
    import torch
    import torch.distributed as dist

    n = int(os.environ["CHITU_TPU_NUM_PROCESSES"])
    r = int(os.environ["CHITU_TPU_PROCESS_ID"])
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", init_method=f"tcp://{os.environ['CHITU_TPU_COORDINATOR']}",
        world_size=n, rank=r)
    out = {}
    for size in SIZES:
        x = torch.ones(size, device=dev)
        host = torch.empty(size, pin_memory=True)

        def on_device():
            dist.all_reduce(x)

        def staged():
            host.copy_(x)
            dist.all_reduce(host)
            x.copy_(host)

        def padded_gather():
            buf = torch.zeros((n, size), device=dev)
            buf[r] = x
            dist.all_reduce(buf)

        def all_gather():
            parts = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(parts, x)
            torch.stack(parts)

        for name, fn in (("cuda_tensor_us", on_device), ("staged_us", staged),
                         ("gather_padded_all_reduce_us", padded_gather),
                         ("gather_all_gather_us", all_gather)):
            times = []
            for i in range(110):
                torch.cuda.synchronize()
                dist.barrier()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                if i >= 10:
                    times.append((time.perf_counter() - t0) * 1e6)
            times.sort()
            out.setdefault(name, {})[f"{size * 4}B"] = times[len(times) // 2]
    if r == 0:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True
        ).stdout.strip(), flush=True)
        print(json.dumps(dict(ranks=n, **out)), flush=True)
    dist.destroy_process_group()


def main():
    if os.environ.get("CHITU_TPU_PROCESS_ID"):
        rank_main()
        return
    from chitu_tpu_torch.parallel import distributed

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    procs = distributed.spawn_ranks([sys.executable, os.path.abspath(__file__)],
                                    n, distributed.local_coordinator(), first=0)
    rc = 0
    for p in procs:
        rc |= p.wait()
    sys.exit(rc)


if __name__ == "__main__":
    main()
