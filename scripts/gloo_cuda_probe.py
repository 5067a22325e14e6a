#!/usr/bin/env python3
"""Which ``torch.distributed`` collectives the gloo backend runs on CUDA
tensors, two ranks sharing one card.

    python3 scripts/gloo_cuda_probe.py

NCCL refuses two ranks on one device, so ``chip_smoke.py``'s two-rank
phase runs gloo with CUDA tensors. Gloo stages some collectives through
the host and hands others the device pointer, which can abort the process
(not raise). So each collective runs in a fresh pair of spawned processes:
the line of each reads ``ok`` (and whether the result is right),
``raised: <message>``, or ``died`` with the ranks' exit codes. Prints the
card, then one JSON object by collective. Needs a GPU.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import queue
import socket
import subprocess
import sys

OPS = ("all_reduce", "broadcast", "all_gather", "reduce_scatter",
       "all_to_all_single", "batch_isend_irecv", "send_recv", "barrier")


def _run(op: str, rank: int, port: int, results) -> None:
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    try:
        x = torch.full((8,), float(rank + 1), device="cuda")
        want = None
        if op == "all_reduce":
            dist.all_reduce(x)
            got, want = x, torch.full_like(x, 3.0)
        elif op == "broadcast":
            dist.broadcast(x, src=0)
            got, want = x, torch.full_like(x, 1.0)
        elif op == "all_gather":
            parts = [torch.empty_like(x) for _ in range(2)]
            dist.all_gather(parts, x)
            got = torch.cat(parts)
            want = torch.cat([torch.full_like(x, 1.0), torch.full_like(x, 2.0)])
        elif op == "reduce_scatter":
            got = torch.empty(4, device="cuda")
            dist.reduce_scatter(got, list(x.chunk(2)))
            want = torch.full_like(got, 3.0)
        elif op == "all_to_all_single":
            got = torch.empty_like(x)
            dist.all_to_all_single(got, x)
            want = torch.cat([torch.full((4,), 1.0), torch.full((4,), 2.0)]
                             ).cuda()
        elif op == "batch_isend_irecv":
            got = torch.empty_like(x)
            for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, x, 1 - rank),
                    dist.P2POp(dist.irecv, got, 1 - rank)]):
                req.wait()
            want = torch.full_like(x, float(2 - rank))
        elif op == "send_recv":
            got = torch.empty_like(x)
            if rank == 0:
                dist.send(x, 1)
                dist.recv(got, 1)
            else:
                dist.recv(got, 0)
                dist.send(x, 0)
            want = torch.full_like(x, float(2 - rank))
        else:
            dist.barrier()
            got = want = x
        torch.cuda.synchronize()
        results.put((rank, "ok" if torch.equal(got, want)
                     else f"ok but wrong: {got.tolist()}"))
    except Exception as e:      # the probe's finding: this collective raises
        results.put((rank, "raised: " + str(e).splitlines()[0][:160]))
    finally:
        dist.destroy_process_group()


def probe(op: str) -> str:
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [ctx.Process(target=_run, args=(op, r, port, results))
             for r in range(2)]
    for p in procs:
        p.start()
    got = {}
    # The answers first, then the joins: a writer joined before its queue
    # drains can hang. A rank that died sends nothing.
    try:
        while len(got) < 2:
            rank, msg = results.get(timeout=60)
            got[rank] = msg
    except queue.Empty:
        pass
    for p in procs:
        p.join(timeout=30)
        if p.is_alive():
            p.terminate()
            p.join(timeout=10)
    if len(got) < 2:
        return f"died (exit codes {[p.exitcode for p in procs]}; " \
               f"answers {got})"
    return got[0] if got[0] == got[1] else f"rank 0 {got[0]}; rank 1 {got[1]}"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("gloo_cuda_probe: needs a GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(f"torch {torch.__version__}", flush=True)
    out = {}
    for op in OPS:
        out[op] = probe(op)
        print(f"{op}: {out[op]}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
