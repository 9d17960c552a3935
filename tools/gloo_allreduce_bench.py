#!/usr/bin/env python3
"""Latency of a gloo all-reduce between two processes that share one GPU:
what each all-reduce of ``chip_smoke.py``'s tp_path costs.

    python3 tools/gloo_allreduce_bench.py

Starts two ranks (with torch's default threads, then with one thread
each) that meet through a file store in a temporary directory. Each rank
times 200 iterations, after a warm-up round, of a (8, 896) @ (896, 896)
matmul on the card followed by, per mode:

  - ``cuda``: ``dist.all_reduce`` of the CUDA result (gloo copies it
    through the host);
  - ``staged``: the same by hand, ``.cpu()``, all-reduce, back to the card;
  - ``cpu_only``: an all-reduce of a CPU tensor of the same size, no card;
  - ``gpu_only``: the matmul alone.

Prints one JSON line of milliseconds per iteration for each rank and
thread setting.

    python3 tools/gloo_allreduce_bench.py --bucket 67108864 --iters 4

times instead the all-reduce of one bucket of that many f32 elements on
the card (the data-parallel update's gradient sum, ``core/train_step.
sum_grads``), ``cuda`` against ``staged``, with one thread a rank, and
prints the milliseconds and GB/s of each.
"""
import json
import os
import subprocess
import sys
import tempfile
import time


def worker(rank: int, store: str, threads: int) -> None:
    import torch
    import torch.distributed as dist
    if threads:
        torch.set_num_threads(threads)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    w = torch.randn(896, 896, device="cuda")
    x = torch.randn(8, 896, device="cuda")
    res = {}
    for mode in ("cuda", "staged", "cpu_only", "gpu_only"):
        for _ in range(2):               # the first round warms up
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                y = torch.randn(8, 896) if mode == "cpu_only" else x @ w
                if mode in ("cuda", "cpu_only"):
                    dist.all_reduce(y)
                elif mode == "staged":
                    c = y.cpu()
                    dist.all_reduce(c)
                    y = c.to("cuda", non_blocking=True)
            torch.cuda.synchronize()
            res[mode] = (time.perf_counter() - t0) / 200 * 1e3
    print(json.dumps({"rank": rank, "threads": threads or "default",
                      "ms_per_iteration": res}), flush=True)
    dist.barrier()
    dist.destroy_process_group()


def bucket_worker(rank: int, store: str, n: int, iters: int) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    x = torch.randn(n, device="cuda")
    res = {}
    for mode in ("cuda", "staged"):
        for _ in range(2):               # the first round warms up
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                if mode == "cuda":
                    dist.all_reduce(x)
                else:
                    c = x.cpu()
                    dist.all_reduce(c)
                    x = c.to("cuda")
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / iters * 1e3
            res[mode] = {"ms": ms, "GB_per_s": n * 4 / ms / 1e6}
    print(json.dumps({"rank": rank, "elements": n, "bucket": res}),
          flush=True)
    dist.barrier()
    dist.destroy_process_group()


def main() -> int:
    if sys.argv[1:2] == ["--bucket-worker"]:
        bucket_worker(*(int(a) if i != 1 else a
                        for i, a in enumerate(sys.argv[2:6])))
        return 0
    if sys.argv[1:2] == ["--bucket"]:
        n, iters = int(sys.argv[2]), int(sys.argv[4])
        with tempfile.TemporaryDirectory() as tmp:
            store = os.path.join(tmp, "store")
            procs = [subprocess.Popen([sys.executable, __file__,
                                       "--bucket-worker", str(r), store,
                                       str(n), str(iters)])
                     for r in (0, 1)]
            return 1 if any(p.wait() for p in procs) else 0
    if len(sys.argv) > 1:
        worker(int(sys.argv[1]), sys.argv[2], int(sys.argv[3]))
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        for threads in (0, 1):
            store = os.path.join(tmp, f"store{threads}")
            procs = [subprocess.Popen([sys.executable, __file__, str(r),
                                       store, str(threads)])
                     for r in (0, 1)]
            if any(p.wait() for p in procs):
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
