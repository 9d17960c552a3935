"""EARL Data Dispatcher demo on the PyTorch port: move an experience batch
from the rollout layout to the update layout, centralized against direct,
on gloo ranks of this host (the twin of ``examples/dispatch_demo.py``).

Shows the paper's Fig. 4 effect structurally: the single-controller path
funnels the whole batch through one rank; the layout-aware exchange moves
only the shards that change owner.

    PYTHONPATH=src python examples/torch_dispatch_demo.py [--ranks 16]

Starts ``--ranks`` processes (16 by default, as JAX's 16 host devices),
which meet through a file store in a temporary directory. The rollout
layout is dp=R, the update layout dp=R/4 x tp=4. Each report gives the
estimated time at the paper's 25 Gbps Ethernet and at NVLink on an H100
SXM, where JAX's gives its own interconnect's.
"""
import argparse
import os
import subprocess
import sys
import tempfile


def rank_main(rank: int, world: int, store: str, batch: int, seq: int):
    import torch
    import torch.distributed as dist

    from repro_torch.core.data_dispatcher import DataDispatcher
    from repro_torch.core.resharding import MeshConfig, NamedLayout
    from repro_torch.rl.experience import (ExperienceBatch,
                                           zeros_like_experience)

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    # rollout stage: R-way data parallel; update stage: dp=R/4 x tp=4
    rollout = MeshConfig(f"rollout_dp{world}", dp=world, tp=1)
    update = MeshConfig(f"update_dp{world // 4}tp4", dp=world // 4, tp=4)
    exp = zeros_like_experience(batch=batch, seq=seq)
    spec = lambda x: ("data",) + (None,) * (x.dim() - 1)
    src = ExperienceBatch(*(NamedLayout(rollout, spec(x)) for x in exp))
    dst = ExperienceBatch(*(NamedLayout(update, spec(x)) for x in exp))
    if rank == 0:
        print(f"experience batch: {exp.nbytes() / 2**20:.1f} MiB "
              f"({len(exp)} tensors), {world} ranks", flush=True)
    d = DataDispatcher()
    for strategy in ("centralized", "direct"):
        placed = ExperienceBatch(*(lay.local_shard(x)
                                   for lay, x in zip(src, exp)))
        dist.barrier()
        _, rep = d.dispatch(placed, dst, strategy=strategy,
                            src_shardings=src)
        if rank == 0:
            print(f"\n[{strategy}]")
            print(f"  wall time          {rep.wall_time_s * 1e3:9.2f} ms")
            print(f"  bytes moved        {rep.moved_bytes / 2**20:9.2f} MiB")
            print(f"  bottleneck rank    "
                  f"{rep.bottleneck_bytes / 2**20:9.2f} MiB")
            print(f"  est. 25 Gbps       "
                  f"{rep.est_latency_ethernet_s * 1e3:9.2f} ms")
            print(f"  est_latency_nvlink_s "
                  f"{rep.est_latency_nvlink_s * 1e6:7.2f} us", flush=True)
    if rank == 0:
        c, e = d.log[0], d.log[1]
        print(f"\nEARL bottleneck-bytes reduction: "
              f"{c.bottleneck_bytes / max(e.bottleneck_bytes, 1):.1f}x "
              f"(paper Fig. 4: 9.7-11.2x wall-clock at 128 GPUs)",
              flush=True)
    dist.barrier()
    dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=16,
                    help="gloo ranks (a multiple of 4)")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seq", type=int, default=8192)
    ap.add_argument("--rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.ranks % 4 or args.batch % args.ranks:
        ap.error("--ranks must be a multiple of 4 that divides --batch")
    if args.rank is not None:
        rank_main(args.rank, args.ranks, args.store, args.batch, args.seq)
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        base = [sys.executable, os.path.abspath(__file__), "--ranks",
                str(args.ranks), "--batch", str(args.batch), "--seq",
                str(args.seq), "--store", store]
        env = dict(os.environ, OMP_NUM_THREADS="1")
        procs = [subprocess.Popen(base + ["--rank", str(r)], env=env,
                                  stdout=None if r == 0
                                  else subprocess.DEVNULL)
                 for r in range(args.ranks)]
        codes = [p.wait() for p in procs]
    bad = [r for r, c in enumerate(codes) if c]
    if bad:
        print(f"ranks {bad} failed", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
