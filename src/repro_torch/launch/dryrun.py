"""The dry run on the H100's roofline (port of ``repro/launch/dryrun.py``).

    python -m repro_torch.launch.dryrun [--arch A] [--shape S]
        [--multi-pod | --both-meshes] [--attn-impl xla] [--out DIR]

Every (architecture x input shape x mesh) stage program is traced as the
first data row's last model rank of the production mesh (``launch/mesh.
traced_rank``: rank 15 of (16, 16) on 256 ranks or of (2, 16, 16) on
512), the rank whose program sets the step where a long prefill's queries
split over the model axis (``models/layers.seq_parallel``; every other
program's model ranks are alike), on fake tensors and a fake process
group (``utils/cost``): no device and
no memory is needed, and each rank's program is the one the port runs,
on the port's own layouts (``launch/mesh.stage_shardings``): the train
step whole on every rank with its rows split over the data rows, prefill
and decode on the ``tp_plan`` shards of the model axis and their rows of
the batch. The trace gives the rank's FLOPs, bytes, collectives and peak
memory, and the H100's roofline (``utils/roofline``) its predicted step
time and bottleneck. A program whose peak exceeds the card's 80 GB is a
row with ``feasible: false``; only an exception is a failure.

The attention routes are the ones the trainer takes on the card: the
flash kernels for train (the ssm family's update runs its plain chunked
form: the SSD kernel has no backward) and prefill, the decode kernels for
decode; ``--attn-impl xla`` traces the plain routes. Rows go to ``--out``
(``build/dryrun_torch/`` by default), one JSON file each, and a markdown
table of them to ``summary.md`` there.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs.base import ARCH_IDS, INPUT_SHAPES
from repro_torch.core.resharding import MeshConfig, shard_params
from repro_torch.core.train_step import (make_lm_train_step,
                                         make_prefill_step, make_serve_step)
from repro_torch.launch.mesh import (_batch_spec, input_specs,
                                     make_production_mesh,
                                     production_mesh_config, stage_shardings,
                                     traced_rank)
from repro_torch.models.tensor_parallel import TPContext, update_group
from repro_torch.optim.adamw import adamw
from repro_torch.utils import roofline
from repro_torch.utils.cost import fake_mode, full_cost, trace_device
from repro_torch.utils.tree import tree_flatten_with_names, tree_map

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun_torch"

# The assigned architectures; qwen2.5-72b (the paper's own model) stays
# out of the 40-program matrix, as in JAX.
ASSIGNED_ARCHS = [a for a in ARCH_IDS if a != "qwen2.5-72b"]


def attn_impl_for(kind: str, family: str, attn_impl=None) -> str:
    """The attention route of a stage program: "xla" when asked, else the
    trainer's on the card (flash for train and prefill, the ssm update
    plain, the decode kernels for decode)."""
    if attn_impl == "xla":
        return "xla"
    if kind == "decode":
        return "pallas"
    return "xla" if kind == "train" and family == "ssm" else "flash"


def _fresh(x: torch.Tensor) -> torch.Tensor:
    """A fake tensor of ``x``'s shape with a storage of its own (a shard
    sliced from a global fake would count the global storage)."""
    return torch.empty(x.shape, dtype=x.dtype, device=x.device)


def _local(x: torch.Tensor, layout, rank: int) -> torch.Tensor:
    return _fresh(layout.local_shard(x, rank))


def _cache_departures(cache, layouts, local, rank: int) -> list:
    """Where the engine's per-rank cache (``local``) holds another shape
    than ``cache_shardings`` gives the rank: one entry per leaf."""
    lay = dict(tree_flatten_with_names(layouts))
    have = dict(tree_flatten_with_names(local))
    out = []
    for name, x in tree_flatten_with_names(cache):
        mine = have[name]
        want = tuple(x[lay[name].devices_indices_map(x.shape)[rank]].shape)
        if want != tuple(mine.shape):
            out.append(("cache", f"{name}: the engine holds "
                                 f"{tuple(mine.shape)} a rank, the layout "
                                 f"{want}"))
    return out


def serving_program(model, kind: str, mesh_cfg: MeshConfig, params,
                    tokens, s_max: int, attn_impl: str, plan=None):
    """``(fn, args)``: the prefill (``kind`` "prefill", ``tokens``
    (B, S)) or decode ("decode", ``tokens`` (B,)) step of ``plan``'s rank
    (``traced_rank`` without a plan) on a fresh cache of ``s_max``
    positions, from the global fake ``params`` and ``tokens``: the rank's
    ``plan`` shards (whole params without a plan), its rows of the batch
    (``_batch_spec``), the cache the engine makes for them, and its
    ``TPContext`` (collective: the model-axis groups are made here)."""
    rank = traced_rank(mesh_cfg) if plan is None else plan.rank
    tp = None if plan is None or mesh_cfg.tp == 1 else TPContext(plan)
    if plan is not None:
        params = tree_map(_fresh, dict(shard_params(params, plan, rank)))
    tokens = _local(tokens, _batch_spec(mesh_cfg, tokens.shape), rank)
    kw = {} if tp is None else {"tp": tp}
    cache = model.init_cache(tokens.shape[0], s_max, device=tokens.device,
                             **kw)
    make = make_prefill_step if kind == "prefill" else make_serve_step
    return make(model, attn_impl=attn_impl, tp=tp), (params, tokens, cache)


def prefill_stage(model, batch: int, *, attn_impl: str = "flash",
                  dtype=torch.bfloat16):
    """A ``stage_fn`` for ``core/parallelism_selector.
    make_cost_model_measure``: ``(config, context_len) -> (fn, args)``,
    the prefill of ``batch`` prompts of ``context_len`` tokens on
    ``traced_rank(config)`` (``serving_program`` under ``tp_plan``), on
    fake ``dtype`` params."""
    from repro_torch.core.resharding import tp_plan
    from repro_torch.models.param import abstract_params

    def stage_fn(config: MeshConfig, context_len: int):
        device = trace_device()
        params = abstract_params(model.defs, dtype, device)
        tokens = torch.empty((batch, context_len), dtype=torch.int32,
                             device=device)
        plan = tp_plan(model, config, rank=traced_rank(config))
        return serving_program(model, "prefill", config, params, tokens,
                               context_len, attn_impl, plan)

    return stage_fn


def build_stage(arch_id: str, shape_name: str, mesh_cfg: MeshConfig, *,
                remat=None, microbatch=0, attn_impl=None):
    """``(fn, args, meta)``: the stage program of ``mesh_cfg``'s
    ``traced_rank`` and its local inputs, fake tensors in the active fake
    mode, on a process group that holds ``mesh_cfg``'s ranks, this process
    that rank (collective: the tp and update groups are made here).
    ``meta``: kind, config, model, route, the layouts' ``fallbacks``, the
    rank's param bytes."""
    specs = input_specs(arch_id, shape_name, remat=remat)
    model, kind = specs["model"], specs["kind"]
    cfg = model.cfg
    fallbacks: list = []
    sh = stage_shardings(specs, mesh_cfg, fallbacks=fallbacks)
    rank = traced_rank(mesh_cfg)
    attn = attn_impl_for(kind, cfg.family, attn_impl)
    extra = specs.get("extra")
    ex = (None if not extra else
          {k: _local(v, sh["extra"][k], rank) for k, v in extra.items()})
    if kind == "train":
        params, opt_state = specs["params"], specs["opt_state"]
        tokens = _local(specs["tokens"], sh["tokens"], rank)
        labels = _local(specs["labels"], sh["labels"], rank)
        split = sh["tokens"].shards(0) > 1
        group = update_group(mesh_cfg) if split else None
        step = make_lm_train_step(model, adamw(3e-4), attn_impl=attn,
                                  microbatch=microbatch)
        fn = lambda p, o, t, l, e=None: step(p, o, t, l, extra=e,
                                             group=group)
        args = (params, opt_state, tokens, labels)
    else:
        tok = "tokens" if kind == "prefill" else "token"
        fn, args = serving_program(model, kind, mesh_cfg, specs["params"],
                                   specs[tok], INPUT_SHAPES[shape_name]
                                   .seq_len, attn, sh["plan"])
        params, cache = args[0], args[2]
        fallbacks.extend(_cache_departures(specs["cache"], sh["cache"],
                                           cache, rank))
    if ex is not None:
        args = args + (ex,)
    meta = {"kind": kind, "cfg": cfg, "model": model, "attn_impl": attn,
            "fallbacks": fallbacks,
            "param_bytes": sum(x.numel() * x.element_size()
                               for x in params.values())}
    return fn, args, meta


def model_flops_for(cfg, kind: str, shape) -> float:
    n_active = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch          # decode: 1 tok/row


def run_one(arch_id: str, shape_name: str, *, multi_pod: bool,
            remat=None, microbatch=0, attn_impl=None, verbose=True) -> dict:
    """Trace one (arch, shape, mesh) stage program as the mesh's
    ``traced_rank`` and return its row."""
    mesh_name = "2x16x16" if multi_pod else "16x16"
    mesh_cfg = production_mesh_config(multi_pod=multi_pod)
    make_production_mesh(multi_pod=multi_pod)
    shape = INPUT_SHAPES[shape_name]
    chips = mesh_cfg.n_devices
    name = f"{arch_id}|{shape_name}|{mesh_name}"
    t0 = time.perf_counter()
    with fake_mode():
        fn, args, meta = build_stage(arch_id, shape_name, mesh_cfg,
                                     remat=remat, microbatch=microbatch,
                                     attn_impl=attn_impl)
        fc = full_cost(fn, *args)
    t_trace = time.perf_counter() - t0
    mf = model_flops_for(meta["cfg"], meta["kind"], shape)
    rep = roofline.analyze(
        name, chips=chips,
        cost_analysis={"flops": fc.flops, "bytes accessed": fc.bytes_accessed},
        collective_bytes=fc.collective_bytes, model_flops=mf,
        peak_memory_bytes=fc.peak_bytes)
    row = {
        "arch": arch_id, "shape": shape_name, "mesh": mesh_name,
        "kind": meta["kind"], "chips": chips,
        "attn_impl": meta["attn_impl"],
        "trace_s": round(t_trace, 2),
        "memory": {"argument_bytes": fc.argument_bytes,
                   "peak_bytes": fc.peak_bytes,
                   "allocated_bytes": fc.peak_bytes - fc.argument_bytes,
                   "param_bytes": meta["param_bytes"]},
        "peak_bytes_per_device": fc.peak_bytes,
        "feasible": fc.peak_bytes <= roofline.H100.hbm_bytes,
        "fallbacks": [list(f) for f in meta["fallbacks"]],
        "cost": {"flops": fc.flops, "bytes_accessed": fc.bytes_accessed,
                 "kernels": fc.kernels},
        "collectives": {
            "total_bytes": fc.collective_bytes,
            "by_kind_bytes": fc.collective_by_kind,
            "by_kind_count": fc.collective_counts,
        },
        "roofline": rep.row(),
    }
    if verbose:
        print(f"[OK] {name}  trace {t_trace:.1f}s  "
              f"{'feasible' if row['feasible'] else 'INFEASIBLE'}")
        print(f"     memory: peak {fc.peak_bytes / 2**30:.2f} GiB a rank "
              f"(arguments {fc.argument_bytes / 2**30:.2f} GiB)")
        print(f"     cost: flops={fc.flops:.4g} bytes={fc.bytes_accessed:.4g}"
              f" kernels={fc.kernels}")
        print("     collectives: " + "; ".join(
            f"{k}: {v / 2**20:.1f} MiB" for k, v in
            sorted(fc.collective_by_kind.items())))
        print(f"     roofline (predicted from H100 data-sheet rates): "
              f"compute {rep.compute_s:.4g}s | memory {rep.memory_s:.4g}s |"
              f" collective {rep.collective_s:.4g}s -> {rep.bottleneck}-"
              f"bound, useful-FLOP ratio {rep.useful_flops_ratio:.3f}")
    return row


def summary_table(rows) -> str:
    """A markdown table of dry-run rows, one line per (arch, shape) with
    each mesh's per-rank peak (GB), feasibility, bottleneck, predicted
    step time (from the H100's data-sheet rates), useful-FLOP ratio and
    trace seconds."""
    meshes = sorted({r["mesh"] for r in rows}, key=len)
    by = {(r["arch"], r["shape"], r["mesh"]): r for r in rows}
    head = ["arch", "shape", "kind"]
    for m in meshes:
        head += [f"{m} {c}" for c in ("peak GB", "fits", "bound by",
                                      "predicted s", "useful", "trace s")]
    lines = ["| " + " | ".join(head) + " |",
             "|" + "|".join("---" for _ in head) + "|"]
    for arch, shape in dict.fromkeys((r["arch"], r["shape"]) for r in rows):
        cells = [arch, shape, next(r["kind"] for k, r in by.items()
                                   if k[:2] == (arch, shape))]
        for m in meshes:
            r = by.get((arch, shape, m))
            if r is None:
                cells += [""] * 6
                continue
            rl = r["roofline"]
            cells += [f"{r['peak_bytes_per_device'] / 1e9:.2f}",
                      "yes" if r["feasible"] else "no", rl["bottleneck"],
                      f"{rl['step_time_s']:.4g}",
                      f"{rl['useful_flops_ratio']:.3f}", f"{r['trace_s']}"]
        lines.append("| " + " | ".join(cells) + " |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="EARL dry run of the port on fake tensors and the H100's"
                    " roofline")
    ap.add_argument("--arch", default=None,
                    help="single arch id (default: all)")
    ap.add_argument("--shape", default=None,
                    help="single shape (default: all)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="use the 2x16x16 512-rank mesh")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true",
                    help="JAX's flag; refused: the port shards no param over"
                         " the data axis")
    ap.add_argument("--remat", default=None, choices=["none", "full"])
    ap.add_argument("--microbatch", type=int, default=0,
                    help="gradient-accumulation slices for train shapes")
    ap.add_argument("--attn-impl", default=None, choices=["xla"],
                    help="trace the plain attention routes")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)
    if args.no_fsdp:
        ap.error("--no-fsdp: the port shards no param over the data axis, "
                 "so there is no FSDP layout to turn off")

    archs = [args.arch] if args.arch else ASSIGNED_ARCHS
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    n_ok = n_fail = 0
    rows = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}_{shape}_{'2x16x16' if mp else '16x16'}"
                try:
                    row = run_one(arch, shape, multi_pod=mp,
                                  remat=args.remat,
                                  microbatch=args.microbatch,
                                  attn_impl=args.attn_impl)
                    (outdir / f"{tag}.json").write_text(json.dumps(row,
                                                                   indent=1))
                    rows.append(row)
                    n_ok += 1
                except Exception:
                    n_fail += 1
                    print(f"[FAIL] {tag}")
                    traceback.print_exc()
    if rows:
        table = summary_table(rows)
        (outdir / "summary.md").write_text(table + "\n")
        print("\n" + table)
    print(f"\ndry-run complete: {n_ok} ok, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
