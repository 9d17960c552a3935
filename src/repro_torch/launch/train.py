"""End-to-end agentic RL training entry point of the port (the paper's
Fig. 2 loop, sync or async schedule).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch qwen2-0.5b --env tictactoe --steps 50 --batch 16

Takes the flags of ``repro.launch.train`` plus ``--attn-impl`` and
``--device``. Unlike the JAX CLI, the defaults are the port's
production path: the full config (``--smoke`` selects the reduced one),
the compiled engine on the paged pool with fused sampling and the
reference pass folded into the rollout, every kernel on the GPU
(``--device cpu`` runs the plain versions on the CPU).
``--cache-layout`` and ``--sampling`` default to the backend's own:
paged and fused for ``--rollout-backend compiled``, dense and reference
for ``python``. ``--env`` takes tictactoe, connect_four or bandit (the
bandit with JAX's CLI defaults: no prompt run). The paged pool's options
reach the trainer: ``--kv-dtype int8``, ``--share-prefix`` with
``--prefix-len``, ``--on-exhaust preempt``, ``--pool-growth double`` with
``--pool-growth-max``. ``--pipeline async`` overlaps the update with the
next rollout under ``--max-policy-lag`` (1) and arms the truncated-IS
cap ``--is-rho-max`` (2.0) when the lag is above 0. ``--max-retries``
with ``--retry-backoff``, ``--checkpoint-dir`` with
``--checkpoint-every``, ``--resume``, ``--inject-fault SITE@STEP[*TIMES]``
and ``--inject-pool-pressure`` are those of the JAX CLI, and so is
``--dispatch {direct,centralized}``, the data dispatcher's strategy
(default direct; as in JAX, the CLI requests no destination layouts, so on
one device the dispatch stage hands the batch on as it is). ``--arch`` takes every
architecture of the JAX package. ``mamba2-370m`` trains the ssm family
(Mamba2) on its recurrent cache: the layout defaults to dense there and
``--cache-layout paged`` raises; ExpPrep's standalone pass runs the SSD
scan kernel and the update its plain chunked form, as JAX's. The moe
(``granite-moe-3b-a800m``, ``grok-1-314b``) and hybrid (``zamba2-1.2b``)
families also decode on their own dense caches; the update adds the
router's aux loss for moe. ``whisper-large-v3`` and
``llama-3.2-vision-11b`` build, and the trainer refuses them with a
``ValueError``: the rollout engine carries no modality inputs, as in the
JAX package (train and serve them through ``core/train_step.py``'s steps,
as ``examples/torch_serve_batched.py`` does).
``--speculation self --spec-k K --draft-layers L`` runs
speculative decoding (paged layout, reference sampling); as in JAX, the
CLI builds no draft model, so ``--speculation draft`` raises. Writes the
same JSONL rows as the JAX CLI, ``spec_proposed``, ``spec_accepted`` and
``spec_rounds`` among them.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from repro_torch.configs.base import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.stages import EarlTrainer
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import adamw
from repro_torch.rl.envs import make_env
from repro_torch.utils.faults import FaultInjector


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="EARL agentic RL training "
                                             "(PyTorch/CUDA port)")
    ap.add_argument("--arch", default="qwen2-0.5b", choices=ARCH_IDS)
    ap.add_argument("--env", default="tictactoe",
                    choices=["tictactoe", "connect_four", "bandit"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--rollout-backend", default="compiled",
                    choices=["python", "compiled"])
    ap.add_argument("--rollout-episodes", type=int, default=None,
                    help="episodes per rollout (> batch keeps slots full "
                         "via slot refill)")
    ap.add_argument("--cache-layout", default=None,
                    choices=["dense", "paged"],
                    help="default: paged (compiled, dense family), "
                         "dense (python, and the ssm family)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--cache-pages", type=int, default=None,
                    help="pool size in pages (default: full provisioning)")
    ap.add_argument("--share-prefix", action="store_true")
    ap.add_argument("--prefix-len", type=int, default=None,
                    help="shared-prompt length in tokens (default: the "
                         "env's prompt_prefix_len; full pages are shared)")
    ap.add_argument("--on-exhaust", default="count",
                    choices=["count", "raise", "preempt"])
    ap.add_argument("--pool-growth", default="off",
                    choices=["off", "double"])
    ap.add_argument("--pool-growth-max", type=int, default=None,
                    help="pool growth cap in pages (default: full "
                         "per-slot provisioning)")
    ap.add_argument("--kv-dtype", default="bf16",
                    choices=["fp32", "bf16", "int8"])
    ap.add_argument("--sampling", default=None,
                    choices=["reference", "fused"],
                    help="default: fused (compiled), reference (python)")
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--speculation", default="off",
                    choices=["off", "self", "draft"],
                    help="speculative decoding (paged layout): self = the "
                         "policy's first --draft-layers layers draft; the "
                         "committed tokens are the ones off commits")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="chunk length: 1 exact token + up to spec-k - 1 "
                         "draft proposals verified per round")
    ap.add_argument("--draft-layers", type=int, default=None,
                    help="speculation=self: layers of the draft (default "
                         "n_layers // 2)")
    ap.add_argument("--pipeline", default="sync", choices=["sync", "async"],
                    help="async = overlap Rollout(k+1) with Update(k) (the "
                         "update on a worker thread and its own CUDA "
                         "stream), bounded by --max-policy-lag")
    ap.add_argument("--max-policy-lag", type=int, default=1,
                    help="async: max params-version staleness of rollout "
                         "experience (0 = the sync order)")
    ap.add_argument("--is-rho-max", type=float, default=2.0,
                    help="truncated importance-sampling cap for lagged "
                         "experience (async with lag > 0 only; 0 = off)")
    ap.add_argument("--max-turns", type=int, default=3)
    ap.add_argument("--max-turn-tokens", type=int, default=6)
    ap.add_argument("--max-context", type=int, default=160)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--kl-coef", type=float, default=0.05)
    ap.add_argument("--clip-eps", type=float, default=0.2)
    ap.add_argument("--advantage", default="reinforce",
                    choices=["reinforce", "group"])
    ap.add_argument("--dispatch", default="direct",
                    choices=["direct", "centralized"],
                    help="data dispatcher strategy between the stages' "
                         "layouts")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="directory for periodic {params, opt_state, rng} "
                         "checkpoints")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="save every N completed steps (0 = off)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in "
                         "--checkpoint-dir when there is one")
    ap.add_argument("--max-retries", type=int, default=0,
                    help="step retries (sync) / checkpoint restarts (async)")
    ap.add_argument("--retry-backoff", type=float, default=0.05,
                    help="base retry backoff in seconds (doubles per "
                         "attempt)")
    ap.add_argument("--inject-fault", action="append", default=None,
                    metavar="SITE@STEP[*TIMES]",
                    help="raise at a stage boundary, e.g. 'update@3' or "
                         "'rollout@1*2' (sites: rollout, dispatch, update; "
                         "repeatable)")
    ap.add_argument("--inject-pool-pressure", type=float, default=0.0,
                    help="undersize the paged pool to this fraction of its "
                         "exhaustion-free size (0 = off)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log", default="train_log.jsonl")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-sized)")
    ap.add_argument("--attn-impl", default="paged", choices=["paged", "xla"],
                    help="paged = the kernels (paged or dense decode "
                         "attention and fused sampling in the rollout, "
                         "flash attention in Update; ssm: fused sampling "
                         "and the SSD scan in ExpPrep's standalone pass; "
                         "moe and hybrid: decode attention, fused sampling "
                         "and flash attention at their attention layers); "
                         "xla = the plain paths")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "kernels' plain versions)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    trainer = EarlTrainer(
        model=build_model(cfg), env=make_env(args.env),
        optimizer=adamw(args.lr, weight_decay=0.0),
        batch_size=args.batch, max_turns=args.max_turns,
        max_turn_tokens=args.max_turn_tokens, max_context=args.max_context,
        kl_coef=args.kl_coef, clip_eps=args.clip_eps,
        advantage=args.advantage, dispatch_strategy=args.dispatch,
        rollout_backend=args.rollout_backend,
        rollout_episodes=args.rollout_episodes,
        cache_layout=args.cache_layout, page_size=args.page_size,
        cache_pages=args.cache_pages, share_prefix=args.share_prefix,
        prefix_len=args.prefix_len, on_exhaust=args.on_exhaust,
        pool_growth=args.pool_growth, pool_growth_max=args.pool_growth_max,
        kv_dtype=args.kv_dtype, sampling=args.sampling, top_p=args.top_p,
        speculation=args.speculation, spec_k=args.spec_k,
        draft_layers=args.draft_layers, pipeline=args.pipeline,
        max_policy_lag=args.max_policy_lag, max_retries=args.max_retries,
        retry_backoff_s=args.retry_backoff,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every, resume=args.resume,
        faults=(FaultInjector.parse(args.inject_fault,
                                    args.inject_pool_pressure)
                if args.inject_fault or args.inject_pool_pressure > 0
                else None),
        # lag-0 experience is on-policy: the correction there would only
        # add rounding noise and break lag 0's equality with sync
        is_rho_max=(args.is_rho_max if args.pipeline == "async"
                    and args.max_policy_lag > 0 else 0.0),
        seed=args.seed, attn_impl=args.attn_impl, device=args.device)

    t0 = time.time()
    _, _, history = trainer.train(args.steps, verbose=True)
    wall = time.time() - t0

    log_path = Path(args.log)
    log_path.parent.mkdir(parents=True, exist_ok=True)
    with log_path.open("w") as f:
        for rec in history:
            row = {
                "step": rec.step,
                "return": rec.mean_return,
                "context_len": rec.mean_context_len,
                "turn_len": rec.mean_turn_len,
                "truncated_frac": rec.truncated_frac,
                "loss": rec.loss,
                "kl": rec.kl,
                "wall_s": rec.wall_time_s,
                "params_version": rec.params_version,
                "policy_lag": rec.policy_lag,
                "is_weight_mean": rec.is_weight_mean,
                "pages_in_use": rec.pages_in_use,
                "page_capacity": rec.page_capacity,
                "kv_dropped_writes": rec.kv_dropped_writes,
                "preemptions": rec.preemptions,
                "requeue_depth": rec.requeue_depth,
                "pool_grows": rec.pool_grows,
                "spec_proposed": rec.spec_proposed,
                "spec_accepted": rec.spec_accepted,
                "spec_rounds": rec.spec_rounds,
            }
            f.write(json.dumps(row) + "\n")
    print(f"done: {args.steps} steps in {wall:.1f}s "
          f"({args.steps / max(wall, 1e-9):.2f} steps/s, "
          f"pipeline={args.pipeline}) -> {log_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
