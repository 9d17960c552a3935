"""End-to-end agentic RL training entry point of the port (the paper's
Fig. 2 loop, sync schedule).

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
for ``python``. Flags
of features not ported yet raise ``NotImplementedError`` naming their
ROADMAP item, and so does any value given to a flag that only those
features read (``--prefix-len``, ``--pool-growth-max``,
``--max-policy-lag``, ``--is-rho-max``, ``--retry-backoff``,
``--dispatch``). ``--arch mamba2-370m`` trains the ssm family (Mamba2)
on its recurrent cache: the layout defaults to dense there and
``--cache-layout paged`` raises; ExpPrep's standalone pass runs the SSD
scan kernel and the update its plain chunked form, as JAX's.
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
from repro_torch.rl.engine.compiled import _unported
from repro_torch.rl.envs import TicTacToe


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
    ap.add_argument("--prefix-len", type=int, default=None)  # unported
    ap.add_argument("--on-exhaust", default="count",
                    choices=["count", "raise", "preempt"])
    ap.add_argument("--pool-growth", default="off",
                    choices=["off", "double"])
    ap.add_argument("--pool-growth-max", type=int, default=None)  # unported
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
    ap.add_argument("--pipeline", default="sync", choices=["sync", "async"])
    ap.add_argument("--max-policy-lag", type=int, default=None)  # unported
    ap.add_argument("--is-rho-max", type=float, default=None)  # unported
    ap.add_argument("--max-turns", type=int, default=3)
    ap.add_argument("--max-turn-tokens", type=int, default=6)
    ap.add_argument("--max-context", type=int, default=160)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--kl-coef", type=float, default=0.05)
    ap.add_argument("--clip-eps", type=float, default=0.2)
    ap.add_argument("--advantage", default="reinforce",
                    choices=["reinforce", "group"])
    ap.add_argument("--dispatch", default=None,  # unported
                    choices=["direct", "centralized"])
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--max-retries", type=int, default=0)
    ap.add_argument("--retry-backoff", type=float, default=None)  # unported
    ap.add_argument("--inject-fault", action="append", default=None,
                    metavar="SITE@STEP[*TIMES]")
    ap.add_argument("--inject-pool-pressure", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log", default="train_log.jsonl")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-sized)")
    ap.add_argument("--attn-impl", default="paged", choices=["paged", "xla"],
                    help="paged = the kernels (paged or dense decode "
                         "attention and fused sampling in the rollout, "
                         "flash attention in Update; ssm: fused sampling "
                         "and the SSD scan in ExpPrep's standalone pass); "
                         "xla = the plain paths")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "kernels' plain versions)")
    return ap.parse_args(argv)


# flags read only by unported features: (flag, ROADMAP Queue 1 item)
_UNPORTED_FLAGS = (("prefix_len", "8"), ("pool_growth_max", "8"),
                   ("max_policy_lag", "8"), ("is_rho_max", "8"),
                   ("retry_backoff", "8"), ("dispatch", "9"))


def main(argv=None):
    args = parse_args(argv)
    if args.env != "tictactoe":
        raise _unported(f"env {args.env!r}", "5")
    if args.inject_fault or args.inject_pool_pressure > 0:
        raise _unported("fault injection", "8")
    for name, item in _UNPORTED_FLAGS:
        if getattr(args, name) is not None:
            raise _unported(f"--{name.replace('_', '-')}", item)
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    trainer = EarlTrainer(
        model=build_model(cfg), env=TicTacToe(),
        optimizer=adamw(args.lr, weight_decay=0.0),
        batch_size=args.batch, max_turns=args.max_turns,
        max_turn_tokens=args.max_turn_tokens, max_context=args.max_context,
        kl_coef=args.kl_coef, clip_eps=args.clip_eps,
        advantage=args.advantage, rollout_backend=args.rollout_backend,
        rollout_episodes=args.rollout_episodes,
        cache_layout=args.cache_layout, page_size=args.page_size,
        cache_pages=args.cache_pages, share_prefix=args.share_prefix,
        on_exhaust=args.on_exhaust, pool_growth=args.pool_growth,
        kv_dtype=args.kv_dtype, sampling=args.sampling, top_p=args.top_p,
        speculation=args.speculation, spec_k=args.spec_k,
        draft_layers=args.draft_layers, pipeline=args.pipeline,
        max_retries=args.max_retries,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every, resume=args.resume,
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
