"""End-to-end agentic RL on the PyTorch port: train a policy on
Tic-Tac-Toe through the full EARL Fig. 2 loop (rollout -> experience prep
-> dispatch -> update), with the Parallelism Selector monitoring context
growth (the twin of ``examples/train_tictactoe.py``).

With the defaults (one action token per turn) the mean return improves
slowly from the random/illegal floor; multi-token "reasoning" turns
(--turn-tokens 5) need proportionally more steps for the same gain.

    PYTHONPATH=src python examples/torch_train_tictactoe.py [--steps 200] \
        [--device cpu]

Runs on the GPU unless ``--device cpu`` is given (the kernels then use
their plain PyTorch versions).
"""
import argparse

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.core.parallelism_selector import (ContextBuckets,
                                                   ParallelismSelector,
                                                   ProfileEntry)
from repro_torch.core.resharding import MeshConfig
from repro_torch.core.stages import EarlTrainer
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import adamw
from repro_torch.rl.envs import TicTacToe


def make_selector(switch_at: int = 96):
    """Single-device run: the selector's mechanics (profile, monitor,
    switch) are exercised with two degenerate one-device configs; across
    ranks the candidates are true (dp, tp) splits (see launch/mesh.py and
    the tensor-parallel rollout of rl/engine/compiled.py). The long-context
    config wins above ``switch_at`` tokens."""
    short = MeshConfig("short-ctx", dp=1, tp=1)
    long_ = MeshConfig("long-ctx", dp=1, tp=1, fsdp=False)
    measure = lambda cfg, ctx: ProfileEntry(
        cfg, ctx, tgs=(2.0 if (cfg.name == "long-ctx") == (ctx > switch_at)
                       else 1.0),
        feasible=True)
    return ParallelismSelector([short, long_], measure,
                               ContextBuckets((switch_at,)), ema_alpha=0.3)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--turn-tokens", type=int, default=1,
                    help=">1 adds free-form reasoning tokens per turn")
    ap.add_argument("--rollout-backend", default="python",
                    choices=["python", "compiled"],
                    help="compiled = the slot-based rollout engine")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--switch-at", type=int, default=96,
                    help="context length where the selector's long-context "
                         "config takes over")
    args = ap.parse_args(argv)

    cfg = get_smoke_config("qwen2-0.5b")
    model = build_model(cfg)
    env = TicTacToe()
    sel = make_selector(args.switch_at)
    sel.profile()

    trainer = EarlTrainer(
        model=model, env=env, selector=sel,
        optimizer=adamw(3e-3, weight_decay=0.0),
        batch_size=args.batch, max_turns=5,
        max_turn_tokens=args.turn_tokens,
        max_context=160, kl_coef=0.02, advantage="reinforce",
        rollout_backend=args.rollout_backend, seed=0, device=args.device)
    params, opt_state, ref_params = trainer.init_state()

    window = []
    for step in range(args.steps):
        params, opt_state, rec = trainer.run_step(step, params, opt_state,
                                                  ref_params)
        window.append(rec.mean_return)
        if step % args.log_every == 0:
            avg = float(np.mean(window[-20:]))
            sw = f" [switch {rec.selector_switch}]" if rec.selector_switch \
                else ""
            print(f"step {step:4d}  return(avg20) {avg:+.3f}  "
                  f"ctx {rec.mean_context_len:6.1f}  "
                  f"trunc {rec.truncated_frac:.2f}  loss {rec.loss:+.4f}"
                  f"{sw}")
    first = float(np.mean(window[:20]))
    last = float(np.mean(window[-20:]))
    print(f"\nmean return: first-20 {first:+.3f} -> last-20 {last:+.3f}")
    print(f"selector observed EMA context {sel.ema_context:.1f}, "
          f"switches: {sel.switch_log}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
