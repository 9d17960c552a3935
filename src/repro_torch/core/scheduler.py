"""Pipeline schedule over the EARL stage graph (port of
``repro/core/scheduler.py``), sync mode: Rollout → ExpPrep → Dispatch →
Update, strictly ordered, one step at a time. A failed step raises. The
async mode, step retries and checkpointing arrive with ROADMAP Queue 1
item 8.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from repro_torch.rl.engine.compiled import _unported


def _print_record(rec) -> None:
    print(f"step {rec.step:4d}  return {rec.mean_return:+.3f}  "
          f"ctx {rec.mean_context_len:6.1f}  "
          f"trunc {rec.truncated_frac:.2f}  "
          f"loss {rec.loss:+.4f}  lag {rec.policy_lag}", flush=True)


@dataclass
class PipelineSchedule:
    """Runs the trainer's stage graph under the sync schedule."""

    trainer: Any                      # EarlTrainer (stage container)
    mode: str = "sync"

    def __post_init__(self):
        if self.mode == "async":
            raise _unported("the async pipeline schedule", "8")
        if self.mode != "sync":
            raise ValueError(f"unknown pipeline mode {self.mode!r}")

    def run(self, n_steps: int, *, params, opt_state, ref_params=None,
            dst_shardings=None, verbose: bool = False):
        """Execute ``n_steps`` sync iterations. Returns ``(params,
        opt_state, history)``."""
        tr = self.trainer
        for step in range(n_steps):
            params, opt_state, rec = tr.run_step(
                step, params, opt_state, ref_params,
                dst_shardings=dst_shardings)
            if verbose:
                _print_record(rec)
        return params, opt_state, tr.history
