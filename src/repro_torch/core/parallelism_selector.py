"""Parallelism Selector (port of ``repro/core/parallelism_selector.py``;
paper §2, Fig. 2 ①②).

The best parallelism layout for the Rollout and Experience-Preparation
stages depends on the current context length, which grows during agentic
RL training (paper Fig. 1). The selector:

  1. **profiles** at the start of training: for each candidate
     ``MeshConfig`` x context-length bucket, ``measure_fn`` scores tokens
     per device per second (TGS) and feasibility (out of memory or not),
     and the best feasible config of each bucket goes into the policy
     table;
  2. **monitors** the running (EMA) context length during training;
  3. **switches** a stage's config before it launches whenever the EMA
     enters a bucket whose best config differs (hook ① before Rollout,
     hook ② before the update).

The selector holds one current config per stage (``current_for("rollout")``
/ ``current_for("update")``): the async schedule overlaps Rollout(k+1)
with Update(k), and one stage's switch must not move the other's.
``current`` stays the rollout stage's config.

``measure_fn`` is any ``(config, context_len) -> ProfileEntry``: a wall-
clock timing on the devices, or a model. JAX's cost-model measure reads
XLA's compiled HLO and moves with the HLO tooling (ROADMAP Queue 1 item
12). ``device_memory_bytes`` gives the feasibility budget a measure
compares its peak memory against.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.resharding import MeshConfig

# NVIDIA H100 80 GB: the published memory size, the budget where no card
# can be asked (device_memory_bytes)
H100_HBM_BYTES = 80 * 10**9


def device_memory_bytes(device=None) -> int:
    """Device memory of ``device``: the card's own total on CUDA, else the
    H100 80 GB's published size."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and torch.cuda.is_available():
        return torch.cuda.get_device_properties(dev).total_memory
    return H100_HBM_BYTES


@dataclass(frozen=True)
class ContextBuckets:
    """Half-open context-length ranges [0,b0), [b0,b1), ..., [b_last, inf)."""

    boundaries: Tuple[int, ...] = (4096, 8192, 16384, 32768)

    def bucket(self, context_len: float) -> int:
        return bisect.bisect_right(self.boundaries, context_len)

    @property
    def n_buckets(self) -> int:
        return len(self.boundaries) + 1

    def representative(self, idx: int) -> int:
        """Context length used to profile bucket ``idx`` (its upper edge;
        the last bucket profiles at 2x the final boundary)."""
        if idx < len(self.boundaries):
            return self.boundaries[idx]
        return self.boundaries[-1] * 2

    def label(self, idx: int) -> str:
        lo = 0 if idx == 0 else self.boundaries[idx - 1]
        hi = "inf" if idx == len(self.boundaries) else self.boundaries[idx]
        return f"[{lo},{hi})"


@dataclass
class ProfileEntry:
    config: MeshConfig
    context_len: int
    tgs: float                  # tokens / device / second
    feasible: bool              # False = out of memory
    peak_bytes: float = 0.0
    step_time_s: float = 0.0


@dataclass
class SelectorPolicy:
    """The profiling result: per-bucket best config + the full score grid."""

    buckets: ContextBuckets
    table: Dict[int, MeshConfig]                 # bucket -> best config
    entries: List[ProfileEntry] = field(default_factory=list)

    def best(self, context_len: float) -> MeshConfig:
        return self.table[self.buckets.bucket(context_len)]

    def grid(self) -> Dict[Tuple[str, int], ProfileEntry]:
        return {(e.config.name, e.context_len): e for e in self.entries}

    def speedup_pct(self, a: str, b: str, context_len: int) -> float:
        """Paper Eq. 1: relative TGS speedup switching config a -> b."""
        g = self.grid()
        ea, eb = g[(a, context_len)], g[(b, context_len)]
        if not ea.feasible:
            return float("inf") if eb.feasible else float("nan")
        if not eb.feasible:
            return float("-inf")
        return (eb.tgs - ea.tgs) / ea.tgs * 100.0


# measure_fn(config, context_len) -> ProfileEntry
MeasureFn = Callable[[MeshConfig, int], ProfileEntry]


class ParallelismSelector:
    """Runtime half: EMA context monitor + bucket-crossing switch logic."""

    #: stages that hold an independent current config
    STAGES = ("rollout", "update")

    def __init__(self, candidates: Sequence[MeshConfig],
                 measure_fn: MeasureFn,
                 buckets: Optional[ContextBuckets] = None,
                 *, ema_alpha: float = 0.5):
        if not candidates:
            raise ValueError("need at least one candidate MeshConfig")
        self.candidates = list(candidates)
        self.measure_fn = measure_fn
        self.buckets = buckets or ContextBuckets()
        self.ema_alpha = ema_alpha
        self.policy: Optional[SelectorPolicy] = None
        self._ema: Optional[float] = None
        self._current: Dict[str, MeshConfig] = {}
        self.switch_log: List[dict] = []

    # -- profiling pass (paper: "at the start of the training process") ----
    def profile(self) -> SelectorPolicy:
        entries: List[ProfileEntry] = []
        table: Dict[int, MeshConfig] = {}
        for b in range(self.buckets.n_buckets):
            ctx = self.buckets.representative(b)
            best: Optional[ProfileEntry] = None
            for cfg in self.candidates:
                e = self.measure_fn(cfg, ctx)
                entries.append(e)
                if not e.feasible:
                    continue
                if best is None or e.tgs > best.tgs:
                    best = e
            if best is None:
                raise RuntimeError(
                    f"no feasible parallelism config for context bucket "
                    f"{self.buckets.label(b)} (all candidates OOM)")
            table[b] = best.config
        self.policy = SelectorPolicy(self.buckets, table, entries)
        self._current = {s: self.policy.table[0] for s in self.STAGES}
        return self.policy

    # -- runtime monitor ----------------------------------------------------
    @property
    def current(self) -> MeshConfig:
        """The Rollout stage's current config (single-stage API)."""
        return self.current_for("rollout")

    def current_for(self, stage: str) -> MeshConfig:
        if not self._current:
            raise RuntimeError("profile() first")
        if stage not in self._current:
            raise KeyError(f"unknown stage {stage!r}, not one of "
                           f"{tuple(self._current)}")
        return self._current[stage]

    @property
    def ema_context(self) -> float:
        return self._ema if self._ema is not None else 0.0

    def observe(self, mean_context_len: float) -> None:
        """Feed the averaged context length of the last Rollout stage."""
        if self._ema is None:
            self._ema = float(mean_context_len)
        else:
            a = self.ema_alpha
            self._ema = a * float(mean_context_len) + (1 - a) * self._ema

    def maybe_switch(self, step: int = -1, stage: str = "rollout"
                     ) -> Optional[Tuple[MeshConfig, MeshConfig]]:
        """Hook ① / ②: called before a stage launches. If the EMA context
        length has entered a bucket whose best config differs from the
        stage's current one, switch that stage's config and return (old,
        new); else None. Other stages keep their config."""
        if self.policy is None:
            raise RuntimeError("profile() first")
        if self._ema is None:
            return None
        target = self.policy.best(self._ema)
        if target == self._current[stage]:
            return None
        old = self._current[stage]
        self._current[stage] = target
        self.switch_log.append({
            "step": step,
            "stage": stage,
            "ema_context": self._ema,
            "bucket": self.buckets.label(self.buckets.bucket(self._ema)),
            "from": old.name,
            "to": target.name,
        })
        return old, target
