"""Deterministic fault injection for robustness testing (port of
``repro/utils/faults.py``, plain Python in both packages).

A spec names the stage site and the step at which an exception fires, so
the recovery paths (``on_exhaust="preempt"``, and the retries, checkpoints
and restarts of ``core/scheduler.PipelineSchedule``) can be tested without
timing games. ``pool_pressure`` shrinks the paged pool to a fraction of its
exhaustion-free size so the preemption governor engages.

Spec grammar (one string per fault)::

    "<site>@<step>"            fire once at that pipeline step
    "<site>@<step>*<times>"    fire on <times> consecutive hits

Sites are the stage boundaries the trainer and the schedule check:
``rollout``, ``dispatch``, ``update``. An ``update`` fault under
``pipeline="async"`` fires inside the worker thread: the injected worker
crash of the recovery tests. Every firing raises ``FaultInjected`` (a
``RuntimeError``) and is counted.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union


class FaultInjected(RuntimeError):
    """Raised by ``FaultInjector.check`` at an armed (site, step)."""


@dataclass
class FaultSpec:
    site: str          # "rollout" | "dispatch" | "update"
    step: int          # pipeline step index the fault arms at
    times: int = 1     # consecutive hits that raise (then the spec is spent)
    fired: int = 0     # firings so far (mutated by check)

    @classmethod
    def parse(cls, text: str) -> "FaultSpec":
        try:
            site, rest = text.split("@", 1)
            times = 1
            if "*" in rest:
                rest, times_s = rest.split("*", 1)
                times = int(times_s)
            site = site.strip()
            if not site:
                raise ValueError("empty site")
            return cls(site=site, step=int(rest), times=times)
        except (ValueError, AttributeError):
            raise ValueError(
                f"bad fault spec {text!r} (expected 'site@step' or "
                f"'site@step*times', e.g. 'update@3' or 'rollout@1*2')"
            ) from None


KNOWN_SITES = ("rollout", "dispatch", "update")


@dataclass
class FaultInjector:
    """Armed fault specs and a pool-pressure knob. ``check(site, step)``
    raises ``FaultInjected`` when a matching spec is armed and not spent;
    ``pool_pressure`` (0 disables) asks ``EarlTrainer`` to undersize the
    paged pool to that fraction of its exhaustion-free size."""

    specs: List[FaultSpec] = field(default_factory=list)
    pool_pressure: float = 0.0
    counts: Dict[str, int] = field(default_factory=dict)

    @classmethod
    def parse(cls, exprs: Union[str, Sequence[str], None],
              pool_pressure: float = 0.0) -> "FaultInjector":
        if exprs is None:
            exprs = []
        if isinstance(exprs, str):
            exprs = [exprs]
        specs = [FaultSpec.parse(e) for e in exprs]
        for s in specs:
            if s.site not in KNOWN_SITES:
                raise ValueError(f"unknown fault site {s.site!r} "
                                 f"(known: {', '.join(KNOWN_SITES)})")
        return cls(specs=specs, pool_pressure=float(pool_pressure))

    def check(self, site: str, step: int) -> None:
        """Raise ``FaultInjected`` if a spec is armed at (site, step)."""
        for s in self.specs:
            if s.site == site and s.step == step and s.fired < s.times:
                s.fired += 1
                self.counts[site] = self.counts.get(site, 0) + 1
                raise FaultInjected(
                    f"injected {site} fault at step {step} "
                    f"(firing {s.fired}/{s.times})")

    def fired(self, site: Optional[str] = None) -> int:
        """Total firings, or those of one site."""
        if site is None:
            return sum(self.counts.values())
        return self.counts.get(site, 0)


def undersize_pool(full_pages: int, fraction: float,
                   floor: int = 1) -> int:
    """Pool size at ``fraction`` of the exhaustion-free provisioning,
    at least ``floor`` pages (pass the preemption governor's minimum
    viable pool so the pressure stays recoverable)."""
    return max(int(floor), int(math.ceil(float(fraction) * full_pages)))
