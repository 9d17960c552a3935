"""Rollout engine of the port (the paper's Rollout stage, Fig. 2 ①): the
slot engine of ``compiled.py`` on the paged KV pool, with its action
protocol and sampling (``common.py``), slot bookkeeping (``slots.py``) and
refill-side page management (``paging.py``)."""
from repro_torch.rl.engine.common import ACTION_BASE, RolloutStats
from repro_torch.rl.engine.compiled import CompiledRolloutEngine

__all__ = ["ACTION_BASE", "RolloutStats", "CompiledRolloutEngine"]
