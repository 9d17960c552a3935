"""Pipeline schedules over the EARL stage graph (port of
``repro/core/scheduler.py``, Fig. 2 pipelined).

``PipelineSchedule`` runs ``EarlTrainer``'s stages under one of two
schedules:

  - ``mode="sync"``: Rollout → ExpPrep → Dispatch → Update, strictly
    ordered, one step at a time.
  - ``mode="async"``: one-step-off pipelining. The Update of step k runs on
    a worker thread while the main thread rolls out step k+1 with stale
    params. Rollout(k) samples with params version ``max(start, k - L)``
    (``L = max_policy_lag``), deterministically, so a run is reproducible
    and ``L = 0`` reproduces the sync schedule bit for bit. The in-flight
    update queue is at most L deep. Arm ``is_rho_max`` on the trainer for
    the truncated-IS correction of the lagged experience; the records carry
    ``policy_lag`` and ``is_weight_mean``.

On CUDA the worker runs the update on a side stream that the schedule owns
(``side_stream``); the rollout stays on the caller's current stream. The
kernels launch on the current stream of the thread that calls them, and
autograd runs each backward node on its forward's stream, so the whole
update, flash backward included, runs on the side stream. On the CPU there
are no streams and the worker thread alone carries the overlap. Two
hand-offs cross the streams; each is ordered where it happens
(``_run_async_once``). With ``dst_shardings`` the worker moves the batch
through ``DataDispatcher.dispatch_async`` from the source layouts taken at
submit, enqueues the update against the handle's batch and then resolves
the handle; the records' ``dispatch`` rows say ``"direct-async"``.

Fault tolerance (both modes): ``max_retries`` arms retries with backoff
``retry_backoff_s * 2**attempt``; ``checkpoint_dir``/``checkpoint_every``
save ``{params, opt_state, rng}`` (the rng is the trainer generator's
state) every N completed steps.

  - **sync** retries the failed step in place: the injected faults fire at
    stage boundaries, before the update, so params and optimizer state are
    still the pre-step state.
  - **async** restarts the whole pipeline from the latest checkpoint: the
    worker owns the live (params, opt_state), and a crash mid-pipeline
    leaves no state to trust. With no checkpoint the error propagates. The
    worker is torn down in a ``finally`` either way.

A checkpoint saved at step ``s`` means "``s`` steps completed"; resume
(``resume=True`` or the crash restart) continues at step ``s``. The async
schedule saves inside the worker right after the update: the single
worker orders the save before the next update, so the saved pair is
consistent.
"""
from __future__ import annotations

import contextlib
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)


def _print_record(rec) -> None:
    print(f"step {rec.step:4d}  return {rec.mean_return:+.3f}  "
          f"ctx {rec.mean_context_len:6.1f}  "
          f"trunc {rec.truncated_frac:.2f}  "
          f"loss {rec.loss:+.4f}  lag {rec.policy_lag}", flush=True)


@dataclass
class PipelineSchedule:
    """Runs the trainer's stage graph under a sync or async schedule."""

    trainer: Any                      # EarlTrainer (stage container)
    mode: str = "sync"                # "sync" | "async"
    max_policy_lag: int = 1           # async: bounded staleness (L)
    max_retries: int = 0              # step retries / pipeline restarts
    retry_backoff_s: float = 0.05     # base backoff (doubles per attempt)
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0         # save every N completed steps (0=off)
    resume: bool = False              # start from latest_step(checkpoint_dir)
    # the CUDA stream the async worker runs the update on (made at the
    # first async run on a CUDA trainer)
    side_stream: Any = field(default=None, init=False, repr=False)

    def __post_init__(self):
        if self.mode not in ("sync", "async"):
            raise ValueError(f"unknown pipeline mode {self.mode!r}")

    def run(self, n_steps: int, *, params, opt_state, ref_params=None,
            dst_shardings=None, verbose: bool = False):
        """Execute ``n_steps`` pipeline iterations. Returns ``(params,
        opt_state, history)``."""
        start = 0
        if self.resume and self.checkpoint_dir:
            s = latest_step(self.checkpoint_dir)
            if s is not None:
                params, opt_state, start = self._restore(s, params,
                                                         opt_state)
        if start >= n_steps:
            return params, opt_state, self.trainer.history
        run = self._run_sync if self.mode == "sync" else self._run_async
        return run(n_steps, start, params, opt_state, ref_params,
                   dst_shardings, verbose)

    # -- checkpoint plumbing ------------------------------------------------
    @staticmethod
    def _ckpt_tree(params, opt_state, rng):
        return {"params": params, "opt_state": opt_state._asdict(),
                "rng": rng}

    def _maybe_save(self, done: int, params, opt_state, rng) -> None:
        """Save the state after ``done`` completed steps when due."""
        if (self.checkpoint_dir and self.checkpoint_every > 0
                and done > 0 and done % self.checkpoint_every == 0):
            save_checkpoint(self.checkpoint_dir, done,
                            self._ckpt_tree(params, opt_state, rng))

    def _restore(self, step: int, params, opt_state):
        """Load checkpoint ``step`` into the shapes of the given state and
        set the trainer generator to the saved position."""
        tr = self.trainer
        st = restore_checkpoint(
            self.checkpoint_dir, step,
            self._ckpt_tree(params, opt_state, tr._gen.get_state()),
            map_location=tr.device)
        tr._gen.set_state(st["rng"])
        return st["params"], type(opt_state)(**st["opt_state"]), step

    # -- synchronous ----------------------------------------------------------
    def _run_sync(self, n_steps, start, params, opt_state, ref_params,
                  dst_shardings, verbose):
        tr = self.trainer
        for step in range(start, n_steps):
            for attempt in range(self.max_retries + 1):
                try:
                    params, opt_state, rec = tr.run_step(
                        step, params, opt_state, ref_params,
                        dst_shardings=dst_shardings)
                    break
                except Exception:
                    if attempt >= self.max_retries:
                        raise
                    time.sleep(self.retry_backoff_s * (2 ** attempt))
            if verbose:
                _print_record(rec)
            self._maybe_save(step + 1, params, opt_state,
                             tr._gen.get_state())
        return params, opt_state, tr.history

    # -- asynchronous one-step-off pipeline ---------------------------------
    def _run_async(self, n_steps, start, params, opt_state, ref_params,
                   dst_shardings, verbose):
        tr = self.trainer
        for attempt in range(self.max_retries + 1):
            try:
                return self._run_async_once(n_steps, start, params,
                                            opt_state, ref_params,
                                            dst_shardings, verbose)
            except Exception:
                s = (latest_step(self.checkpoint_dir)
                     if self.checkpoint_dir else None)
                if attempt >= self.max_retries or s is None:
                    raise
                # restart from the last saved state: the worker may have
                # died mid-update, so the in-memory state is not trusted
                params, opt_state, start = self._restore(s, params,
                                                         opt_state)
                # the restart re-runs (and re-records) the later steps
                tr.history[:] = [r for r in tr.history if r.step < start]
                time.sleep(self.retry_backoff_s * (2 ** attempt))

    def _run_async_once(self, n_steps, start, params, opt_state,
                        ref_params, dst_shardings, verbose):
        tr = self.trainer
        L = max(0, int(self.max_policy_lag))
        versions: Dict[int, Any] = {start: params}  # update count -> params
        futures: Dict[int, Any] = {}             # step -> in-flight update
        pending: Dict[int, dict] = {}            # step -> rollout-side row
        # the worker owns the live (params, opt_state); one worker, so the
        # updates apply strictly in step order
        state = {"params": params, "opt_state": opt_state}
        cuda = tr.device.type == "cuda"
        if cuda:
            main = torch.cuda.current_stream(tr.device)
            if self.side_stream is None:
                self.side_stream = torch.cuda.Stream(device=tr.device)
            side = self.side_stream

        def submit(pool, k, exp, src_shardings):
            # the generator AT SUBMIT TIME: rollout k has drawn, rollout
            # k+1 has not, which is where a resume at step k+1 restarts
            rng_after_k = tr._gen.get_state()
            ready = None
            if cuda:
                # the batch is made on the main stream (rollout, ExpPrep):
                # the side stream waits for it before the update reads it
                ready = torch.cuda.Event()
                ready.record(main)

            def work():
                t0 = time.perf_counter()
                with (torch.cuda.stream(side) if cuda
                      else contextlib.nullcontext()):
                    if cuda:
                        side.wait_event(ready)
                        # the batch crosses from the main stream: its blocks
                        # must not be reused before the side stream is done
                        for t in exp:
                            t.record_stream(side)
                    tr.check_fault("dispatch", k)
                    exp_d, handle = tr.dispatch_stage(
                        exp, dst_shardings, src_shardings=src_shardings,
                        asynchronous=True)
                    tr.check_fault("update", k)
                    p, o = state["params"], state["opt_state"]
                    p2, o2, metrics = tr.update_stage(p, o, exp_d)
                    dispatch_row = None
                    if handle is not None:
                        # the update is enqueued against the handoff;
                        # resolving the handle now stamps a wall time of
                        # the transfer alone, not of the update
                        dispatch_row = handle.result()[1].row()
                    # the update's host sync: it returns when the side
                    # stream has run the whole update, new params included.
                    # Only then are the old params and moments dropped, so
                    # no block they hold is reused while the update reads
                    # it.
                    metrics = tr.read_metrics(metrics)
                    state["params"], state["opt_state"] = p2, o2
                    # on the side stream too: its copies to the host need
                    # not queue behind the rollout's kernels
                    self._maybe_save(k + 1, p2, o2, rng_after_k)
                return p2, metrics, dispatch_row, time.perf_counter() - t0
            futures[k] = pool.submit(work)

        def resolve(k):
            """Finalize step k: wait for its update, publish the new params
            version, record the step."""
            p2, metrics, dispatch_row, upd_wall = futures.pop(k).result()
            if cuda:
                # p2 was made on the side stream and is complete: the
                # worker's metric read waited for it, and result() returned
                # after that read. A rollout on the main stream may read it
                # from here on, so when it is freed its blocks wait for the
                # main stream's work too.
                for t in p2.values():
                    t.record_stream(main)
            versions[k + 1] = p2
            row = pending.pop(k)
            rec = tr.make_record(
                k, row["stats"], metrics, switch=row["switch"],
                dispatch_row=dispatch_row,
                wall_time_s=time.perf_counter() - row["t0"],
                rollout_wall_s=row["rollout_wall_s"],
                update_wall_s=upd_wall, policy_lag=row["policy_lag"])
            if verbose:
                _print_record(rec)

        pool = ThreadPoolExecutor(max_workers=1,
                                  thread_name_prefix="earl-update")
        try:
            for k in range(start, n_steps):
                v = max(start, k - L)        # behaviour params version
                # bounded staleness: wait for the updates up to v - 1 so
                # version v exists (in-flight queue depth <= L)
                while v not in versions:
                    resolve(min(futures))
                behavior = versions[v]
                # versions older than any later rollout can need are dead
                for old in [x for x in versions if x < v]:
                    del versions[old]

                t0 = time.perf_counter()
                tr.check_fault("rollout", k)
                tr._maybe_warn_ref_fallback(ref_params)
                exp, stats, switch = tr.rollout_stage(
                    k, behavior, tr.batch_size,
                    n_episodes=tr.rollout_episodes,
                    noise=tr.rollout_noise(k), params_version=v,
                    ref_params=ref_params if tr.ref_folded else None)
                exp = tr.expprep_stage(
                    exp, ref_params=ref_params, ref_folded=tr.ref_folded,
                    # the reference IS the behaviour version that sampled
                    # the batch, and sampling recorded unbiased log-probs
                    reuse_behavior_lp=(
                        ref_params is behavior and tr.top_p == 1.0
                        and (tr.temperature <= 0.0
                             or tr.temperature == 1.0)))
                # the source layouts now: the next rollout overwrites the
                # engine's before the worker runs
                src = (tr.dispatch_stage.source_shardings(exp)
                       if dst_shardings is not None else None)
                # hook ②: tracked apart from the rollout's config (both
                # stages are live at once)
                if tr.selector is not None and tr.selector.policy is not None:
                    tr.selector.maybe_switch(k, stage="update")
                pending[k] = {
                    "stats": stats, "switch": switch, "t0": t0,
                    "rollout_wall_s": time.perf_counter() - t0,
                    "policy_lag": k - v,
                }
                submit(pool, k, exp, src)

            while futures:                   # drain the pipeline
                resolve(min(futures))
        finally:
            # never leave the worker thread or an update in flight: cancel
            # what has not started, wait out what has, and read the
            # exceptions of the finished ones so nothing warns at exit
            for f in futures.values():
                f.cancel()
            pool.shutdown(wait=True, cancel_futures=True)
            for f in futures.values():
                if f.done() and not f.cancelled():
                    f.exception()

        return state["params"], state["opt_state"], tr.history
