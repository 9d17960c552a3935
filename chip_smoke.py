#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and ``nvcc``.
Phases, in order; any failure raises and exits non-zero:

  1. device  — refuse to run without CUDA; print the card's name and power
               limit as nvidia-smi reports them.
  2. build   — compile every kernel under src/repro_torch/csrc/ with nvcc
               (one process per source, all started at once, in the
               background); each kernel phase waits for its own sources
               only, and the build line (each source's nvcc seconds)
               follows the last kernel phase.
  3. kernels — at the main path's shapes, hold each kernel against its
               plain PyTorch version on the card, elementwise within a
               tolerance set per case from its own output scale, and time
               both with CUDA events (median of 50 single launches, L2
               flushed before each) beside the bound from bytes and
               operations.
     The flash-attention forward, dq and dk/dv kernels are held at the
               update's shapes (B=32, S=256, 14/2 heads, hd 64) in bf16
               and fp32, and in bf16 at B=4, S=2048, and also timed
               against torch's scaled_dot_product_attention and its
               autograd backward (library_ms; the port never calls it);
               the bf16 update shape reports the error one bf16 rounding
               of P / dS would give in place of the kernels' split. The
               forward also at a query offset (a model rank's rows of a
               sequence split over the model axis): bf16 and fp32 at hd
               64 and 128, an offset off the 64-row tile, a window, and
               seq_path's four ranks' shares of a 16,384-token prompt
               (B=1, 4,096 rows, 14/2 heads), timed beside their bound at
               the offset and SDPA with a boolean mask.
     The decode attention kernel is held at the dense cache's shapes
               (B=32, S=256, 14/2 heads, hd 64) in bf16 and fp32 under
               four masks (a random fill, a wrapped ring with a window,
               keys that start at slot 40 past an empty first tile, a
               fully masked row) and in bf16 at S=2048, timed against
               scaled_dot_product_attention with a boolean mask, and
               profiled (one launch per call).
     The fused sampling kernel is held at B=32 over qwen2's V=151936
               (zero noise, Gumbel noise, rows off a 16-byte boundary),
               tokens bitwise and a planted tie broken to the earliest
               index, profiled (one launch per call), and its cluster
               size probed (8, 4, 2, 1 blocks a row and back).
     The paged attention kernel is held at the rollout's shapes (B=32,
               14/2 heads, hd 64, 16-token pages, NP=16) in fp32, bf16 and
               int8 pools, with lens at the kernel's chunk edges and whole
               chunks unmapped, and at NP=128 (2,048 tokens), profiled,
               and timed under 8 chunks against its plan's 4.
  4. path    — full-width qwen2-0.5b (24 layers, d=896, 14/2 heads,
               V=151936, bf16, random weights from a seeded generator)
               driven through CompiledRolloutEngine on TicTacToe with
               attn_impl="paged", sampling="fused": one warm-up run, then
               one timed run with every launch counter set to 0 just
               before it and read just after.
  5. dense_path — the same engine settings on the dense layout
               (cache_layout="dense", attn_impl="pallas"): one run with
               the counters set to 0 just before it; every episode
               returned and exactly one decode attention per layer per
               decode step.
  6. branch  — one token stream teacher-forced through decode_step with
               the paged kernel (attn_impl="paged") and the gather path
               ("xla") from the same empty cache; logits compared.
     dense_branch — the same stream through the dense decode_step with
               the split-K kernel ("pallas") and plain attention ("xla"),
               and the dense kernel against the paged kernel.
  7. sync    — one paged macro-step, then one dense macro-step with the
               folded reference stream, under
               torch.cuda.set_sync_debug_mode("error").
  8. trace   — on the first 6 of the 24 layers (profiling a full-depth
               macro-step took a fifth of the script's time), one
               macro-step timed on the host clock, and the next under
               torch.profiler: device busy time and idle share, and paged
               attention's device ms over exactly one launch per layer
               per decode step.
     ref_trace — a macro-step of the path's engine with the folded
               reference stream under torch.profiler: decode attention's
               device ms over exactly one launch per layer per decode
               step.
  9. train   — full-width qwen2-0.5b through EarlTrainer (the sync step:
               Rollout with the reference pass folded in -> ExpPrep ->
               Dispatch -> Update with AdamW) for 2 steps on TicTacToe,
               B=N=32, max_context 256, KL 0.05, clip 0.2, bf16, remat
               "full"; every launch counter set to 0 before each step and
               read after it, and checked against the exact counts the
               step must make.
 10. train_trace — one more update of the last batch on the host clock,
               the next under torch.profiler: device busy and idle share,
               and device ms per flash kernel (each launched one > 0).
 11. train_branch — one update batch of the train phase through the
               update step with attn_impl "flash" (the kernels) and
               "xla" (plain attention): loss and per-leaf grad norms.
     The train phase runs in a single-rank NCCL process group, with a
               DataDispatcher routing each step's batch to one-device
               destination layouts (rows "direct", 0 bytes moved) and a
               ParallelismSelector of two one-device candidates that
               switches at step 1 and re-binds the engine.
     dispatch — on the train phase's last batch: the centralized
               strategy's host round trip (every leaf bitwise, still on
               the card), all_to_all_resplit on the one-rank mesh, and
               distributed_reinforce_advantages over the NCCL world of
               one against reinforce_advantages; what it costs.
     async_train — the async pipeline at the train phase's settings: (a)
               lag 0 through train(), the update on the schedule's side
               stream: records and final params equal to the train
               phase's, bitwise, and exact launches; (b) lag 1 with the IS
               cap 2.0, three steps, a checkpoint at step 2 and an
               injected update fault there: the fault fires once, the
               pipeline restarts from the checkpoint (lags 0, 1, 0),
               exact launches over 4 rollouts and 3 updates, every batch
               handed off through dispatch_async ("direct-async"); (c) the
               checkpoint read back bitwise; then a lag-1 run at 6 layers
               traced from step 1's rollout on: each flash kernel's
               stream, the busy share and the overlap of the two streams.
     The speculative slice:
     kernels: spec_verify — (in phase 3) the verify kernel at the spec
               path's shapes (B=32, K=4, 14/2 heads, hd 64, 16-token
               pages, 256-token context), pools in bf16, fp32 and int8,
               under four cases; held against ref.py, and each query j
               bitwise against the paged kernel at lens = pos + j + 1.
 12. spec_path — the engine with speculation="self" (spec_k 4, 6 draft
               layers) on the paged pool, sampling="reference", at the
               path phase's settings: verify rounds, spec counters, and
               exactly one verify kernel per layer per round.
 13. spec_branch — one teacher-forced chunk through spec_verify_step and
               through K sequential decode_steps (logits within 5% of the
               scale); the greedy engine with speculation on and off
               (reported: episodes whose streams are identical).
 14. spec_sync — one speculative macro-step under
               set_sync_debug_mode("error") everywhere except the round
               helper: host reads per turn = verify rounds + 1.
 15. spec_train — one EarlTrainer step with speculation="self" at the
               train phase's settings, with exact launch counts.
     The paged pool's second half (prefix sharing, int8 pages,
     preemption), on full-width qwen2-0.5b:
 16. shared_path — MultiArmedBandit with a 95-token prompt (96 shared
               tokens, six pages), B=32, 64 episodes, greedy,
               share_prefix=True on int8 pages: exactly one paged
               attention per layer per decode step, all on int8 pools;
               greedy tokens bitwise equal shared and unshared at int8 and
               bf16; the page peak within pool_pages_needed_shared; the
               int8 kernel route against the gather route; then a decode
               step and a verify chunk into a partial page forked into all
               32 rows, kernel against gather route, with the copy-on-write
               copy of values and scales checked.
 17. shared_spec — the same with speculation="self" (spec_k 4, 6 draft
               layers), 32 episodes: one int8 spec-verify launch per layer
               per verify round; greedy tokens bitwise equal to the
               non-speculative shared int8 run, and every committed token
               of both the greedy choice of a teacher-forced plain forward.
 17b. cost_model — the H100 roofline of utils/roofline over utils/cost's
               count of a trace on fake tensors, against the card: the
               prefill (flash) of the path's 32 rows of TicTacToe's
               12-token prompt and an LM update step (flash, full remat,
               AdamW) at B=4 x 256, on the path's full-width weights,
               warmed once and timed as a median of five by CUDA events;
               a subprocess started with the script (the card hidden from
               it) traces the same two programs and profiles a
               ParallelismSelector of [1, dp2, tp2] x buckets (4096,
               32768) through make_cost_model_measure at full width.
               Gates: predicted step time <= the measured median, the
               predicted peak less the arguments within 15% of the bytes
               the step allocated on the card, traced launches equal to
               the card's per kernel.
               It runs after shared_spec: the path phases before it
               report peak_mem_gib as the peak since the process
               started, and its resets of the peak would cut that
               window short.
 18. preempt_path — TicTacToe under on_exhaust="preempt" at the path's
               sizes (B=32, 64 episodes, 16-token pages, turns of 32
               tokens), greedy, int8, admit_watermark 64: preemptions in a
               pool of half the unpressured peak with trajectories bitwise
               equal to the unpressured run; the minimum-pool ValueError;
               pool_growth="double" from the minimum pool.
 19. shared_train — one EarlTrainer step on the bandit with sharing and
               int8 pages: the fallback warning once, ExpPrep's standalone
               pass (one flash forward per layer), exact launch counts.
     The tensor-parallel rollout (the kernels at one rank's shapes, 7/1
     heads and V=75,968, and the families' 12/4 and 16/16 heads,
     V=25,140, 16,000 and granite's whole 49,155, are in the kernels
     phase):
 19b. tp_path — full-width qwen2-0.5b (24 layers) at tp=2 in two
               processes that share the card over gloo (NCCL refuses two
               ranks on one device), started with the script and waiting
               until this phase: a tp=1 rollout on rank 0, the engine
               re-bound to tp=2, and the same rollout on both ranks' shards
               (B=8, greedy, paged, fused; fp32: 2 turns, the reference
               folded in; bf16: 1 turn): fp32 tokens equal, bf16
               first-step logits within 5%, launches and per-rank peak
               memory. Then the same for granite-moe-3b-a800m (12 layers),
               mamba2-370m (8) and zamba2-1.2b (12) at their published
               widths on their dense caches (fp32 on f32 caches), with the
               bytes each rank receives and keeps. Between them, the
               data-parallel rollout at dp=2 (each rank 4 of the 8 slots
               on its half of the pool): fp32 tokens, counters and
               launches equal the dp=1 run's, bf16 first-step logits at a
               rank's 4 rows within 5% of all 8 rows', int8 pages at 12
               layers, two SPMD trainer steps switching dp2 -> tp2
               against one rank (the update replicated on both ranks), and
               the update step alone at dp=2 on 24 layers in bf16 (each
               rank 4 of 8 rows of 256 tokens, the gradients summed over
               the ranks) against rank 0's one-rank update: loss, summed
               gradients, both ranks' new params bitwise equal, flash
               launches and peak memory (the kernels at a data row's
               shapes are in the kernels phase).
 19c. seq_path — sequence-parallel attention: full-width qwen2-0.5b (14
               q heads on 4 ranks: attention replicated) at tp=4 in four
               gloo processes sharing the card, which go once tp_path's
               ranks have exited, beside preempt_path: one 16,384-token
               prompt (B=1) through the paged prefill with the flash
               kernels, the split off and on: cache and last-position
               logits bitwise equal, the logits within 5% of one rank's
               tp=1 prefill (or tp=1's own distance from fp32), exactly 24
               forward launches a rank at 4,096 rows from its offset, the
               ranks' counted FLOPs (2r+1)/16 of the replicated rank's,
               each rank's forward ms at its inputs.
     The ssm slice (mamba2):
     kernels: ssd_scan — (in phase 3) the SSD scan kernel against ref.py
               (the model's chunked form) at the ssm_score shape (B=32,
               S=512, 32 heads x 64, state 128, chunk 256) in bf16 (the
               tensor-core route) and fp32, at S=1024 (four chunks), at a
               ragged S=300 and with four groups; the bf16 main shape
               profiled, and the head tile probed there, in fp32 and at
               four groups (two heads a block against one); fused_sample
               also at mamba2's V=50280.
 20. ssm_path — full-width mamba2-370m (48 layers, d=1024, V=50280, bf16,
               random weights) through CompiledRolloutEngine on its
               recurrent cache with the folded reference stream, B=32
               slots, 64 episodes, max_context 512: exactly one fused
               sample per generated-token step, no attention kernel and no
               SSD scan.
 21. ssm_score — ExpPrep's standalone reference pass over 32 of those
               episodes (32 x 512 tokens): exactly one SSD scan launch a layer,
               its log-probs against the plain pass and against the folded
               recurrent ones; kernel and plain wall time, and the scan's
               device time in a traced kernel pass (after a profiler
               warm-up pass) and its share of the pass's wall time.
 22. ssm_sync — one ssm macro-step with the reference stream under
               set_sync_debug_mode("error").
 23. ssm_train — one EarlTrainer step on mamba2 (B=N=32, max_context 512,
               KL 0.05, clip 0.2, remat "full"): reference folded, exact
               launch counts (the update runs the plain chunked form).
     The ssm phases run mamba2-370m at 8 of its 48 layers (SSM_LAYERS),
     async_train's lag-1 fault-and-restart run (b) qwen2-0.5b at 6 of its
     24 (FAULT_LAYERS), and phases 12-17 and 19 qwen2-0.5b at 12 of its 24
     (CUT_LAYERS, views of the path's weights; preempt_path keeps all 24):
     cuts of depth that paid for the phases below; every gate is kept and
     each depth-dependent launch gate is computed from the cut config.
     The moe and hybrid families (flash at hd 160, group 3 and group 1,
     and sampling at V=49155 and 32000 are in the kernels phase):
 24. hybrid_path — zamba2-1.2b at its published widths (12 of its 38
               Mamba2 layers, HYBRID_LAYERS: 2 shared-attention
               sites, V=32000, bf16, random
               weights) through CompiledRolloutEngine on its own dense
               cache with the folded reference, B=N=32, max_turns 2,
               max_turn_tokens 32, max_context 256: every episode
               returned, decode attention exactly sites x decode steps
               x 2, one fused sample per generated-token step, no SSD
               scan or other kernel launch (the Mamba layers decode
               recurrently, as JAX's).
     hybrid_score — ExpPrep's standalone pass over that batch with the
               flash kernels: exactly one flash forward per site, the
               log-probs against the plain pass at fp32 and within the
               bf16 drift of the f32 evaluation.
 25. moe_train — one folded sync EarlTrainer step of granite-moe-3b-a800m
               at its published widths (12 of its 32 layers,
               MOE_LAYERS; 40 experts top-8,
               V=49155, bf16, random weights made on the card) at the
               train phase's settings: every episode returned, exact
               decode attention (policy and reference), fused sampling
               and flash forward, dq and dk/dv launches, the aux loss
               finite and positive; rollout, ExpPrep and update seconds
               and the peak memory.
     The audio family (flash at whisper's group 1 and decode at its ring,
     and llama-vision's shapes, are in the kernels phase):
 26. audio_serve — whisper-large-v3 at its published widths and depth (32
               encoder and 32 decoder layers, d=1280, 20/20 heads x 64,
               V=51866, 1,500 frames from make_extras, bf16, random
               weights) through make_prefill_step (flash) and 32 greedy
               make_serve_step decode steps (the decode kernel), B=16
               rows of a 64-token prompt, then the same on "xla": exactly
               32 flash forwards in the prefill and 32 decode attentions
               a step, none from the encoder or the cross-attention;
               prefill and first-step logits within 5% of the plain
               route's scale; greedy agreement reported.
 27. audio_train — one make_lm_train_step (flash, remat "full", AdamW) at
               B=16, 256 decoder tokens over 1,500 frames, and one
               make_ref_logprob_step pass: exactly 64 flash forwards, 32
               dq and 32 dk/dv in the step and 32 forwards in the pass;
               the loss within 1% of the plain loss; peak memory.

Prints JSON lines; the line before the last lists every kernel, and the
last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

N_TIMED = 50
T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; phase lines carry ``t_s``, the seconds since the
    script started, so the time each phase takes can be read off."""
    if "phase" in obj:
        obj = dict(obj, t_s=time.perf_counter() - T_START)
    print(json.dumps(obj), flush=True)


def bound(work, f32: bool = True):
    """``(ms, by)``: the least time for ``work`` = ``(bytes, flops)``, a
    kernel's ``ops.work`` count, on the H100's data-sheet rates
    (``utils/roofline.kernel_bound_ms``): bytes over the HBM rate or
    operations over the peak rate of the inputs' type (``f32``: outside
    the tensor cores), whichever is larger."""
    from repro_torch.utils.roofline import kernel_bound_ms
    return kernel_bound_ms(*work, f32=f32)


def time_cold(torch, fn, n: int = N_TIMED) -> float:
    """Median ms of ``n`` single calls, each after a 256 MiB write that
    evicts the 50 MB L2. A spin of about half a millisecond on the card
    follows the write, so the host has enqueued the call before the
    device reaches the first event: the wrapper's Python time stays out
    of the reading."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_profile(torch, fn, symbols, n: int = 20) -> dict:
    """Device time of ``n`` single calls of ``fn`` under torch.profiler,
    each after the L2 flush and spin of ``time_cold``: per call, the
    launches of kernels whose names hold one of ``symbols``, each symbol's
    device microseconds, and the span from the first one's start to the
    last one's end (the span less the kernels' sum is the time the call
    spends on the device between its launches). Medians over the calls,
    which the spins separate by about half a millisecond. Each trace
    follows a warm-up pass of the same ``n`` calls whose events the
    profiler's schedule drops, as ssm_score's does. The card's tracer
    drops a kernel's events now and then (one or two calls of 20 on an
    H100, in three traces in a row more than once): a trace that lost
    any is taken again, three times at most, and then the fullest is kept
    if it holds at least ``n // 2`` calls. Only the calls with the most
    common number of launches enter the medians, so a call that lost
    one of its launches does not; ``calls_traced`` says how many did."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    best = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(n):
                    flush.zero_()
                    torch.cuda._sleep(1_000_000)
                    fn()
                torch.cuda.synchronize()
                prof.step()
        evs = sorted(((e.time_range.start, e.time_range.end, e.name)
                      for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and any(sym in e.name for sym in symbols)))
        calls = []
        for ev in evs:
            if not calls or ev[0] - calls[-1][-1][1] > 100.0:
                calls.append([])
            calls[-1].append(ev)
        if len(calls) > n:
            raise AssertionError(f"kernel_profile: {len(calls)} calls of "
                                 f"{symbols} in the trace, expected {n}")
        if len(calls) > len(best):
            best = calls
        if len(calls) == n:
            break
    whole = statistics.mode(len(c) for c in best) if best else 0
    calls = [c for c in best if len(c) == whole]
    if len(calls) < n // 2:
        raise AssertionError(f"kernel_profile: {len(best)} calls of "
                             f"{symbols} in the fullest of three traces, "
                             f"{len(calls)} of them whole, expected {n}")
    med = statistics.median
    per_sym = {sym: med(sum(e - s0 for s0, e, nm in c if sym in nm)
                        for c in calls) for sym in symbols}
    span = med(c[-1][1] - c[0][0] for c in calls)
    return dict(launches_per_call=med(len(c) for c in calls),
                calls_traced=len(calls), device_us=per_sym, span_us=span,
                between_launches_us=med((c[-1][1] - c[0][0])
                                        - sum(e - s0 for s0, e, _ in c)
                                        for c in calls))


# ---------------------------------------------------------------------------
def held(torch, out, ref, atol: float, rtol: float) -> dict:
    """Elementwise check |out - ref| <= atol + rtol * |ref| (the rule of
    torch.testing.assert_close); returns the max error and the worst
    error-to-tolerance ratio, which must be <= 1."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    ratio = float((err / (atol + rtol * ref.abs())).max())
    return dict(max_abs_err=float(err.max()), atol=atol, rtol=rtol,
                err_over_tol=ratio,
                ok=bool(torch.isfinite(out).all()) and ratio <= 1.0)


def phase_kernels(torch, report):
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_sample import ops as fs_ops
    from repro_torch.kernels.fused_sample.ref import fused_sample_ref
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention.ref import (
        paged_decode_attention_ref)

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(1)
    # --- paged attention at the rollout's shapes: B=32 slots, qwen2-0.5b
    #     heads (14 q / 2 kv, hd 64), page 16, 256-token context (NP=16),
    #     full provisioning (512 pages + the trash page); the kernel's plan
    #     there is 4 chunks of 4 pages per (row, kv head)
    B, H, KV, hd, ps, NP = 32, 14, 2, 64, 16, 16

    def table(NP, lens, g):
        """A shuffled block table mapping each row's pages below lens."""
        P = B * NP + 1
        perm = torch.randperm(P - 1, generator=g, device=dev)[:B * NP]
        bt = perm.reshape(B, NP).to(torch.int32)
        npages = (lens + ps - 1) // ps
        return P, torch.where(
            torch.arange(NP, device=dev)[None, :] < npages[:, None], bt, -1)

    def pools(P, kvdt, g):
        if kvdt == torch.int8:
            kp, vp = (torch.randint(-127, 128, (P, ps, KV, hd), generator=g,
                                    device=dev).to(torch.int8)
                      for _ in range(2))
            ks, vs = (torch.rand((P, ps, KV), generator=g, device=dev) / 127
                      for _ in range(2))
            return kp, vp, ks, vs
        kp, vp = (torch.randn((P, ps, KV, hd), generator=g,
                              device=dev).to(kvdt) for _ in range(2))
        return kp, vp, None, None

    cases = {}

    # Tolerances at each case's own output scale s = max|ref|. Kernel and
    # plain version do the same f32 math in another order: f32 output
    # within 32 f32 ulps of s (atol 2^-18 s). A bf16 output is that f32
    # result rounded once, and two nearby f32 values may round to adjacent
    # bf16 values: one bf16 ulp of each element (rtol 2^-7) on top.
    def run_case(name, q, kp, vp, bt, lens, ks, vs, rtol, profile=False):
        out = pa_ops.paged_decode_attention(q, kp, vp, bt, lens, k_scales=ks,
                                            v_scales=vs)
        ref = paged_decode_attention_ref(q, kp, vp, bt, lens, ks, vs)
        torch.cuda.synchronize()
        chk = held(torch, out, ref,
                   2.0 ** -18 * float(ref.float().abs().max()), rtol)
        if not chk["ok"]:
            raise AssertionError(f"paged_attention {name}: {chk}")
        empty = (lens <= 0) | ~(bt >= 0).any(dim=1)
        if bool((out[empty] != 0).any()):
            raise AssertionError(f"paged_attention {name}: a row with no "
                                 f"valid position is not zero")
        NPc = bt.shape[1]
        valid = ((torch.arange(NPc * ps, device=dev)[None, :] < lens[:, None])
                 & (bt >= 0)[:, :, None].expand(B, NPc, ps).reshape(
                     B, NPc * ps))
        n_valid = int(valid.sum())
        nbytes, flops = pa_ops.work(B, H, KV, hd, NPc, ps, q.element_size(),
                                    kp.element_size(), ks is not None,
                                    n_valid)
        b_ms, b_by = bound((nbytes, flops), q.dtype != torch.bfloat16)
        case = dict(
            chk,
            ms=time_cold(torch, lambda: pa_ops.paged_decode_attention(
                q, kp, vp, bt, lens, k_scales=ks, v_scales=vs)),
            plain_ms=time_cold(torch, lambda: paged_decode_attention_ref(
                q, kp, vp, bt, lens, ks, vs)),
            bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
            valid_positions=n_valid,
            plan=pa_ops.split_plan(B * KV, NPc, ps, _build.sm_count(0)))
        if profile:
            case["profile"] = kernel_profile(
                torch, lambda: pa_ops.paged_decode_attention(
                    q, kp, vp, bt, lens, k_scales=ks, v_scales=vs),
                PAGED_SYMBOLS)
        cases[name] = case
        emit({"phase": "kernels", "kernel": "paged_attention", "case": name,
              **case})
        return out

    lens = torch.randint(1, NP * ps + 1, (B,), generator=g, device=dev)
    lens[0] = 0                      # a row with nothing to attend to
    lens[1] = 3 * ps + 5             # a partially filled last page
    lens = lens.to(torch.int32)
    P, bt = table(NP, lens, g)
    bt[2, 1] = -1                    # an unmapped entry inside a live range
    bt = bt.contiguous()
    main = {}
    for name, qdt, kvdt, rtol in (("fp32", torch.float32, torch.float32, 0.0),
                                  ("bf16", torch.bfloat16, torch.bfloat16,
                                   2.0 ** -7),
                                  ("int8", torch.bfloat16, torch.int8,
                                   2.0 ** -7)):
        q = torch.randn((B, H, hd), generator=g, device=dev).to(qdt)
        kp, vp, ks, vs = pools(P, kvdt, g)
        run_case(name, q, kp, vp, bt, lens, ks, vs, rtol,
                 profile=name == "bf16")
        main[name] = (q, kp, vp, ks, vs)

    # the chunk edges (64, 128, 192): lens at each and one either side,
    # lens 0 and 1, and rows whose second chunk is all unmapped; from a
    # generator of their own, so that adding them left the data of the
    # cases above and below as it was
    g2 = torch.Generator(device=dev).manual_seed(11)
    edges = [0, 1, 63, 64, 65, 127, 128, 129, 191, 192, 193, 256]
    lens_e = torch.tensor([edges[i % len(edges)] for i in range(B)],
                          dtype=torch.int32, device=dev)
    P_e, bt_e = table(NP, lens_e, g2)
    for r in (6, 9, 11, 22):         # lens 128, 192, 256, 193
        bt_e[r, 4:8] = -1
    bt_e = bt_e.contiguous()
    q = torch.randn((B, H, hd), generator=g2, device=dev).bfloat16()
    kp, vp, _, _ = pools(P_e, torch.bfloat16, g2)
    run_case("bf16_edges", q, kp, vp, bt_e, lens_e, None, None, 2.0 ** -7)

    # a long context, NP=128 (2,048 tokens) under a random fill: 8 chunks
    # of 16 pages, beside decode attention's S=2048 case
    NPl = 128
    lens_l = torch.randint(1, NPl * ps + 1, (B,), generator=g2,
                           device=dev).to(torch.int32)
    P_l, bt_l = table(NPl, lens_l, g2)
    q = torch.randn((B, H, hd), generator=g2, device=dev).bfloat16()
    kp, vp, _, _ = pools(P_l, torch.bfloat16, g2)
    run_case("bf16_s2048", q, kp, vp, bt_l.contiguous(), lens_l, None, None,
             2.0 ** -7)

    # four two-tile chunks against eight one-tile chunks (decode
    # attention's plan rule) on the bf16 main case, in turns (4, 8, 8, 4
    # chunks), each plan held against ref.py first
    q, kp, vp, _, _ = main["bf16"]
    ref = paged_decode_attention_ref(q, kp, vp, bt, lens)
    probe = {}
    for plan in ((4, 4), (2, 8), (2, 8), (4, 4)):
        out = pa_ops._launch(q, kp, vp, bt, lens, None, None, plan)
        torch.cuda.synchronize()
        chk = held(torch, out, ref,
                   2.0 ** -18 * float(ref.float().abs().max()), 2.0 ** -7)
        if not chk["ok"]:
            raise AssertionError(f"paged_attention plan {plan}: {chk}")
        probe.setdefault(f"{plan[1]}_chunks_ms", []).append(time_cold(
            torch, lambda: pa_ops._launch(q, kp, vp, bt, lens, None, None,
                                          plan)))
    emit({"phase": "kernels", "kernel": "paged_attention",
          "case": "split_probe_bf16", **probe})
    cases["bf16"]["split_probe"] = probe
    # the engine's main path runs bf16 q against a bf16 pool
    report["paged_attention"] = dict(cases["bf16"], cases=cases)

    # --- fused sampling over the full qwen2 vocabulary (V=151936 is not a
    #     multiple of the TPU kernel's 1024 block), 32 rows
    V = 151936
    lg = torch.randn((B, V), generator=g, device=dev) * 3.0
    lg[0, 1000] = lg[0, 150000] = 100.0        # planted tie: earliest wins
    gum = -torch.log(-torch.log(
        torch.rand((B, V), generator=g, device=dev).clamp_min(1e-38)))
    gum[0] = 0.0
    # a contiguous copy starting one float past a 16-byte boundary takes
    # the kernel's scalar loads
    buf = torch.empty(B * V + 1, device=dev)
    lg_odd = buf[1:].view(B, V)
    lg_odd.copy_(lg)
    cases = {}
    for name, x, nz in (("zero_noise", lg, torch.zeros_like(lg)),
                        ("gumbel", lg, gum), ("gumbel_scalar", lg_odd, gum)):
        tok, lp = fs_ops.fused_sample(x, nz)
        tok_r, lp_r = fused_sample_ref(x, nz)
        torch.cuda.synchronize()
        if not torch.equal(tok, tok_r):
            raise AssertionError(f"fused_sample {name}: tokens differ")
        if int(tok[0]) != 1000:
            raise AssertionError("fused_sample: tie not broken to the "
                                 "earliest index")
        # lp = lg[tok] - (m + log l): each side sums V terms in f32 (the
        # kernel at most V/1024 per thread, then a tree of at most 11
        # levels, 5 in the warp, 3 in the block and 3 over the cluster,
        # with a rescale per merge; torch its own tree), so log l carries
        # about (V/1024 + 60) unit roundings between the two, plus a few
        # ulps of |lp| from the last subtractions
        atol = ((V / 1024 + 60) * 2.0 ** -24
                + 8 * 2.0 ** -23 * float(lp_r.abs().max()))
        chk = held(torch, lp, lp_r, atol, 0.0)
        if not chk["ok"]:
            raise AssertionError(f"fused_sample {name}: {chk}")
        b_ms, b_by = bound(fs_ops.work(B, V))
        case = dict(chk, tokens_equal=True,
                    ms=time_cold(torch, lambda: fs_ops.fused_sample(x, nz)),
                    plain_ms=time_cold(torch,
                                       lambda: fused_sample_ref(x, nz)),
                    bound_ms=b_ms, bound_by=b_by)
        if name == "gumbel":
            case["plan"] = fs_ops.cluster_plan(B, V, _build.sm_count(0))
            case["profile"] = kernel_profile(
                torch, lambda: fs_ops.fused_sample(x, nz), SAMPLE_SYMBOLS)
            if case["profile"]["launches_per_call"] != 1:
                raise AssertionError(f"fused_sample: {case['profile']}")
        cases[name] = case
        emit({"phase": "kernels", "kernel": "fused_sample", "case": name,
              **case})
    # the cluster size: k blocks a row for k in 8, 4, 2, 1 and back, each
    # held against ref.py (tokens bitwise) before it is timed
    tok_r, lp_r = fused_sample_ref(lg, gum)
    probe = {}
    for k in (8, 4, 2, 1, 1, 2, 4, 8):
        sl = 4 * -(-V // (4 * k))
        plan = (-(-V // sl), sl)
        tok, lp = fs_ops._launch(lg, gum, plan)
        torch.cuda.synchronize()
        if not torch.equal(tok, tok_r) or not held(
                torch, lp, lp_r, ((V / 1024 + 60) * 2.0 ** -24 + 8 * 2.0 **
                                  -23 * float(lp_r.abs().max())), 0.0)["ok"]:
            raise AssertionError(f"fused_sample cluster plan {plan} differs "
                                 f"from ref.py")
        probe.setdefault(f"k{plan[0]}_ms", []).append(time_cold(
            torch, lambda: fs_ops._launch(lg, gum, plan)))
    emit({"phase": "kernels", "kernel": "fused_sample",
          "case": "cluster_probe_gumbel", **probe})
    cases["gumbel"]["cluster_probe"] = probe
    # mamba2-370m's vocabulary: V=50280 is a multiple of 4, so rows stay
    # 16-byte aligned and the kernel takes its float4 loads
    V2 = 50280
    lg2 = torch.randn((B, V2), generator=g, device=dev) * 3.0
    gum2 = -torch.log(-torch.log(
        torch.rand((B, V2), generator=g, device=dev).clamp_min(1e-38)))
    tok, lp = fs_ops.fused_sample(lg2, gum2)
    tok_r, lp_r = fused_sample_ref(lg2, gum2)
    torch.cuda.synchronize()
    if not torch.equal(tok, tok_r):
        raise AssertionError("fused_sample gumbel_v50280: tokens differ")
    atol = ((V2 / 1024 + 60) * 2.0 ** -24
            + 8 * 2.0 ** -23 * float(lp_r.abs().max()))
    chk = held(torch, lp, lp_r, atol, 0.0)
    if not chk["ok"]:
        raise AssertionError(f"fused_sample gumbel_v50280: {chk}")
    b_ms, b_by = bound(fs_ops.work(B, V2))
    cases["gumbel_v50280"] = dict(
        chk, tokens_equal=True,
        plan=fs_ops.cluster_plan(B, V2, _build.sm_count(0)),
        ms=time_cold(torch, lambda: fs_ops.fused_sample(lg2, gum2)),
        plain_ms=time_cold(torch, lambda: fused_sample_ref(lg2, gum2)),
        bound_ms=b_ms, bound_by=b_by)
    emit({"phase": "kernels", "kernel": "fused_sample",
          "case": "gumbel_v50280", **cases["gumbel_v50280"]})
    # granite-moe's V=49155 (odd: no cluster width divides it, rows after
    # the first start off a 16-byte boundary and take the scalar loads)
    # and zamba2's V=32000
    for V3 in (49155, 32000):
        lg3 = torch.randn((B, V3), generator=g, device=dev) * 3.0
        gum3 = -torch.log(-torch.log(
            torch.rand((B, V3), generator=g, device=dev).clamp_min(1e-38)))
        tok, lp = fs_ops.fused_sample(lg3, gum3)
        tok_r, lp_r = fused_sample_ref(lg3, gum3)
        torch.cuda.synchronize()
        name = f"gumbel_v{V3}"
        if not torch.equal(tok, tok_r):
            raise AssertionError(f"fused_sample {name}: tokens differ")
        atol = ((V3 / 1024 + 60) * 2.0 ** -24
                + 8 * 2.0 ** -23 * float(lp_r.abs().max()))
        chk = held(torch, lp, lp_r, atol, 0.0)
        if not chk["ok"]:
            raise AssertionError(f"fused_sample {name}: {chk}")
        b_ms, b_by = bound(fs_ops.work(B, V3))
        cases[name] = dict(
            chk, tokens_equal=True,
            plan=fs_ops.cluster_plan(B, V3, _build.sm_count(0)),
            ms=time_cold(torch, lambda: fs_ops.fused_sample(lg3, gum3)),
            plain_ms=time_cold(torch, lambda: fused_sample_ref(lg3, gum3)),
            bound_ms=b_ms, bound_by=b_by)
        emit({"phase": "kernels", "kernel": "fused_sample", "case": name,
              **cases[name]})
    # the engine samples at temperature 1.0 from aligned logits
    report["fused_sample"] = dict(cases["gumbel"], cases=cases)


def combine_on_threads(torch, parts, offsets):
    """``fused_sample.ops.combine_partials`` for each vocab shard's partial
    state in ``parts``, one host thread a shard, with an all-reduce over
    the threads: the tp ranks' combine on one device."""
    import threading
    from repro_torch.kernels.fused_sample import ops as fs_ops
    R = len(parts)
    barrier = threading.Barrier(R)
    slots, out = [None] * R, [None] * R
    ops = {"max": lambda ts: torch.stack(ts).amax(0),
           "min": lambda ts: torch.stack(ts).amin(0),
           "sum": lambda ts: sum(ts[1:], ts[0])}

    def work(r):
        def reduce(t, op):
            slots[r] = t
            barrier.wait()
            res = ops[op](list(slots))
            barrier.wait()
            return res
        out[r] = fs_ops.combine_partials(*parts[r], offsets[r], reduce)

    threads = [threading.Thread(target=work, args=(r,)) for r in range(R)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def _tp_pool(torch, g, B, NP, ps, KV, hd, kvdt, fill):
    """A random pool of ``B * NP`` pages and a trash page, its block
    table mapping each row's first pages up to ``fill`` (B,) tokens, and
    f32 scales (absmax / 127 of random vectors) for an int8 pool."""
    dev = "cuda"
    P = B * NP + 1
    perm = torch.randperm(P - 1, generator=g, device=dev)[:B * NP]
    bt = torch.where(torch.arange(NP, device=dev)[None, :]
                     < ((fill + ps - 1) // ps)[:, None],
                     perm.reshape(B, NP).to(torch.int32), -1).contiguous()
    if kvdt == torch.int8:
        kp, vp = (torch.randint(-127, 128, (P, ps, KV, hd), generator=g,
                                device=dev).to(torch.int8) for _ in range(2))
        ks, vs = (torch.rand((P, ps, KV), generator=g, device=dev) / 127
                  for _ in range(2))
    else:
        kp, vp = (torch.randn((P, ps, KV, hd), generator=g,
                              device=dev).to(kvdt) for _ in range(2))
        ks = vs = None
    return kp, vp, ks, vs, bt


def spec_verify_cases(torch, report, g, B, H, KV, suffix):
    """Spec-verify at K=4 on ``B`` rows of a 96-token context (NP=6
    16-token pages; hd 64) with ``H``/``KV`` heads, on fp32, bf16 and
    int8 pools: each held against ref.py by its rule (2^-18 of the output
    scale plus 2^-7 relative for bf16 q, 0 relative for f32), each verify
    query also bitwise against the paged kernel at its length, and timed
    beside its bound (each live K/V element and scale read once; 4 hd
    flops per valid (query head, key) pair at the peak rate of q's type)
    and the plain version. Registered as ``<dtype>_<suffix>_k4``. No
    single PyTorch call computes it: the library time is null."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.spec_verify import ops as sv_ops
    from repro_torch.kernels.spec_verify.ref import spec_verify_attention_ref

    dev = "cuda"
    hd, ps, K, NP = 64, 16, 4, 6
    for dname, qdt, kvdt, rtol in (
            ("fp32", torch.float32, torch.float32, 0.0),
            ("bf16", torch.bfloat16, torch.bfloat16, 2.0 ** -7),
            ("int8", torch.float32, torch.int8, 0.0)):
        pos = torch.randint(0, NP * ps - K + 1, (B,), generator=g,
                            device=dev).to(torch.int32)
        kp, vp, ks, vs, bt = _tp_pool(torch, g, B, NP, ps, KV, hd, kvdt,
                                      pos + K)
        q = torch.randn((B, K, H, hd), generator=g, device=dev).to(qdt)
        out = sv_ops.spec_verify_attention(q, kp, vp, bt, pos, k_scales=ks,
                                           v_scales=vs)
        ref = spec_verify_attention_ref(q, kp, vp, bt, pos, ks, vs)
        torch.cuda.synchronize()
        name = f"{dname}_{suffix}_k4"
        chk = held(torch, out, ref,
                   2.0 ** -18 * float(ref.float().abs().max()), rtol)
        diff_q = [j for j in range(K) if not torch.equal(
            out[:, j], pa_ops.paged_decode_attention(
                q[:, j].contiguous(), kp, vp, bt, pos + j + 1,
                k_scales=ks, v_scales=vs))]
        if not chk["ok"] or diff_q:
            raise AssertionError(f"spec_verify {name}: {chk}, queries "
                                 f"{diff_q} differ from the paged kernel")
        live = int((pos + K).sum())
        pairs = H * int(sum(int(p) * K + K * (K + 1) // 2
                            for p in pos.tolist()))
        nbytes, flops = sv_ops.work(B, K, H, KV, hd, NP, ps,
                                    q.element_size(), kp.element_size(),
                                    ks is not None, live, pairs)
        b_ms, b_by = bound((nbytes, flops), qdt != torch.bfloat16)
        case = dict(
            chk, paged_kernel_bitwise=True, B=B, H=H, KV=KV, K=K, NP=NP,
            pool_pages=kp.shape[0],
            ms=time_cold(torch, lambda: sv_ops.spec_verify_attention(
                q, kp, vp, bt, pos, k_scales=ks, v_scales=vs)),
            plain_ms=time_cold(torch, lambda: spec_verify_attention_ref(
                q, kp, vp, bt, pos, ks, vs)),
            bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=4 * hd * pairs,
            plan=pa_ops.split_plan(B * KV, NP, ps, _build.sm_count(0)))
        report["spec_verify"]["cases"][name] = case
        emit({"phase": "kernels", "kernel": "spec_verify", "case": name,
              **case})


def tp_pool_cases(torch, report, g):
    """The paged-pool kernels at one rank's heads of full-width qwen2-0.5b
    at tp=2 (7 q heads, 1 kv head, hd 64, 16-token pages), on the shapes
    tp_path's option runs give them: spec-verify at K=4 on B=8 rows of the
    speculative run's 96-token context (``spec_verify_cases``) and paged
    attention on B=8 rows of the pool run's int8 pool (256 tokens,
    NP=16), held against ref.py by the same rule and timed beside its
    bound and the plain version."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention.ref import (
        paged_decode_attention_ref)

    dev = "cuda"
    B, H, KV, hd, ps = TP_BATCH, 7, 1, 64, 16
    spec_verify_cases(torch, report, g, B, H, KV, "tp2")

    NP = 16
    lens = torch.randint(1, NP * ps + 1, (B,), generator=g,
                         device=dev).to(torch.int32)
    kp, vp, ks, vs, bt = _tp_pool(torch, g, B, NP, ps, KV, hd, torch.int8,
                                  lens)
    q = torch.randn((B, H, hd), generator=g, device=dev)
    out = pa_ops.paged_decode_attention(q, kp, vp, bt, lens, k_scales=ks,
                                        v_scales=vs)
    ref = paged_decode_attention_ref(q, kp, vp, bt, lens, ks, vs)
    torch.cuda.synchronize()
    chk = held(torch, out, ref, 2.0 ** -18 * float(ref.float().abs().max()),
               0.0)
    if not chk["ok"]:
        raise AssertionError(f"paged_attention int8_tp2: {chk}")
    nbytes, flops = pa_ops.work(B, H, KV, hd, NP, ps, 4, 1, True,
                                int(lens.sum()))
    b_ms, b_by = bound((nbytes, flops))
    case = dict(chk, H=H, KV=KV, B=B, NP=NP,
                ms=time_cold(torch, lambda: pa_ops.paged_decode_attention(
                    q, kp, vp, bt, lens, k_scales=ks, v_scales=vs)),
                plain_ms=time_cold(torch, lambda: paged_decode_attention_ref(
                    q, kp, vp, bt, lens, ks, vs)),
                bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                plan=pa_ops.split_plan(B * KV, NP, ps, _build.sm_count(0)))
    report["paged_attention"]["cases"]["int8_tp2"] = case
    emit({"phase": "kernels", "kernel": "paged_attention", "case": "int8_tp2",
          **case})


def dp_cases(torch, report, g):
    """The decode-side kernels at one data row of full-width qwen2-0.5b at
    dp=2 (tp_path's dp runs: 4 of B=8 rows, 14 q heads on 2 kv heads, hd
    64, a 96-token context): paged attention on the row's half pool (4 x 6
    pages and its trash page) at fp32, bf16 and int8, spec-verify at K=4
    on the same half pools (the speculative dp option run's verify
    chunks; ``spec_verify_cases``), the decode kernel on the folded
    reference's bf16 cache, and the one-launch sampler on the row's 4 rows
    of the 151,936-wide vocabulary. Each is held against ref.py by its
    phase's rule and timed beside its bound and the plain version (and
    SDPA for the decode kernel)."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.fused_sample import ops as fs_ops
    from repro_torch.kernels.fused_sample.ref import fused_sample_ref
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention.ref import (
        paged_decode_attention_ref)

    dev = "cuda"
    B, H, KV, hd, ps, NP, S = TP_BATCH // 2, 14, 2, 64, 16, 6, 96
    lens = torch.randint(1, S + 1, (B,), generator=g,
                         device=dev).to(torch.int32)
    n_valid = int(lens.sum())
    for dname, qdt, kvdt, rtol in (
            ("fp32", torch.float32, torch.float32, 0.0),
            ("bf16", torch.bfloat16, torch.bfloat16, 2.0 ** -7),
            ("int8", torch.float32, torch.int8, 0.0)):
        kp, vp, ks, vs, bt = _tp_pool(torch, g, B, NP, ps, KV, hd, kvdt,
                                      lens)
        q = torch.randn((B, H, hd), generator=g, device=dev).to(qdt)
        call = lambda: pa_ops.paged_decode_attention(
            q, kp, vp, bt, lens, k_scales=ks, v_scales=vs)
        plain = lambda: paged_decode_attention_ref(q, kp, vp, bt, lens, ks,
                                                   vs)
        out, ref = call(), plain()
        torch.cuda.synchronize()
        chk = held(torch, out, ref,
                   2.0 ** -18 * float(ref.float().abs().max()), rtol)
        if not chk["ok"]:
            raise AssertionError(f"paged_attention {dname}_dp2: {chk}")
        nbytes, flops = pa_ops.work(B, H, KV, hd, NP, ps, q.element_size(),
                                    kp.element_size(), ks is not None,
                                    n_valid)
        b_ms, b_by = bound((nbytes, flops), qdt != torch.bfloat16)
        case = dict(chk, H=H, KV=KV, B=B, NP=NP, pool_pages=kp.shape[0],
                    ms=time_cold(torch, call), plain_ms=time_cold(torch, plain),
                    bound_ms=b_ms, bound_by=b_by, bytes=nbytes)
        report["paged_attention"]["cases"][f"{dname}_dp2"] = case
        emit({"phase": "kernels", "kernel": "paged_attention",
              "case": f"{dname}_dp2", **case})
    spec_verify_cases(torch, report, g, B, H, KV, "dp2")

    q = torch.randn((B, H, hd), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((B, S, KV, hd), generator=g, device=dev).bfloat16()
            for _ in range(2))
    valid = torch.arange(S, device=dev)[None, :] < lens[:, None]
    out = da_ops.decode_attention(q, k, v, valid)
    ref = decode_attention_ref(q, k, v, valid)
    torch.cuda.synchronize()
    chk = held(torch, out, ref, 2.0 ** -18 * float(ref.float().abs().max()),
               2.0 ** -7)
    if not chk["ok"]:
        raise AssertionError(f"decode_attention bf16_dp2: {chk}")
    nbytes, flops = da_ops.work(B, H, KV, hd, S, 2, 2, n_valid)
    b_ms, b_by = bound((nbytes, flops), False)
    am = valid[:, None, None, :]
    case = dict(chk, B=B, S=S, H=H, KV=KV,
                ms=time_cold(torch, lambda: da_ops.decode_attention(
                    q, k, v, valid)),
                plain_ms=time_cold(torch, lambda: decode_attention_ref(
                    q, k, v, valid)),
                library_ms=time_cold(
                    torch, lambda: F.scaled_dot_product_attention(
                        q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                        attn_mask=am, enable_gqa=True)),
                bound_ms=b_ms, bound_by=b_by, bytes=nbytes)
    report["decode_attention"]["cases"]["bf16_dp2"] = case
    emit({"phase": "kernels", "kernel": "decode_attention",
          "case": "bf16_dp2", **case})

    V = 151936
    lg = torch.randn((B, V), generator=g, device=dev) * 3.0
    gum = -torch.log(-torch.log(
        torch.rand((B, V), generator=g, device=dev).clamp_min(1e-38)))
    tok, lp = fs_ops.fused_sample(lg, gum)
    tok_r, lp_r = fused_sample_ref(lg, gum)
    torch.cuda.synchronize()
    atol = ((V / 1024 + 60) * 2.0 ** -24
            + 8 * 2.0 ** -23 * float(lp_r.abs().max()))
    chk = held(torch, lp, lp_r, atol, 0.0)
    if not (chk["ok"] and torch.equal(tok, tok_r)):
        raise AssertionError(f"fused_sample gumbel_dp2: {chk}")
    b_ms, b_by = bound(fs_ops.work(B, V))
    case = dict(chk, tokens_equal=True, B=B,
                ms=time_cold(torch, lambda: fs_ops.fused_sample(lg, gum)),
                plain_ms=time_cold(torch, lambda: fused_sample_ref(lg, gum)),
                bound_ms=b_ms, bound_by=b_by)
    report["fused_sample"]["cases"]["gumbel_dp2"] = case
    emit({"phase": "kernels", "kernel": "fused_sample", "case": "gumbel_dp2",
          **case})


def phase_tp_kernels(torch, report):
    """The kernels at one rank's shapes of full-width qwen2-0.5b at tp=2
    (tp_path): paged attention at 7 q heads on one kv head (group 7, B=32,
    NP=16, bf16), held and timed as the path's cases; and the fused
    sampler's partial-state mode on the rank's vocab shard (B=32,
    V=75,968, zero and Gumbel noise): each of its five outputs against
    ``fused_sample_partial_ref`` (m, the best score, its index and its
    logit bitwise; l within the log-prob rule's roundings), and the two
    shards' states combined (``combine_partials``) against the one-launch
    kernel on the whole 151,936-wide row: tokens bitwise, log-probs within
    the one-launch rule, a tie across the shards broken to the earliest
    index. The same for the families' rank shards at tp_path's B=8,
    greedy (mamba2's 25,140 and zamba2's 16,000 of 50,280 and 32,000),
    and the one-launch sampler on granite-moe's whole 49,155-wide row,
    which every rank samples at tp=2 (its vocab does not divide). The
    decode and flash kernels at the families' rank heads are in their own
    phases (``*_granite_tp2``, ``*_zamba2_tp2``). The option runs' shapes
    (spec-verify on fp32, bf16 and int8 pools, paged attention on an int8
    pool) are ``tp_pool_cases``', and those of tp_path's dp runs (a data
    row's 4 rows on its half pool) ``dp_cases``'."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_sample import ops as fs_ops
    from repro_torch.kernels.fused_sample.ref import (
        fused_sample_partial_ref, fused_sample_ref)
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention.ref import (
        paged_decode_attention_ref)

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(25)
    B, H, KV, hd, ps, NP = 32, 7, 1, 64, 16, 16
    P = B * NP + 1
    lens = torch.randint(1, NP * ps + 1, (B,), generator=g,
                         device=dev).to(torch.int32)
    perm = torch.randperm(P - 1, generator=g, device=dev)[:B * NP]
    bt = torch.where(torch.arange(NP, device=dev)[None, :]
                     < ((lens + ps - 1) // ps)[:, None],
                     perm.reshape(B, NP).to(torch.int32), -1).contiguous()
    q = torch.randn((B, H, hd), generator=g, device=dev).bfloat16()
    kp, vp = (torch.randn((P, ps, KV, hd), generator=g,
                          device=dev).bfloat16() for _ in range(2))
    out = pa_ops.paged_decode_attention(q, kp, vp, bt, lens)
    ref = paged_decode_attention_ref(q, kp, vp, bt, lens)
    torch.cuda.synchronize()
    chk = held(torch, out, ref, 2.0 ** -18 * float(ref.float().abs().max()),
               2.0 ** -7)
    if not chk["ok"]:
        raise AssertionError(f"paged_attention bf16_tp2: {chk}")
    nbytes, flops = pa_ops.work(B, H, KV, hd, NP, ps, 2, 2, False,
                                int(lens.sum()))
    b_ms, b_by = bound((nbytes, flops), False)
    case = dict(chk, H=H, KV=KV, B=B, NP=NP,
                ms=time_cold(torch, lambda: pa_ops.paged_decode_attention(
                    q, kp, vp, bt, lens)),
                plain_ms=time_cold(torch, lambda: paged_decode_attention_ref(
                    q, kp, vp, bt, lens)),
                bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                plan=pa_ops.split_plan(B * KV, NP, ps, _build.sm_count(0)))
    report["paged_attention"]["cases"]["bf16_tp2"] = case
    emit({"phase": "kernels", "kernel": "paged_attention", "case": "bf16_tp2",
          **case})
    tp_pool_cases(torch, report, g)
    dp_cases(torch, report, g)

    cases = {}

    def partial_cases(tag, Bp, V, noises):
        """The partial mode on each half of a (Bp, V) row, held against
        ref.py, and the halves combined against the one-launch kernel on
        the whole row; ``tag`` names the cases beside the noise."""
        Vl = V // 2
        lg = torch.randn((Bp, V), generator=g, device=dev) * 3.0
        lg[0, 1000] = lg[0, Vl + 7] = 100.0  # a tie across the two shards
        gum = -torch.log(-torch.log(
            torch.rand((Bp, V), generator=g, device=dev).clamp_min(1e-38)))
        gum[0] = 0.0
        for noise in noises:
            name = noise + tag
            nz = torch.zeros_like(lg) if noise == "zero_noise" else gum
            shards = [(lg[:, r * Vl:(r + 1) * Vl].contiguous(),
                       nz[:, r * Vl:(r + 1) * Vl].contiguous())
                      for r in (0, 1)]
            parts = [fs_ops.fused_sample_partial(*sh) for sh in shards]
            refs = [fused_sample_partial_ref(*sh) for sh in shards]
            torch.cuda.synchronize()
            for got, want in zip(parts, refs):
                for i, what in ((0, "m"), (2, "best score"), (3, "index"),
                                (4, "logit")):
                    if not torch.equal(got[i], want[i]):
                        raise AssertionError(f"fused_sample_partial {name}:"
                                             f" {what} differs from ref.py")
            # l sums Vl exponentials in another order: the log-prob rule's
            # (V/1024 + 60) roundings, relative to l
            lchk = held(torch, parts[0][1], refs[0][1], 0.0,
                        (Vl / 1024 + 60) * 2.0 ** -24)
            combined = combine_on_threads(torch, parts, [0, Vl])
            tok, lp = fs_ops.fused_sample(lg, nz)
            torch.cuda.synchronize()
            atol = ((V / 1024 + 60) * 2.0 ** -24
                    + 8 * 2.0 ** -23 * float(lp.abs().max()))
            for t, p_ in combined:
                if not torch.equal(t, tok) or int(t[0]) != 1000:
                    raise AssertionError(f"fused_sample_partial {name}: the "
                                         f"combined tokens differ from the "
                                         f"one-launch kernel's")
                chk = held(torch, p_, lp, atol, 0.0)
                if not (chk["ok"] and lchk["ok"]):
                    raise AssertionError(f"fused_sample_partial {name}: "
                                         f"{chk} {lchk}")
            x, z = shards[0]
            b_ms, b_by = bound(fs_ops.work(Bp, Vl, partial=True))
            cases[name] = dict(
                chk, l_err_over_tol=lchk["err_over_tol"], tokens_equal=True,
                B=Bp, V_local=Vl,
                plan=fs_ops.cluster_plan(Bp, Vl, _build.sm_count(0)),
                ms=time_cold(torch, lambda: fs_ops.fused_sample_partial(x, z)),
                plain_ms=time_cold(torch,
                                   lambda: fused_sample_partial_ref(x, z)),
                one_launch_full_row_ms=time_cold(
                    torch, lambda: fs_ops.fused_sample(lg, nz)),
                bound_ms=b_ms, bound_by=b_by)
            emit({"phase": "kernels", "kernel": "fused_sample_partial",
                  "case": name, **cases[name]})

    # qwen2-0.5b's V=151,936 (75,968 a rank) at B=32; tp_path's families
    # at its batch, greedy: mamba2's V=50,280 (25,140 a rank) and zamba2's
    # V=32,000 (16,000 a rank)
    partial_cases("", B, 151936, ("zero_noise", "gumbel"))
    partial_cases("_v50280_b8", TP_BATCH, 50280, ("zero_noise",))
    partial_cases("_v32000_b8", TP_BATCH, 32000, ("zero_noise",))
    # the tp path samples greedily: zero noise
    report["fused_sample_partial"] = dict(cases["zero_noise"], cases=cases)

    # granite-moe's 49,155 rows do not divide 2 ways: at tp=2 every rank
    # samples the whole row with the one-launch kernel, greedy, at B=8
    V = 49155
    lg = torch.randn((TP_BATCH, V), generator=g, device=dev) * 3.0
    z = torch.zeros_like(lg)
    tok, lp = fs_ops.fused_sample(lg, z)
    tok_r, lp_r = fused_sample_ref(lg, z)
    torch.cuda.synchronize()
    if not torch.equal(tok, tok_r):
        raise AssertionError("fused_sample zero_noise_v49155_b8: tokens "
                             "differ")
    chk = held(torch, lp, lp_r, ((V / 1024 + 60) * 2.0 ** -24
                                 + 8 * 2.0 ** -23
                                 * float(lp_r.abs().max())), 0.0)
    if not chk["ok"]:
        raise AssertionError(f"fused_sample zero_noise_v49155_b8: {chk}")
    b_ms, b_by = bound(fs_ops.work(TP_BATCH, V))
    case = dict(chk, tokens_equal=True, B=TP_BATCH,
                plan=fs_ops.cluster_plan(TP_BATCH, V, _build.sm_count(0)),
                ms=time_cold(torch, lambda: fs_ops.fused_sample(lg, z)),
                plain_ms=time_cold(torch, lambda: fused_sample_ref(lg, z)),
                bound_ms=b_ms, bound_by=b_by)
    report["fused_sample"]["cases"]["zero_noise_v49155_b8"] = case
    emit({"phase": "kernels", "kernel": "fused_sample",
          "case": "zero_noise_v49155_b8", **case})


def one_rounding_errors(torch, q, k, v, do, out, L, out_r, grads_r,
                        causal, window):
    """The error the bf16 kernels would make with one bf16 rounding of each
    f32 A operand (P in P V; dS in dQ = dS K; P and dS in dV = P^T dO and
    dK = dS^T Q) instead of the hi + lo split they use: the plain formulas
    of ref.py with those operands rounded once, as err / tol under the
    kernels' gates. Reported, not gated: it is why the kernels split."""
    import math
    from repro_torch.kernels.flash_attention.ref import NEG_INF, _scores
    B, S, H, hd = q.shape
    KV = k.shape[2]
    rnd = lambda t: t.bfloat16().float()
    s, ok, qf = _scores(q, k, causal, window)
    sm = torch.where(ok, s, NEG_INF)
    p = torch.exp(sm - sm.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True).permute(0, 3, 1, 2, 4)
    o1 = (torch.einsum("bkgqs,bskh->bqkgh", rnd(p), v.float()) / l)
    o1 = o1.reshape(B, S, H, hd).to(q.dtype)
    p = torch.where(ok, torch.exp(s - L.reshape(B, KV, H // KV, S, 1)), 0.0)
    dof = do.float().reshape(B, S, KV, H // KV, hd)
    D = (dof * out.float().reshape(B, S, KV, H // KV, hd)).sum(-1)
    dp = torch.einsum("bqkgh,bskh->bkgqs", dof, v.float())
    ds = p * (dp - D.permute(0, 2, 3, 1)[..., None])
    dq1 = (torch.einsum("bkgqs,bskh->bqkgh", rnd(ds), k.float())
           / math.sqrt(hd)).reshape(B, S, H, hd)
    dk1 = torch.einsum("bkgqs,bqkgh->bskh", rnd(ds), qf) / math.sqrt(hd)
    dv1 = torch.einsum("bkgqs,bqkgh->bskh", rnd(p), dof)
    tol = lambda r, rel: 2.0 ** rel * float(r.float().abs().max())
    return {"flash_fwd": held(torch, o1, out_r, tol(out_r, -18),
                              2.0 ** -7)["err_over_tol"],
            "flash_dq": held(torch, dq1.to(q.dtype), grads_r[0],
                             tol(grads_r[0], -14), 2.0 ** -7)["err_over_tol"],
            "flash_dkv": max(held(torch, x.to(r.dtype), r, tol(r, -14),
                                  2.0 ** -7)["err_over_tol"]
                             for x, r in ((dk1, grads_r[1]),
                                          (dv1, grads_r[2])))}


def phase_flash(torch, report):
    """The flash-attention kernels at the update's shapes: B=32, S=256,
    14/2 heads, hd 64, causal, bf16 (the main path) and fp32, and in bf16
    at a long context, B=4, S=2048, where the forward crosses the tensor
    cores' balance; at granite-moe's heads (24/8, group 3) in bf16, and at
    stablelm-12b's (32/8, hd 160) in bf16 and fp32, both at B=32, S=256;
    at whisper-large-v3's (20/20, group 1) in bf16 at B=16, S=256 and
    S=64, at llama-3.2-vision-11b's (32/8, hd 128) in bf16 at B=4,
    S=64, at one rank's heads of the tp=2 rollouts, at one rank's rows
    of tp_path's dp=2 update (B=4, S=256, 14/2), and at granite-moe's rows
    a rank computes in tp_path's (f) and (g) (B=3, 2 and 1, S=256,
    24/8). Each is held against ``ref.py`` and timed beside its
    bound, the plain version and torch's scaled_dot_product_attention
    (forward, or its autograd backward, which computes dq, dk and dv in
    one call). At the update's bf16 shape every case also reports the
    error one bf16 rounding of its f32 A operands would give
    (``one_rounding_errors``). Then the forward at a query offset
    (``offset_cases``)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_fwd_ref)

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(5)
    cases = {"flash_fwd": {}, "flash_dq": {}, "flash_dkv": {}}
    # Tolerances at each output's own scale s = max|ref|: O and L within
    # 32 f32 ulps of s (atol 2^-18 s), as for paged attention; gradients
    # within 2^-14 s, because each sums up to 7 x S products of terms
    # that cancel in dS = P(dP - D). bf16 outputs add one bf16 ulp of
    # each element (rtol 2^-7).
    bf16 = (torch.bfloat16, False, 2.0 ** -7)
    f32 = (torch.float32, True, 0.0)
    for name, B, S, H, KV, hd, (dt, is_f32, rtol) in (
            ("bf16", 32, 256, 14, 2, 64, bf16),
            ("fp32", 32, 256, 14, 2, 64, f32),
            ("bf16_s2048", 4, 2048, 14, 2, 64, bf16),
            # granite-moe-3b-a800m's update (24/8 heads: group 3)
            ("bf16_granite", 32, 256, 24, 8, 64, bf16),
            # stablelm-12b's attention (32/8 heads, hd 160) at the
            # update's B and S: the 160-wide tiles and m64n160 products
            ("bf16_hd160", 32, 256, 32, 8, 160, bf16),
            ("fp32_hd160", 32, 256, 32, 8, 160, f32),
            # whisper-large-v3's decoder (20/20 heads: group 1) at
            # audio_train's update (B=16, S=256) and audio_serve's prefill
            # (S=64), and llama-3.2-vision-11b's self layers (32/8, hd 128)
            # at its card test's prefill (B=4, S=64)
            ("bf16_whisper", 16, 256, 20, 20, 64, bf16),
            ("bf16_whisper_s64", 16, 64, 20, 20, 64, bf16),
            ("bf16_vision", 4, 64, 32, 8, 128, bf16),
            # one rank of qwen2-0.5b at tp=2 (tp_path): 7 q heads, 1 kv
            ("bf16_tp2", 8, 256, 7, 1, 64, bf16),
            # one rank of granite-moe (12/4) and of zamba2's sites (16/16)
            # at tp=2, at tp_path's batch
            ("bf16_granite_tp2", 8, 256, 12, 4, 64, bf16),
            ("bf16_zamba2_tp2", 8, 256, 16, 16, 64, bf16),
            # one rank's rows of tp_path's data-parallel update at dp=2
            # (run (e): 4 of 8 rows of 256 tokens)
            ("bf16_update_dp2", 4, 256, 14, 2, 64, bf16),
            # granite-moe's straddling runs at dp=2: a rank's 3 of 6 rows
            # in (f), and in (g) a whole 2-row slice and a rank's 1-row
            # part of the middle one
            ("bf16_granite_straddle", 3, 256, 24, 8, 64, bf16),
            ("bf16_granite_slice", 2, 256, 24, 8, 64, bf16),
            ("bf16_granite_slice_part", 1, 256, 24, 8, 64, bf16)):
        q, do = (torch.randn((B, S, H, hd), generator=g, device=dev).to(dt)
                 for _ in range(2))
        k, v = (torch.randn((B, S, KV, hd), generator=g, device=dev).to(dt)
                for _ in range(2))
        out, L = fa_ops.flash_attention_fwd(q, k, v, True, 0)
        dq, dk, dv = fa_ops.flash_attention_bwd(q, k, v, out, do, L, True, 0)
        out_r, L_r = attention_fwd_ref(q, k, v, True, 0)
        # the backward on the same inputs as the kernels' (the kernel's O
        # and L): in bf16 the rounding of O moves D = rowsum(dO O)
        dq_r, dk_r, dv_r = attention_bwd_ref(q, k, v, out, do, L, True, 0)
        torch.cuda.synchronize()
        scale = lambda t: float(t.float().abs().max())
        checks = {
            "flash_fwd": [held(torch, out, out_r, 2.0 ** -18 * scale(out_r),
                               rtol),
                          held(torch, L, L_r, 2.0 ** -18 * scale(L_r), 0.0)],
            "flash_dq": [held(torch, dq, dq_r, 2.0 ** -14 * scale(dq_r),
                              rtol)],
            "flash_dkv": [held(torch, x, r, 2.0 ** -14 * scale(r), rtol)
                          for x, r in ((dk, dk_r), (dv, dv_r))]}
        one_rounding = (one_rounding_errors(
            torch, q, k, v, do, out, L, out_r, (dq_r, dk_r, dv_r), True, 0)
            if name == "bf16" else {})
        D = torch.einsum("bshd,bshd->bhs", do.float(),
                         out.float()).contiguous()
        qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_(True)
                      for t in (q, k, v))
        o_lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True)
        do_t = do.transpose(1, 2)
        lib_bwd = lambda: torch.autograd.grad(o_lib, (qt, kt, vt), do_t,
                                              retain_graph=True)
        times = {
            "flash_fwd": (
                lambda: fa_ops.flash_attention_fwd(q, k, v, True, 0),
                lambda: attention_fwd_ref(q, k, v, True, 0),
                lambda: F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    is_causal=True, enable_gqa=True)),
            "flash_dq": (
                lambda: fa_ops.flash_attention_dq(q, k, v, do, L, D, True, 0),
                lambda: attention_bwd_ref(q, k, v, out, do, L, True, 0),
                lib_bwd),
            "flash_dkv": (
                lambda: fa_ops.flash_attention_dkv(q, k, v, do, L, D, True,
                                                   0),
                lambda: attention_bwd_ref(q, k, v, out, do, L, True, 0),
                lib_bwd)}
        plain_bwd_ms = lib_bwd_ms = None
        for kname, chk in checks.items():
            ok = all(c["ok"] for c in chk)
            case = dict(B=B, S=S, H=H, KV=KV, hd=hd,
                        max_abs_err=max(c["max_abs_err"]
                                                  for c in chk),
                        atol=[c["atol"] for c in chk], rtol=rtol,
                        err_over_tol=max(c["err_over_tol"] for c in chk))
            if kname in one_rounding:
                case["one_rounding_err_over_tol"] = one_rounding[kname]
            if not ok:
                raise AssertionError(f"{kname} {name}: {case}")
            kern, plain, lib = times[kname]
            nbytes, flops = fa_ops.work(kname[len("flash_"):], B, S, S, H,
                                        KV, hd, q.element_size())
            b_ms, b_by = bound((nbytes, flops), is_f32)
            case["ms"] = time_cold(torch, kern)
            if kname == "flash_fwd":
                case["plain_ms"] = time_cold(torch, plain)
                case["library_ms"] = time_cold(torch, lib)
            else:          # one plain / library call computes dq, dk, dv
                if plain_bwd_ms is None:
                    plain_bwd_ms = time_cold(torch, plain)
                    lib_bwd_ms = time_cold(torch, lib)
                case["plain_ms"], case["library_ms"] = plain_bwd_ms, \
                    lib_bwd_ms
            case.update(bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                        flops=flops)
            cases[kname][name] = case
            emit({"phase": "kernels", "kernel": kname, "case": name, **case})
        del out_r, L_r, dq_r, dk_r, dv_r, o_lib
    offset_cases(torch, cases["flash_fwd"], g)
    for kname, by_case in cases.items():
        report[kname] = dict(by_case["bf16"], cases=by_case)


def offset_cases(torch, cases, g):
    """The forward at a query offset (``models/layers.seq_parallel``): a
    model rank's S_q query rows of a sequence of Sk keys, from position
    ``q_offset``, causal: bf16 and fp32 at hd 64 (14/2 heads) and 128
    (32/8) at an offset that is not a multiple of the kernel's 64-row q
    tile (300) and one that is (512), a window of 300 from offset 700, and
    seq_path's shares of a 16,384-token prompt (B=1, 4,096 rows, 14/2
    heads, hd 64) at the four tp=4 ranks' offsets. Each is held against
    ``ref.py`` (O and L, the update shape's tolerances; O's scale s is
    the largest Σ_j p_ij |v_j| / l_i, see below) and timed beside
    its bound from ``ops.work`` at that offset, the plain version and
    scaled_dot_product_attention with the boolean mask of
    ``ref.allowed_mask`` at that offset (the library time). The plain and
    library calls at 16,384 keys are timed over 10 calls: one plain call
    moves several GB.

    O's scale: an output row O_i = Σ_j p_ij v_j / l_i is a
    softmax-weighted mean of V's rows, and two f32 evaluations of it
    differ by the rounding of that sum, which scales with Σ_j p_ij |v_j| /
    l_i (the same attention of |V|), not with |O_i|. A whole sequence's
    first row is v[0] itself, so there the two meet; a rank's rows from an
    offset average thousands of keys, |O| falls to about 0.08 at 16,384
    while Σ p |v| / l stays near mean |v| (about 0.8), and 2^-18 max|O| is
    then below one f32 rounding of such a sum (on an H100 the fp32 route's
    rows of the last rank differed from ref.py by 1.4e-6 at max|O| 0.086).
    So s is the largest element of ``attention_fwd_ref(q, k, |v|)`` in
    f32; each case also reports its ratio under s = max|O|
    (``err_over_tol_o``, not gated) and the scale itself (``o_scale``)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (allowed_mask,
                                                         attention_fwd_ref)
    dev = "cuda"
    bf16 = (torch.bfloat16, False, 2.0 ** -7)
    f32 = (torch.float32, True, 0.0)
    for name, B, Sq, Sk, H, KV, hd, off, window, (dt, is_f32, rtol) in (
            ("bf16_off300", 4, 256, 1024, 14, 2, 64, 300, 0, bf16),
            ("fp32_off300", 4, 256, 1024, 14, 2, 64, 300, 0, f32),
            ("bf16_hd128_off512", 4, 256, 1024, 32, 8, 128, 512, 0, bf16),
            ("fp32_hd128_off512", 4, 256, 1024, 32, 8, 128, 512, 0, f32),
            ("bf16_off700_w300", 4, 256, 1024, 14, 2, 64, 700, 300, bf16),
            *((f"bf16_seq_tp4_r{r}", 1, 4096, SEQ_TOKENS, 14, 2, 64,
               4096 * r, 0, bf16) for r in range(SEQ_WORLD))):
        q = torch.randn((B, Sq, H, hd), generator=g, device=dev).to(dt)
        k, v = (torch.randn((B, Sk, KV, hd), generator=g, device=dev).to(dt)
                for _ in range(2))
        kern = lambda: fa_ops.flash_attention_fwd(q, k, v, True, window, off)
        plain = lambda: attention_fwd_ref(q, k, v, True, window, off)
        out, L = kern()
        out_r, L_r = plain()
        torch.cuda.synchronize()
        scale = lambda t: float(t.float().abs().max())
        o_scale = scale(attention_fwd_ref(q.float(), k.float(),
                                          v.float().abs(), True, window,
                                          off)[0])
        chk = [held(torch, out, out_r, 2.0 ** -18 * o_scale, rtol),
               held(torch, L, L_r, 2.0 ** -18 * scale(L_r), 0.0)]
        by_o = held(torch, out, out_r, 2.0 ** -18 * scale(out_r), rtol)
        del out, L, out_r, L_r
        case = dict(B=B, S=Sq, Sk=Sk, H=H, KV=KV, hd=hd, q_offset=off,
                    window=window,
                    max_abs_err=max(c["max_abs_err"] for c in chk),
                    atol=[c["atol"] for c in chk], rtol=rtol,
                    err_over_tol=max(c["err_over_tol"] for c in chk),
                    err_over_tol_o=by_o["err_over_tol"], o_scale=o_scale)
        if not all(c["ok"] for c in chk):
            raise AssertionError(f"flash_fwd {name}: {case}")
        mask = allowed_mask(Sq, Sk, True, window, dev, off)
        lib = lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)
        n = N_TIMED if Sk <= 1024 else 10
        nbytes, flops = fa_ops.work("fwd", B, Sq, Sk, H, KV, hd,
                                    q.element_size(), True, window, off)
        b_ms, b_by = bound((nbytes, flops), is_f32)
        case.update(ms=time_cold(torch, kern), plain_ms=time_cold(
            torch, plain, n), library_ms=time_cold(torch, lib, n),
            bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops)
        cases[name] = case
        emit({"phase": "kernels", "kernel": "flash_fwd", "case": name,
              **case})
        del q, k, v, mask
        torch.cuda.empty_cache()


def phase_spec_verify(torch, report):
    """The spec-verify kernel at the spec path's shapes: B=32 rows, K=4
    chunk queries, 14/2 heads, hd 64, 16-token pages, 256-token context
    (NP=16, full provisioning), with pools in bf16 (the main path), fp32
    and int8 (dequantised in the kernel as JAX's is; int8 pages are not an
    engine option yet), under four cases: a random fill; ragged pos with
    a partial last page (a chunk that starts a page, one that straddles
    two, one that ends a token short of a page); an unmapped chunk page
    (row 0 loses its chunk's second page; row 1 has no page, so its
    queries are fully masked and give 0); K=1; and chunk edges (queries
    ending at the kernel's chunk boundary or one past it, verify chunks
    straddling two kernel chunks, rows with a whole kernel chunk
    unmapped). Then in bf16 at NP=128 (2,048 tokens, 8 chunks), and at
    K=8 (56 query rows: the layout of 32 warps of four rows each, held to
    64 registers by its 1,024 threads). Each is
    held elementwise against ref.py by the paged kernel's rule, then every
    query j against the paged kernel at lens = pos + j + 1 on the same
    pool and q rows, with exact equality (0 ulp). Timed with time_cold
    beside its bound (each live K/V element read once; 4 hd flops per
    valid (query head, key) pair at the peak rate of q's type) and the
    plain version;
    the bf16 fill case also profiled (one launch per call) and timed under
    8 chunks against the plan's 4. No single PyTorch call computes it."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.spec_verify import ops as sv_ops
    from repro_torch.kernels.spec_verify.ref import spec_verify_attention_ref

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(8)
    B, H, KV, hd, ps = 32, 14, 2, 64, 16
    group = H // KV
    perms = {}
    # pos at the kernel's chunk edges (64, 128, 192 at NP=16)
    edges = [60, 61, 63, 64, 124, 125, 127, 128, 188, 189, 191, 192, 0, 252]
    cases = {}
    for cname, K, NP in (("fill", 4, 16), ("ragged", 4, 16),
                         ("unmapped", 4, 16), ("k1", 1, 16),
                         ("edges", 4, 16), ("s2048", 4, 128),
                         ("k8", 8, 16)):
        P = B * NP + 1
        if NP not in perms:          # NP=16's first: its cases' data stay
            perm = torch.randperm(P - 1, generator=g, device=dev)[:B * NP]
            perms[NP] = perm.reshape(B, NP).to(torch.int32)
        idx = torch.arange(NP * ps, device=dev)
        pos = torch.randint(0, NP * ps - K + 1, (B,), generator=g,
                            device=dev)
        if cname == "ragged":
            pos[:3] = torch.tensor([2 * ps, ps - 2, 2 * ps - K - 1])
        if cname == "unmapped":
            pos[:2] = torch.tensor([ps - 2, 0])
        if cname == "edges":
            pos = torch.tensor([edges[i % len(edges)] for i in range(B)],
                               device=dev)
        pos = pos.to(torch.int32)
        npages = (pos + K + ps - 1) // ps
        bt = torch.where(torch.arange(NP, device=dev)[None, :]
                         < npages[:, None], perms[NP], -1)
        if cname == "unmapped":
            bt[0, 1] = -1
            bt[1] = -1
        if cname == "edges":
            for r in (7, 11, 13):    # pos 128, 192, 252: chunk 1 unmapped
                bt[r, 4:8] = -1
        bt = bt.contiguous()
        mapped = (bt >= 0)[:, :, None].expand(B, NP, ps).reshape(B, NP * ps)
        qpos = pos[:, None] + torch.arange(K, device=dev)[None, :]
        valid = (idx[None, None, :] <= qpos[:, :, None]) & mapped[:, None]
        pairs = int(valid.sum()) * H                 # (query head, key)
        live = int(valid.any(dim=1).sum())           # K/V positions read
        for dname, qdt, kvdt, rtol in (
                ("bf16", torch.bfloat16, torch.bfloat16, 2.0 ** -7),
                ("fp32", torch.float32, torch.float32, 0.0),
                ("int8", torch.bfloat16, torch.int8, 2.0 ** -7)):
            if cname in ("s2048", "k8") and dname != "bf16":
                continue
            q = torch.randn((B, K, H, hd), generator=g, device=dev).to(qdt)
            if kvdt == torch.int8:
                kp, vp = (torch.randint(-127, 128, (P, ps, KV, hd),
                                        generator=g, device=dev).to(
                                            torch.int8) for _ in range(2))
                ks, vs = (torch.rand((P, ps, KV), generator=g, device=dev)
                          / 127 for _ in range(2))
            else:
                kp, vp = (torch.randn((P, ps, KV, hd), generator=g,
                                      device=dev).to(kvdt)
                          for _ in range(2))
                ks = vs = None
            out = sv_ops.spec_verify_attention(q, kp, vp, bt, pos,
                                               k_scales=ks, v_scales=vs)
            ref = spec_verify_attention_ref(q, kp, vp, bt, pos, ks, vs)
            torch.cuda.synchronize()
            name = f"{dname}_{cname}"
            chk = held(torch, out, ref,
                       2.0 ** -18 * float(ref.float().abs().max()), rtol)
            if not chk["ok"]:
                raise AssertionError(f"spec_verify {name}: {chk}")
            if cname == "unmapped" and bool((out[1] != 0).any()):
                raise AssertionError("spec_verify: a fully masked query "
                                     "row is not zero")
            diff_q = [j for j in range(K) if not torch.equal(
                out[:, j], pa_ops.paged_decode_attention(
                    q[:, j].contiguous(), kp, vp, bt, pos + j + 1,
                    k_scales=ks, v_scales=vs))]
            if diff_q:
                raise AssertionError(f"spec_verify {name}: queries {diff_q} "
                                     f"differ from the paged kernel")
            nbytes, flops = sv_ops.work(B, K, H, KV, hd, NP, ps,
                                        q.element_size(), kp.element_size(),
                                        ks is not None, live, pairs)
            b_ms, b_by = bound((nbytes, flops), qdt != torch.bfloat16)
            case = dict(
                chk, paged_kernel_bitwise=True,
                ms=time_cold(torch, lambda: sv_ops.spec_verify_attention(
                    q, kp, vp, bt, pos, k_scales=ks, v_scales=vs)),
                plain_ms=time_cold(torch, lambda: spec_verify_attention_ref(
                    q, kp, vp, bt, pos, ks, vs)),
                bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                flops=4 * hd * pairs, K=K, group=group,
                plan=pa_ops.split_plan(B * KV, NP, ps, _build.sm_count(0)))
            if name == "bf16_fill":
                case["profile"] = kernel_profile(
                    torch, lambda: sv_ops.spec_verify_attention(
                        q, kp, vp, bt, pos), SPEC_SYMBOLS)
                # the paged kernel's probe: 8 one-tile chunks against the
                # plan's 4 two-tile chunks, in turns
                probe = {}
                for plan in ((4, 4), (2, 8), (2, 8), (4, 4)):
                    alt = sv_ops._launch(q, kp, vp, bt, pos, None, None,
                                         plan)
                    torch.cuda.synchronize()
                    achk = held(torch, alt, ref, chk["atol"], rtol)
                    if not achk["ok"]:
                        raise AssertionError(f"spec_verify plan {plan}: "
                                             f"{achk}")
                    probe.setdefault(f"{plan[1]}_chunks_ms", []).append(
                        time_cold(torch, lambda: sv_ops._launch(
                            q, kp, vp, bt, pos, None, None, plan)))
                case["split_probe"] = probe
            cases[name] = case
            emit({"phase": "kernels", "kernel": "spec_verify", "case": name,
                  **case})
    # the main path: bf16 q against the bf16 pool, K=4 over a filled pool
    report["spec_verify"] = dict(cases["bf16_fill"], cases=cases)


# The kernels' symbols (substrings of the profiler's names).
SAMPLE_SYMBOLS = ("fused_sample_kernel",)
SSD_SYMBOLS = ("ssd_tc_kernel", "ssd_simt_kernel")
DECODE_SYMBOLS = ("decode_attention_kernel",)
PAGED_SYMBOLS = ("paged_decode_kernel",)
SPEC_SYMBOLS = ("spec_verify_kernel",)


def phase_decode(torch, report):
    """The decode attention kernel at the dense cache's shapes: B=32 rows,
    S=256 slots, 14/2 heads, hd 64, bf16 (the main path) and fp32, under
    four masks, and in bf16 at S=2048 under a random fill, and at
    granite-moe's (24/8) and zamba2's (32/32) heads, and at whisper's
    (B=16, S=96, 20/20) and llama-vision's (B=4, S=128, 32/8 x 128)
    serving caches. Each case is
    held against ``ref.py`` and timed beside its bound, the plain version
    and torch's scaled_dot_product_attention with a boolean mask
    (library_ms; the port never calls it). The bf16 fill case also
    reports its device profile (``kernel_profile``): one launch per
    call."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(6)
    B, S, H, KV, hd = 32, 256, 14, 2, 64
    idx = torch.arange(S, device=dev)[None, :]
    fill = torch.randint(1, S, (B, 1), generator=g, device=dev)
    ring = torch.randint(S, 3 * S, (B, 1), generator=g, device=dev)
    kpos = ring - torch.remainder(ring - idx, S)
    masks = {
        "fill": idx <= fill,
        # a ring that has wrapped, with a window of 160 positions
        "ring_window": (kpos >= 0) & (kpos <= ring) & (kpos > ring - 160),
        # keys valid only from slot 40 on: the first 32-key tile is empty
        "late_start": (idx >= 40) & (idx <= fill.clamp_min(40)),
        "masked_row": (idx <= fill) & (torch.arange(B, device=dev)[:, None]
                                       != 0),
    }
    cases = {}

    # Tolerances as for paged attention: f32 outputs within 32 f32 ulps of
    # the case's output scale s = max|ref| (atol 2^-18 s); bf16 adds one
    # bf16 ulp of each element (rtol 2^-7).
    def run_case(name, q, k, v, valid, is_f32, rtol):
        out = da_ops.decode_attention(q, k, v, valid)
        ref = decode_attention_ref(q, k, v, valid)
        torch.cuda.synchronize()
        chk = held(torch, out, ref,
                   2.0 ** -18 * float(ref.float().abs().max()), rtol)
        if not chk["ok"]:
            raise AssertionError(f"decode_attention {name}: {chk}")
        # The least work (``da_ops.work``) over this mask's valid keys
        Bq, Sk = valid.shape
        _, _, kvh, d = k.shape
        n_valid = valid.sum(1)
        n_keys, n_empty = int(n_valid.sum()), int((n_valid == 0).sum())
        nbytes, flops = da_ops.work(Bq, q.shape[1], kvh, d, Sk,
                                    q.element_size(), k.element_size(),
                                    n_keys, n_empty)
        b_ms, b_by = bound((nbytes, flops), is_f32)
        am = valid[:, None, None, :]
        case = dict(
            chk,
            ms=time_cold(torch, lambda: da_ops.decode_attention(
                q, k, v, valid)),
            plain_ms=time_cold(torch, lambda: decode_attention_ref(
                q, k, v, valid)),
            library_ms=time_cold(
                torch, lambda: F.scaled_dot_product_attention(
                    q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                    attn_mask=am, enable_gqa=True)),
            bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops,
            valid_keys=n_keys)
        if name == "bf16_fill":
            case["profile"] = kernel_profile(
                torch, lambda: da_ops.decode_attention(q, k, v, valid),
                DECODE_SYMBOLS)
        cases[name] = case
        emit({"phase": "kernels", "kernel": "decode_attention",
              "case": name, **case})

    for dname, dt, is_f32, rtol in (("bf16", torch.bfloat16, False,
                                     2.0 ** -7),
                                    ("fp32", torch.float32, True, 0.0)):
        q = torch.randn((B, H, hd), generator=g, device=dev).to(dt)
        k, v = (torch.randn((B, S, KV, hd), generator=g, device=dev).to(dt)
                for _ in range(2))
        for mname, valid in masks.items():
            run_case(f"{dname}_{mname}", q, k, v, valid.contiguous(),
                     is_f32, rtol)
    # a long context, S=2048 in bf16 under a random fill, where each block
    # walks eight tiles
    S = 2048
    fill = torch.randint(1, S, (B, 1), generator=g, device=dev)
    q = torch.randn((B, H, hd), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((B, S, KV, hd), generator=g, device=dev).bfloat16()
            for _ in range(2))
    run_case("bf16_fill_s2048", q, k, v,
             (torch.arange(S, device=dev)[None, :] <= fill).contiguous(),
             False, 2.0 ** -7)
    # the dense caches of granite-moe-3b-a800m (24/8 heads: group 3) and
    # of zamba2-1.2b's attention sites (32/32: group 1), bf16, at S=256
    S = 256
    fill = torch.randint(1, S, (B, 1), generator=g, device=dev)
    for name, Hc, KVc in (("bf16_fill_granite", 24, 8),
                          ("bf16_fill_zamba2", 32, 32)):
        q = torch.randn((B, Hc, hd), generator=g, device=dev).bfloat16()
        k, v = (torch.randn((B, S, KVc, hd), generator=g,
                            device=dev).bfloat16() for _ in range(2))
        run_case(name, q, k, v,
                 (torch.arange(S, device=dev)[None, :] <= fill).contiguous(),
                 False, 2.0 ** -7)
    # audio_serve's decode (whisper-large-v3: B=16, 20/20 heads, a 96-slot
    # ring filled past its 64-token prompt) and the llama-3.2-vision-11b
    # card test's (B=4, 32/8 heads x 128, 128 slots)
    for name, Bc, S, Hc, KVc, hdc in (("bf16_fill_whisper", 16, 96, 20, 20,
                                       64),
                                      ("bf16_fill_vision", 4, 128, 32, 8,
                                       128)):
        fill = torch.randint(64, S, (Bc, 1), generator=g, device=dev)
        q = torch.randn((Bc, Hc, hdc), generator=g, device=dev).bfloat16()
        k, v = (torch.randn((Bc, S, KVc, hdc), generator=g,
                            device=dev).bfloat16() for _ in range(2))
        run_case(name, q, k, v,
                 (torch.arange(S, device=dev)[None, :] <= fill).contiguous(),
                 False, 2.0 ** -7)
    # one rank of qwen2-0.5b at tp=2 (tp_path's folded reference): 7 q
    # heads on one kv head, B=32, S=256
    fill = torch.randint(1, 256, (B, 1), generator=g, device=dev)
    q = torch.randn((B, 7, hd), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((B, 256, 1, hd), generator=g, device=dev).bfloat16()
            for _ in range(2))
    run_case("bf16_fill_tp2", q, k, v,
             (torch.arange(256, device=dev)[None, :] <= fill).contiguous(),
             False, 2.0 ** -7)
    # one rank of the families at tp=2 (tp_path's dense caches: B=8, 96
    # slots, fp32 and bf16): granite-moe's policy stream and folded
    # reference at 12/4 heads, zamba2's sites at 16/16
    Bt, St = TP_BATCH, TP_FAMILY_PATH["max_context"]
    fill = torch.randint(1, St, (Bt, 1), generator=g, device=dev)
    valid = (torch.arange(St, device=dev)[None, :] <= fill).contiguous()
    for fam, Hc, KVc in (("granite", 12, 4), ("zamba2", 16, 16)):
        for dname, dt, is_f32, rtol in (("bf16", torch.bfloat16, False,
                                         2.0 ** -7),
                                        ("fp32", torch.float32, True,
                                         0.0)):
            q = torch.randn((Bt, Hc, hd), generator=g, device=dev).to(dt)
            k, v = (torch.randn((Bt, St, KVc, hd), generator=g,
                                device=dev).to(dt) for _ in range(2))
            run_case(f"{dname}_fill_{fam}_tp2", q, k, v, valid, is_f32,
                     rtol)
    # the main path: the bf16 reference stream over a filling cache
    report["decode_attention"] = dict(cases["bf16_fill"], cases=cases)


def phase_ssd(torch, report):
    """The SSD scan kernel against ref.py (the model's chunked form) on
    the card: the ssm_score shape (B=32, S=512, 32 heads x 64, state 128,
    one group, chunk 256: two chunks) in bf16 (the main path, on the
    tensor cores) and fp32 (the f32 route); S=1,024 (four chunks, B=8); a
    ragged S=300 (B=8; padded to 512 with zero-dt steps); four groups at
    a narrow shape (p=32: the f32 route). Inputs in the mixer's layout: x,
    B and C strided views of one xbc tensor. Tolerances at each output's
    scale s = max|ref|: y and the final state at fp32, and the state at
    bf16, within 32 f32 ulps of s (atol 2^-18 s: the same f32 math in
    another order); y at bf16 within 2^-6 s plus one bf16 ulp of each
    element (rtol 2^-7), because the plain form rounds W and W x to bf16
    before its sums where the kernel keeps f32 (as the TPU kernel does;
    on the tensor cores W is split hi + lo): at the ssm_score shape both
    are also held against an f64 evaluation of the plain form, and their
    errors reported. Timed with time_cold beside the bound (bytes, or
    operations at the inputs' type's peak, the Gram counted once per
    group) and the plain version. No single PyTorch call computes it. At
    the bf16 ssm_score shape also the device profile (one launch per call);
    at the ssm_score and four-group shapes the head-tile probe (two heads
    a block against one on the plan's route, in turns, each held against
    ref.py first)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_ref
    from repro_torch.utils.roofline import H100

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(13)
    cases = {}
    for cname, (b, s, h, gg, p, n, q), dnames in (
            ("score", (32, 512, 32, 1, 64, 128, 256), ("bf16", "fp32")),
            ("s1024", (8, 1024, 32, 1, 64, 128, 256), ("bf16",)),
            ("ragged300", (8, 300, 32, 1, 64, 128, 256), ("bf16",)),
            ("groups4", (4, 256, 16, 4, 32, 64, 64), ("bf16", "fp32"))):
        for dname in dnames:
            dt_ = torch.bfloat16 if dname == "bf16" else torch.float32
            xbc = (torch.randn((b, s, h * p + 2 * gg * n), generator=g,
                               device=dev) * 0.5).to(dt_)
            x = xbc[..., :h * p].reshape(b, s, h, p)
            Bm = xbc[..., h * p:h * p + gg * n].reshape(b, s, gg, n)
            Cm = xbc[..., h * p + gg * n:].reshape(b, s, gg, n)
            dt = torch.nn.functional.softplus(
                torch.randn((b, s, h), generator=g, device=dev))
            A = -torch.exp(torch.randn((h,), generator=g, device=dev) * 0.3)
            y, fin = ssd_ops.ssd_scan(x, dt, A, Bm, Cm, q)
            yr, finr = ssd_ref(x, dt, A, Bm, Cm, q)
            torch.cuda.synchronize()
            sy = float(yr.float().abs().max())
            sf = float(finr.abs().max())
            bf = dt_ == torch.bfloat16
            cy = held(torch, y, yr, (2.0 ** -6 if bf else 2.0 ** -18) * sy,
                      2.0 ** -7 if bf else 0.0)
            cf = held(torch, fin, finr, 2.0 ** -18 * sf, 0.0)
            name = f"{dname}_{cname}"
            if not (cy["ok"] and cf["ok"]) or y.shape != x.shape:
                raise AssertionError(f"ssd_scan {name}: y {cy}, state {cf}")
            extra = {}
            if cname == "score":
                y64, _ = ssd_ref(x.double(), dt.double(), A.double(),
                                 Bm.double(), Cm.double(), q)
                extra = dict(
                    plain_err_vs_f64=float((yr.double() - y64).abs().max()),
                    kernel_err_vs_f64=float((y.double() - y64).abs().max()))
                del y64
            nbytes, flops = ssd_ops.work(b, s, h, gg, p, n, q,
                                         x.element_size())
            b_ms, b_by = bound((nbytes, flops), not bf)
            case = dict(
                max_abs_err=max(cy["max_abs_err"], cf["max_abs_err"]),
                atol=[cy["atol"], cf["atol"]], rtol=cy["rtol"],
                err_over_tol=max(cy["err_over_tol"], cf["err_over_tol"]),
                y_scale=sy, state_scale=sf, **extra,
                ms=time_cold(torch, lambda: ssd_ops.ssd_scan(
                    x, dt, A, Bm, Cm, q)),
                plain_ms=time_cold(torch, lambda: ssd_ref(x, dt, A, Bm, Cm,
                                                          q)),
                bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops,
                f32_fma_floor_ms=flops / H100.f32_flops * 1e3,
                plan=ssd_ops.plan(dt_, p, n, q, h // gg, b * h,
                                  _build.sm_count(0),
                                  ssd_ops._tma_ready(x, Bm, Cm)),
                shape=dict(b=b, s=s, h=h, g=gg, p=p, n=n, chunk=q))
            if name == "bf16_score":
                case["profile"] = kernel_profile(
                    torch, lambda: ssd_ops.ssd_scan(x, dt, A, Bm, Cm, q),
                    SSD_SYMBOLS)
                if case["profile"]["launches_per_call"] != 1:
                    raise AssertionError(f"ssd_scan: {case['profile']}")
            if cname in ("score", "groups4"):
                dtc = dt.float().contiguous()
                dA = (dtc * A.float()[None, None, :]).contiguous()
                probe = {}
                route = case["plan"][0]
                for plan in ((route, 2), (route, 1), (route, 1), (route, 2)):
                    yp, fp = ssd_ops._launch(x, dtc, dA, Bm, Cm, q, plan)
                    torch.cuda.synchronize()
                    py = held(torch, yp, yr, (2.0 ** -6 if bf else 2.0 ** -18)
                              * sy, 2.0 ** -7 if bf else 0.0)
                    pf = held(torch, fp, finr, 2.0 ** -18 * sf, 0.0)
                    if not (py["ok"] and pf["ok"]):
                        raise AssertionError(f"ssd_scan plan {plan}: y {py}, "
                                             f"state {pf}")
                    probe.setdefault(f"heads_{plan[1]}_ms", []).append(
                        time_cold(torch, lambda: ssd_ops._launch(
                            x, dtc, dA, Bm, Cm, q, plan)))
                case["head_tile_probe"] = probe
            cases[name] = case
            emit({"phase": "kernels", "kernel": "ssd_scan", "case": name,
                  **case})
    # the main path: ExpPrep's bf16 scoring pass at the ssm_score shape
    report["ssd_scan"] = dict(cases["bf16_score"], cases=cases)


# ---------------------------------------------------------------------------
def count_calls(obj, name: str) -> list:
    """Replace the method ``obj.name`` by one that records each call in the
    returned list (one entry per call) and then calls the original."""
    calls, orig = [], getattr(obj, name)

    def counted(*args, **kw):
        calls.append(1)
        return orig(*args, **kw)
    setattr(obj, name, counted)
    return calls


PATH = dict(cache_layout="paged", attn_impl="paged", sampling="fused",
            temperature=1.0, max_turns=4, max_turn_tokens=32,
            max_context=256, page_size=16)
# the trace and ref_trace phases profile the path's settings on the first
# TRACE_LAYERS layers of the same weights: profiling one full-depth
# macro-step with the reference stream took 133 s of the script's 703 s
# on an H100, 71 s at 12 layers, and each layer's device work is
# the same at any depth
TRACE_LAYERS = 6
# the depth of async_train's lag-1 fault-and-restart run (b)
FAULT_LAYERS = 6


def phase_path(torch, model, params, report):
    from repro_torch.kernels.fused_sample import ops as fs_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.rl.engine import CompiledRolloutEngine
    from repro_torch.rl.envs import TicTacToe

    engine = CompiledRolloutEngine(model, TicTacToe(), **PATH)
    gen = torch.Generator(device="cuda").manual_seed(2)
    t0 = time.perf_counter()
    engine.run(params, 32, 64, generator=gen)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    pa_ops.reset_launches()
    fs_ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exp, st = engine.run(params, 32, 64, generator=gen)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    pa_n, fs_n = pa_ops.launches, fs_ops.launches

    gen_tokens = int(exp.gen_mask.sum())
    decode_steps = pa_n // model.cfg.n_layers
    ok = (st.episodes_started == st.episodes_returned == 64
          and st.kv_dropped_writes == 0 and pa_n > 0 and fs_n > 0
          and pa_n % model.cfg.n_layers == 0
          and bool(torch.isfinite(exp.logprobs).all())
          and bool((exp.context_len > 0).all()))
    out = dict(phase="path", seconds=secs, warmup_seconds=warm_s,
               generated_tokens=gen_tokens, tokens_per_s=gen_tokens / secs,
               decode_steps=decode_steps,
               decode_steps_per_s=decode_steps / secs,
               paged_attention_launches=pa_n, fused_sample_launches=fs_n,
               paged_attention_per_decode_step=pa_n / max(decode_steps, 1),
               episodes_started=st.episodes_started,
               episodes_returned=st.episodes_returned,
               kv_dropped_writes=st.kv_dropped_writes,
               pages_in_use=st.pages_in_use, page_capacity=st.page_capacity,
               mean_context_len=st.mean_context_len,
               mean_turn_len=st.mean_turn_len, mean_return=st.mean_return,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    emit(out)
    if not ok:
        raise AssertionError(f"path checks failed: {out}")
    report["paged_attention"]["launches"] = pa_n
    report["fused_sample"]["launches"] = fs_n
    return engine


def phase_dense_path(torch, model, params, report):
    """The engine on the dense layout with the split-K kernel, at the
    path phase's settings (B=32 slots, 64 episodes, refill on): one run
    with every counter set to 0 just before it and read just after."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.fused_sample import ops as fs_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.rl.engine import CompiledRolloutEngine
    from repro_torch.rl.envs import TicTacToe

    engine = CompiledRolloutEngine(
        model, TicTacToe(), cache_layout="dense", attn_impl="pallas",
        sampling="fused", temperature=1.0, max_turns=4, max_turn_tokens=32,
        max_context=256)
    gen = torch.Generator(device="cuda").manual_seed(7)
    for ops in (da_ops, fs_ops, pa_ops):
        ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exp, st = engine.run(params, 32, 64, generator=gen)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    da_n, fs_n, pa_n = da_ops.launches, fs_ops.launches, pa_ops.launches
    mtt, olen = engine.max_turn_tokens, engine.env.obs_len
    n_macro = fs_n // mtt
    decode_steps = olen + n_macro * (mtt + olen)
    gen_tokens = int(exp.gen_mask.sum())
    ok = (st.episodes_started == st.episodes_returned == 64
          and fs_n == n_macro * mtt > 0 and pa_n == 0
          and da_n == model.cfg.n_layers * decode_steps
          and st.pages_in_use == st.page_capacity == 0
          and bool(torch.isfinite(exp.logprobs).all())
          and bool((exp.context_len > 0).all()))
    out = dict(phase="dense_path", seconds=secs,
               generated_tokens=gen_tokens, tokens_per_s=gen_tokens / secs,
               macro_steps=n_macro, decode_steps=decode_steps,
               decode_steps_per_s=decode_steps / secs,
               decode_attention_launches=da_n,
               expected_decode_attention_launches=(model.cfg.n_layers
                                                   * decode_steps),
               fused_sample_launches=fs_n, paged_attention_launches=pa_n,
               episodes_started=st.episodes_started,
               episodes_returned=st.episodes_returned,
               mean_context_len=st.mean_context_len,
               mean_turn_len=st.mean_turn_len, mean_return=st.mean_return,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    emit(out)
    if not ok:
        raise AssertionError(f"dense_path checks failed: {out}")
    report["dense_path_launches"] = da_n
    return engine


def phase_branch(torch, model, params):
    """One teacher-forced stream (12 observation tokens then 32
    generated-length tokens, 32 rows) through decode_step four ways from
    the same empty bf16 caches: the paged kernel and the gather path on
    the paged pool (branch), the split-K kernel and plain attention on the
    dense cache (dense_branch), and the dense kernel against the paged
    kernel. bf16 model: every branch reads the same bf16 K/V, but the plain
    branches run their softmax weights and P@V in bf16 while the kernels
    stay f32, a few bf16 ulps of drift per layer over 24 layers: 5% of the
    logit scale, the tolerance PR 11 set for the paged branch."""
    cfg = model.cfg
    B, steps = 32, 12 + 32
    g = torch.Generator(device="cuda").manual_seed(3)
    stream = torch.randint(0, cfg.vocab_size, (steps, B), generator=g,
                           device="cuda").to(torch.int32)
    logits = {}
    for layout, impl in (("paged", "paged"), ("paged", "xla"),
                         ("dense", "pallas"), ("dense", "xla")):
        cache = model.init_cache(B, 256, layout=layout, kv_dtype="bf16",
                                 device="cuda")
        outs = []
        for t in range(steps):
            lg, cache = model.decode_step(params, stream[t], cache,
                                          attn_impl=impl)
            outs.append(lg.float())
        logits[layout, impl] = torch.stack(outs)

    def compare(phase, a, b, **extra):
        d = (logits[a] - logits[b]).abs()
        scale = float(logits[b].abs().max())
        top1 = float((logits[a].argmax(-1)
                      == logits[b].argmax(-1)).float().mean())
        tol = 0.05 * scale
        out = dict(phase=phase, max_abs_dlogit=float(d.max()),
                   mean_abs_dlogit=float(d.mean()), logit_scale=scale,
                   tolerance=tol, top1_agreement=top1, **extra)
        emit(out)
        if not float(d.max()) <= tol or not bool(torch.isfinite(d).all()):
            raise AssertionError(f"{phase}: branches disagree: {out}")

    compare("branch", ("paged", "paged"), ("paged", "xla"))
    compare("dense_branch", ("dense", "pallas"), ("dense", "xla"),
            against="dense xla")
    compare("dense_branch", ("dense", "pallas"), ("paged", "paged"),
            against="paged kernel")


def device_busy(torch, prof, averages):
    """Union of the device intervals (kernels, copies, fills) a profiler
    trace holds, in ms, with their count and the five kernels that took the
    most device time (from ``averages``, the trace's ``key_averages()``,
    which its caller reuses: each call walks every event again); (None, 0,
    []) when the trace holds no device event."""
    from torch.autograd import DeviceType
    iv = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                if e.device_type == DeviceType.CUDA)
    busy_us, lo, hi = 0.0, None, None
    for s, e in iv:
        if hi is None or s > hi:
            busy_us += 0.0 if hi is None else hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    if hi is None:
        return None, 0, []
    busy_us += hi - lo

    top = sorted(((a.key[:90], a.self_device_time_total / 1e3, a.count)
                  for a in averages if a.device_type == DeviceType.CUDA),
                 key=lambda r: -r[1])[:5]
    return busy_us / 1e3, len(iv), top


def phase_macro_step(torch, engine, dense_engine, params):
    """One macro-step of the path's engine under
    set_sync_debug_mode("error") (the one-sync-per-turn contract), and one
    of the dense engine with the folded reference stream. Then the path's
    settings on the first TRACE_LAYERS layers: a macro-step to warm, one
    timed on the host clock, one under torch.profiler for the device's
    busy time (idle share = 1 - busy / unprofiled wall time); and the
    same engine with the folded reference stream (the train step's
    route): one macro-step to warm, the next under torch.profiler for
    decode attention's device time and launches (exactly one per layer
    per decode step of the reference stream). Both traces record the
    device's activity only: every number they give is a device event's,
    and host-side events multiplied the traces' post-processing."""
    noise = engine.default_noise(torch.Generator(device="cuda").manual_seed(4))
    dc = dense_engine.init_feed(
        params, dense_engine.init_carry(32, 64, with_ref=True), params)
    carry = engine.init_feed(params, engine.init_carry(32, 64))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        carry = engine.turn_step(params, carry, 0, noise)
        dc = dense_engine.turn_step(params, dc, 0, noise, ref_params=params)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    emit({"phase": "sync", "macro_steps_checked": 2,
          "checked": ["paged", "dense with the reference stream"],
          "returned_after_one_turn": int(carry.returned),
          "dense_returned_after_one_turn": int(dc.returned),
          "dense_ref_logprobs_finite": bool(
              torch.isfinite(dc.ref_logprobs).all())})
    del dc, carry

    from repro_torch.models import transformer
    from repro_torch.models.registry import build_model
    from repro_torch.rl.engine import CompiledRolloutEngine
    from repro_torch.rl.envs import TicTacToe
    model = build_model(dataclasses.replace(engine.model.cfg,
                                            n_layers=TRACE_LAYERS))
    params = transformer.draft_params_view(params, TRACE_LAYERS)
    engine = CompiledRolloutEngine(model, TicTacToe(), **PATH)
    carry = engine.init_feed(params, engine.init_carry(32, 64))
    carry = engine.turn_step(params, carry, 0, noise)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.paged_attention import ops as pa_ops
    t0 = time.perf_counter()
    carry = engine.turn_step(params, carry, 1, noise)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    pa_ops.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        carry = engine.turn_step(params, carry, 2, noise)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    n_pa = pa_ops.launches
    averages = prof.key_averages()
    busy_ms, n_events, top = device_busy(torch, prof, averages)
    pa_ms = sum(a.self_device_time_total for a in averages
                if a.device_type == DeviceType.CUDA
                and any(sym in a.key for sym in PAGED_SYMBOLS)) / 1e3
    steps = engine.max_turn_tokens + engine.env.obs_len
    expected = engine.model.cfg.n_layers * steps
    out = {"phase": "trace", "n_layers": TRACE_LAYERS,
           "decode_steps_per_macro_step": steps,
           "wall_ms": wall_ms, "profiled_wall_ms": prof_wall_ms,
           "device_busy_ms": busy_ms,
           "device_idle_share": (None if busy_ms is None
                                 else 1.0 - busy_ms / wall_ms),
           "device_events": n_events,
           "device_events_per_decode_step": n_events / steps,
           "paged_attention_device_ms": pa_ms,
           "paged_attention_launches": n_pa,
           "expected_paged_attention_launches": expected,
           "paged_attention_us_per_launch": (1e3 * pa_ms / n_pa
                                             if n_pa else None),
           "top_device_ms": top}
    emit(out)
    if n_pa != expected or not pa_ms > 0:
        raise AssertionError(f"trace: paged attention launched {n_pa} "
                             f"times (expected {expected}) or read no "
                             f"device time: {out}")
    del carry

    # The train step's route: the paged policy with the reference stream
    # folded in on its dense cache, where decode attention runs once per
    # layer per decode step. One macro-step to warm, the next traced.
    from repro_torch.kernels.decode_attention import ops as da_ops
    rc = engine.init_feed(params, engine.init_carry(32, 64, with_ref=True),
                          params)
    rc = engine.turn_step(params, rc, 0, noise, ref_params=params)
    torch.cuda.synchronize()
    da_ops.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rc = engine.turn_step(params, rc, 1, noise, ref_params=params)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    n_da = da_ops.launches
    averages = prof.key_averages()
    busy_ms, n_events, top = device_busy(torch, prof, averages)
    da_ms = sum(a.self_device_time_total for a in averages
                if a.device_type == DeviceType.CUDA
                and any(sym in a.key for sym in DECODE_SYMBOLS)) / 1e3
    expected = engine.model.cfg.n_layers * steps
    out = {"phase": "ref_trace", "n_layers": TRACE_LAYERS,
           "decode_steps": steps,
           "profiled_wall_ms": prof_wall_ms, "device_busy_ms": busy_ms,
           "device_events": n_events,
           "decode_attention_device_ms": da_ms,
           "decode_attention_launches": n_da,
           "expected_decode_attention_launches": expected,
           "decode_attention_us_per_launch": (1e3 * da_ms / n_da
                                              if n_da else None),
           "top_device_ms": top}
    emit(out)
    if n_da != expected or not da_ms > 0:
        raise AssertionError(f"ref_trace: decode attention launched "
                             f"{n_da} times (expected {expected}) or read "
                             f"no device time: {out}")


# the depth the speculative phases and the paged pool's second half (all
# but preempt_path) run qwen2-0.5b at (of its 24 layers): views of the
# path's weights; their draft takes half of it, JAX's default. At 10
# layers shared_spec's greedy tokens with speculation on and off part at
# one near-tie (ROADMAP Queue 3), so it stays at 12
CUT_LAYERS = 12

SPEC = dict(cache_layout="paged", attn_impl="paged", sampling="reference",
            speculation="self", spec_k=4, draft_layers=CUT_LAYERS // 2,
            max_turns=4, max_turn_tokens=32, max_context=256, page_size=16)


def phase_spec_path(torch, model, params, report):
    """Full-width qwen2-0.5b at CUT_LAYERS of its 24 layers through the
    engine with speculation="self" (spec_k 4, draft_layers CUT_LAYERS //
    2, JAX's default of n_layers // 2) on the
    paged pool, sampling="reference", temperature 1.0, B=32 slots, 64
    episodes: one warm-up of one turn, then one run with every launch
    counter set to 0 just before it. The verify rounds are counted on the
    host (each is one call of the round helper). Gates: every episode
    returned, 0 dropped writes, accepted <= proposed, the mean accepted
    length (accepted + rounds) / rounds in [1, K], exactly one spec-verify
    launch per layer per round, one paged attention per layer per fed
    column (the initial feed and one obs feed per macro-step: the draft
    runs plain attention, as in JAX), and no fused sampling."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.fused_sample import ops as fs_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.spec_verify import ops as sv_ops
    from repro_torch.rl.engine import CompiledRolloutEngine
    from repro_torch.rl.envs import TicTacToe

    gen = torch.Generator(device="cuda").manual_seed(9)
    t0 = time.perf_counter()
    CompiledRolloutEngine(model, TicTacToe(), temperature=1.0,
                          **dict(SPEC, max_turns=1)).run(params, 32, 32,
                                                         generator=gen)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    engine = CompiledRolloutEngine(model, TicTacToe(), temperature=1.0,
                                   **SPEC)
    rounds = count_calls(engine, "_more_rounds")
    turns = count_calls(engine, "turn_step")
    for ops in (sv_ops, pa_ops, fs_ops, da_ops):
        ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exp, st = engine.run(params, 32, 64, generator=gen)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    nl, olen, K = model.cfg.n_layers, engine.env.obs_len, engine.spec_k
    counts = dict(spec_verify=sv_ops.launches,
                  paged_attention=pa_ops.launches,
                  fused_sample=fs_ops.launches,
                  decode_attention=da_ops.launches)
    expected = dict(spec_verify=nl * len(rounds),
                    paged_attention=nl * olen * (1 + len(turns)),
                    fused_sample=0, decode_attention=0)
    gen_tokens = int(exp.gen_mask.sum())
    mean_len = (st.spec_accepted + st.spec_rounds) / max(st.spec_rounds, 1)
    out = dict(phase="spec_path", seconds=secs, warmup_seconds=warm_s,
               generated_tokens=gen_tokens, tokens_per_s=gen_tokens / secs,
               macro_steps=len(turns), verify_rounds=len(rounds),
               rounds_per_turn=len(rounds) / max(len(turns), 1),
               spec_proposed=st.spec_proposed,
               spec_accepted=st.spec_accepted, spec_rounds=st.spec_rounds,
               acceptance=st.spec_accepted / max(st.spec_proposed, 1),
               mean_accepted_len=mean_len, launches=counts,
               expected_launches=expected,
               spec_verify_per_round=counts["spec_verify"]
               / max(len(rounds), 1),
               episodes_started=st.episodes_started,
               episodes_returned=st.episodes_returned,
               kv_dropped_writes=st.kv_dropped_writes,
               pages_in_use=st.pages_in_use, page_capacity=st.page_capacity,
               mean_context_len=st.mean_context_len,
               mean_turn_len=st.mean_turn_len, mean_return=st.mean_return,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    emit(out)
    if not (st.episodes_started == st.episodes_returned == 64
            and st.kv_dropped_writes == 0 and counts == expected
            and len(rounds) > 0 and st.spec_rounds > 0
            and 0 <= st.spec_accepted <= st.spec_proposed
            and 1.0 <= mean_len <= K
            and bool(torch.isfinite(exp.logprobs).all())
            and bool((exp.context_len > 0).all())):
        raise AssertionError(f"spec_path checks failed: {out}")
    report["spec_verify"]["launches"] = counts["spec_verify"]
    return engine


def phase_spec_branch(torch, model, params):
    """Greedy at full width. (a) One teacher-forced chunk of K=4 tokens for
    32 rows, after a 20-token prefix on a bf16 paged cache, through
    spec_verify_step and through K sequential decode_steps from a copy of
    the same cache, both with the kernels: max |dlogit| against the branch
    phase's 5% of the logit scale, and whether it is bitwise (the GEMMs see
    M = B*K rows against M = B, so cuBLAS may pick other algorithms; the
    kernel itself is held bitwise in the kernels phase). (b) The engine
    with speculation on and off (sampling="reference", temperature 0, B=N=
    32, two turns, the opponent's draws from equally seeded generators):
    the fraction of episodes whose committed token streams are identical,
    the first divergence and the top-two logit gaps there
    (``divergence_margins``), reported, not gated: every episode shares
    its greedy first turn, and with the cluster paged and verify kernels
    the runs part at a one-bf16-ulp tie that the verify GEMMs' rounding
    flips (ROADMAP Queue 3)."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as tf
    from repro_torch.rl.engine import CompiledRolloutEngine
    from repro_torch.rl.envs import TicTacToe

    cfg = model.cfg
    B, K, prefix = 32, 4, 20
    g = torch.Generator(device="cuda").manual_seed(10)
    toks = torch.randint(0, cfg.vocab_size, (B, prefix + K), generator=g,
                         device="cuda").to(torch.int32)
    cache = model.init_cache(B, 256, layout="paged", kv_dtype="bf16",
                             device="cuda")
    for t in range(prefix):
        _, cache = model.decode_step(params, toks[:, t], cache,
                                     attn_impl="paged")
    copy = cache._replace(kv=L.KVEntry(cache.kv.k.clone(),
                                       cache.kv.v.clone()))
    vlogits, _ = tf.spec_verify_step(cfg, params, toks[:, prefix:], cache,
                                     attn_impl="paged")
    seq = []
    for j in range(K):
        lg, copy = model.decode_step(params, toks[:, prefix + j], copy,
                                     attn_impl="paged")
        seq.append(lg)
    seq = torch.stack(seq, dim=1).float()
    d = (vlogits.float() - seq).abs()
    scale = float(seq.abs().max())
    out = dict(phase="spec_branch", part="verify_vs_sequential",
               max_abs_dlogit=float(d.max()), logit_scale=scale,
               tolerance=0.05 * scale, bitwise=bool(torch.equal(
                   vlogits.float(), seq)),
               top1_agreement=float((vlogits.argmax(-1) == seq.argmax(-1))
                                    .float().mean()))
    emit(out)
    if not float(d.max()) <= 0.05 * scale:
        raise AssertionError(f"spec_branch: verify and sequential logits "
                             f"disagree: {out}")

    res = {}
    for spec in ("off", "self"):
        eng = CompiledRolloutEngine(model, TicTacToe(), temperature=0.0,
                                    **dict(SPEC, max_turns=2,
                                           speculation=spec))
        t0 = time.perf_counter()
        res[spec] = eng.run(params, 32, 32, generator=torch.Generator(
            device="cuda").manual_seed(12))          # the env's draws
        torch.cuda.synchronize()
        res[spec] += (time.perf_counter() - t0,)
    (e0, _, s_off), (e1, st, s_on) = res["off"], res["self"]
    same_len = e0.context_len == e1.context_len
    same = same_len & (e0.tokens == e1.tokens).all(dim=1)
    diff = (e0.tokens != e1.tokens).any(dim=0).nonzero()
    out = dict(phase="spec_branch", part="engine_on_vs_off_greedy",
               episodes=int(same.numel()),
               identical_fraction=float(same.float().mean()),
               first_divergent_position=(int(diff[0]) if diff.numel()
                                         else None),
               gen_mask_equal=bool(torch.equal(e0.gen_mask, e1.gen_mask)),
               max_abs_dlogprob=float((e0.logprobs - e1.logprobs).abs()
                                      .max()),
               spec_accepted=st.spec_accepted,
               spec_proposed=st.spec_proposed, spec_rounds=st.spec_rounds,
               off_seconds=s_off, on_seconds=s_on,
               **divergence_margins(torch, model, params, e0, e1))
    emit(out)


def divergence_margins(torch, model, params, e0, e1) -> dict:
    """Where greedy speculation on and off first part, how close the off
    run's choice was: one bf16 forward of the off run's tokens gives, at
    each episode's first divergent position, the gap between its top two
    logits and the rank there of the token the on run committed. The same
    gap over every generated position of the off run is the baseline."""
    T = min(e0.tokens.shape[1], e1.tokens.shape[1])
    t0, t1 = e0.tokens[:, :T], e1.tokens[:, :T]
    differs = t0 != t1
    rows = differs.any(dim=1).nonzero().flatten()
    if rows.numel() == 0:
        return {"divergent_episodes": 0}
    with torch.no_grad():
        logits, _ = model.forward(params, e0.tokens, attn_impl="flash")
    first = differs.int().argmax(dim=1)[rows]
    lg = logits[rows, first - 1].float()             # predicts position first
    top2 = lg.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    rank = (lg > lg.gather(1, t1[rows, first].long()[:, None])).sum(1)
    gen = e0.gen_mask[:, 1:T].bool()
    all_top2 = logits[:, :T - 1].float().topk(2, dim=-1).values
    all_gap = (all_top2[..., 0] - all_top2[..., 1])[gen]
    del logits
    return {"divergent_episodes": int(rows.numel()),
            "first_divergence_gap_max": float(gap.max()),
            "first_divergence_gap_median": float(gap.median()),
            "on_token_rank_in_off_logits": rank.tolist(),
            "generated_gap_median": float(all_gap.median()),
            "generated_gap_frac_below_0.05": float(
                (all_gap < 0.05).float().mean())}


def phase_spec_sync(torch, engine, params):
    """One speculative macro-step of the spec path's engine under
    set_sync_debug_mode("error") everywhere except the round helper, which
    runs in mode "warn" for its one read. Host reads per turn: one per
    verify round, plus the returned counter that the run loop reads after
    the turn (read here in mode "warn" too). Each read is counted as a
    sync warning, and their number must be the verify rounds + 1."""
    import warnings
    rounds = count_calls(engine, "_more_rounds")
    more = engine._more_rounds

    def allowed(pending):
        torch.cuda.set_sync_debug_mode("warn")
        try:
            return more(pending)
        finally:
            torch.cuda.set_sync_debug_mode("error")
    engine._more_rounds = allowed
    noise = engine.default_noise(torch.Generator(device="cuda").manual_seed(
        11))
    carry = engine.init_feed(params, engine.init_carry(32, 64))
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("error")
        try:
            carry = engine.turn_step(params, carry, 0, noise)
            torch.cuda.set_sync_debug_mode("warn")
            returned = int(carry.returned)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    warned = sum("synchronizing" in str(w.message) for w in caught)
    out = dict(phase="spec_sync", verify_rounds=len(rounds),
               host_reads_per_turn=warned, returned_after_one_turn=returned,
               spec_rounds=int(carry.spec_rounds))
    emit(out)
    if not (1 <= len(rounds) <= engine.max_turn_tokens
            and warned == len(rounds) + 1 and int(carry.spec_rounds) > 0):
        raise AssertionError(f"spec_sync checks failed: {out}")


def phase_spec_train(torch, model, report):
    """One EarlTrainer step at full width (CUT_LAYERS layers) with
    speculation="self" (spec_k 4, draft_layers CUT_LAYERS // 2) on the
    train phase's other settings (B=N=32,
    max_context 256, KL 0.05, clip 0.2, bf16, remat "full"). The trainer
    does not fold the reference pass (ref_folded false) and warns once; on
    step 0 the reference IS the policy, sampled at temperature 1.0, so
    ExpPrep's standalone route reuses the behaviour log-probs and runs no
    reference forward. Expected launches, exactly: one spec-verify per
    layer per verify round; one paged attention per layer per fed column
    (the initial feed and one obs feed per macro-step, obs_len columns
    each; the draft runs plain attention); the flash forward once per
    layer in the update and once more in its remat recompute, dq and
    dk/dv once per layer; no fused sampling and no decode attention."""
    import warnings
    from repro_torch.core.stages import EarlTrainer
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.fused_sample import ops as fs_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.spec_verify import ops as sv_ops
    from repro_torch.optim.adamw import adamw
    from repro_torch.rl.envs import TicTacToe

    nl = model.cfg.n_layers
    tr = EarlTrainer(model=model, env=TicTacToe(),
                     optimizer=adamw(3e-4, weight_decay=0.0), batch_size=32,
                     rollout_episodes=32, max_turns=4, max_turn_tokens=32,
                     max_context=256, kl_coef=0.05, clip_eps=0.2,
                     temperature=1.0, seed=0, speculation="self", spec_k=4,
                     draft_layers=nl // 2)
    rounds = count_calls(tr.rollout, "_more_rounds")
    turns = count_calls(tr.rollout, "turn_step")
    params, opt_state, ref = tr.init_state()
    for ops in (sv_ops, pa_ops, fs_ops, fa_ops, da_ops):
        ops.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        new, _, rec = tr.run_step(0, params, opt_state, ref)
    torch.cuda.synchronize()
    counts = dict(spec_verify=sv_ops.launches,
                  paged_attention=pa_ops.launches,
                  fused_sample=fs_ops.launches,
                  flash_fwd=fa_ops.launches["fwd"],
                  flash_dq=fa_ops.launches["dq"],
                  flash_dkv=fa_ops.launches["dkv"],
                  decode_attention=da_ops.launches)
    expected = dict(spec_verify=nl * len(rounds),
                    paged_attention=nl * tr.env.obs_len * (1 + len(turns)),
                    fused_sample=0, flash_fwd=2 * nl, flash_dq=nl,
                    flash_dkv=nl, decode_attention=0)
    warned = [str(w.message) for w in caught
              if issubclass(w.category, RuntimeWarning)
              and "speculation" in str(w.message)]
    changed = not torch.equal(new["layers.attn.wq"], params["layers.attn.wq"])
    out = dict(phase="spec_train", step=0, ref_folded=tr.ref_folded,
               sampling=tr.sampling, fallback_warnings=len(warned),
               mean_return=rec.mean_return,
               mean_context_len=rec.mean_context_len, loss=rec.loss,
               kl=rec.kl, rollout_s=rec.rollout_wall_s,
               update_s=rec.update_wall_s, step_s=rec.wall_time_s,
               macro_steps=len(turns), verify_rounds=len(rounds),
               spec_proposed=rec.spec_proposed,
               spec_accepted=rec.spec_accepted, spec_rounds=rec.spec_rounds,
               mean_accepted_len=(rec.spec_accepted + rec.spec_rounds)
               / max(rec.spec_rounds, 1),
               launches=counts, expected_launches=expected,
               kv_dropped_writes=rec.kv_dropped_writes,
               params_changed=changed,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    emit(out)
    if not (counts == expected and not tr.ref_folded and len(warned) == 1
            and rec.spec_rounds > 0 and changed and math.isfinite(rec.loss)
            and math.isfinite(rec.kl) and rec.kv_dropped_writes == 0):
        raise AssertionError(f"spec_train checks failed: {out}")
    report["spec_train_launches"] = counts


# ---------------------------------------------------------------------------
# The paged pool's second half: prefix sharing, int8 pages, preemption.

class PagedCounter:
    """Counts decode steps on the paged layout and the pool dtype of every
    paged-attention and spec-verify call, by wrapping the module functions
    the engine reaches (restored by ``close``). The kernels' own launch
    counters stay the gate; these say how many launches there must be, and
    on which pools."""

    def __init__(self):
        from repro_torch.kernels.paged_attention import ops as pa_ops
        from repro_torch.kernels.spec_verify import ops as sv_ops
        from repro_torch.models import transformer
        self.steps, self.dtypes = 0, {"paged": [], "verify": []}
        self._undo = []

        def wrap(mod, name, fn):
            orig = getattr(mod, name)
            self._undo.append((mod, name, orig))
            setattr(mod, name, fn(orig))

        def step(orig):
            def counted(*a, **kw):
                self.steps += 1
                return orig(*a, **kw)
            return counted

        def pools(kind):
            def make(orig):
                def seen(q, k_pages, *a, **kw):
                    self.dtypes[kind].append(str(k_pages.dtype))
                    return orig(q, k_pages, *a, **kw)
                return seen
            return make
        wrap(transformer, "_paged_decode_step", step)
        wrap(pa_ops, "paged_decode_attention", pools("paged"))
        wrap(sv_ops, "spec_verify_attention", pools("verify"))

    def close(self):
        for mod, name, orig in reversed(self._undo):
            setattr(mod, name, orig)


def cache_bytes(cache) -> int:
    return sum(t.numel() * t.element_size() for t in cache.kv
               if t is not None)


def bandit_engine(model, **kw):
    from repro_torch.rl.engine import CompiledRolloutEngine
    from repro_torch.rl.envs import MultiArmedBandit
    return CompiledRolloutEngine(model, MultiArmedBandit(prompt_len=95),
                                 **dict(SHARED, **kw))


# an agent's fixed 95-token system prompt: 96 shared tokens (BOS + prompt),
# six full 16-token pages; the bandit ends each episode in one turn
SHARED = dict(cache_layout="paged", attn_impl="paged", sampling="fused",
              temperature=0.0, max_turns=1, max_turn_tokens=32,
              max_context=256, page_size=16)


def phase_shared_path(torch, model, params, report):
    """Full-width qwen2-0.5b through the engine on MultiArmedBandit
    (prompt_len 95: 96 shared tokens, six pages), B=32 slots, 64 episodes,
    greedy, fused sampling, share_prefix=True on int8 pages. Four runs from
    equally seeded generators: int8 unshared (also the warm-up), int8
    shared (timed, every counter set to 0 just before it), bf16 shared and
    bf16 unshared. Gates: every episode returned, 0 dropped writes, the
    shared peak within pool_pages_needed_shared, exactly one paged
    attention per layer per decode step and every one on an int8 pool, and
    greedy tokens (and masks, context lengths) bitwise equal shared and
    unshared at int8 and at bf16. Then one decode step on the shared int8
    pool through the paged kernel and the gather route (dequantize +
    plain attention): within 5% of the logit scale, the branch phase's
    tolerance (the plain route's softmax runs in bf16). Last, the
    copy-on-write copy on a forked partial page (``shared_cow``)."""
    from repro_torch.kernels.fused_sample import ops as fs_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.models.paging import pool_pages_needed_shared

    nl = model.cfg.n_layers
    gen = lambda: torch.Generator(device="cuda").manual_seed(7)
    runs = {}
    for name, kw in (("int8_off", dict(kv_dtype="int8")),
                     ("int8_on", dict(kv_dtype="int8", share_prefix=True)),
                     ("bf16_on", dict(share_prefix=True)),
                     ("bf16_off", {})):
        engine = bandit_engine(model, **kw)
        counter = PagedCounter()
        pa_ops.reset_launches()
        fs_ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            exp, st = engine.run(params, 32, 64, generator=gen())
            torch.cuda.synchronize()
        finally:
            counter.close()
        runs[name] = dict(exp=exp, st=st, secs=time.perf_counter() - t0,
                          steps=counter.steps, pa=pa_ops.launches,
                          fs=fs_ops.launches, dtypes=counter.dtypes["paged"],
                          engine=engine)
    on = runs["int8_on"]
    st, eng = on["st"], on["engine"]
    need = pool_pages_needed_shared(32, 256, eng.shared_len, 16)

    def same(a, b):
        ea, eb = runs[a]["exp"], runs[b]["exp"]
        eq = (ea.tokens == eb.tokens).all(dim=1)
        return dict(episodes_identical=int(eq.sum()),
                    tokens_bitwise=bool(eq.all()),
                    masks_bitwise=bool(torch.equal(ea.gen_mask, eb.gen_mask)
                                       and torch.equal(ea.context_len,
                                                       eb.context_len)),
                    max_abs_dlogprob=float((ea.logprobs - eb.logprobs).abs()
                                           .max()))
    int8_eq, bf16_eq = same("int8_on", "int8_off"), same("bf16_on",
                                                         "bf16_off")

    # the int8 kernel route against the gather route, on the shared pool
    carry = eng.init_feed(params, eng.init_carry(32, 64))
    tok = torch.full((32,), 40, dtype=torch.int32, device=params["embedding"].device)
    lg = {}
    for impl in ("paged", "xla"):
        cache = carry.cache._replace(kv=type(carry.cache.kv)(
            *(t.clone() for t in carry.cache.kv)))
        lg[impl] = model.decode_step(params, tok, cache,
                                     attn_impl=impl)[0].float()
    scale = float(lg["xla"].abs().max())
    d_route = float((lg["paged"] - lg["xla"]).abs().max())
    int8_bytes = cache_bytes(carry.cache)
    bf16_bytes = cache_bytes(model.init_cache(
        32, 256, layout="paged", page_size=16, n_pages=carry.cache.n_pages,
        device="cuda"))
    del carry
    gen_tokens = int(on["exp"].gen_mask.sum())
    out = dict(
        phase="shared_path", prompt_prefix_len=eng.env.prompt_prefix_len,
        shared_len=eng.shared_len, shared_pages=eng.shared_pages,
        seconds=on["secs"], generated_tokens=gen_tokens,
        tokens_per_s=gen_tokens / on["secs"],
        unshared_seconds=runs["int8_off"]["secs"],
        unshared_tokens_per_s=int(runs["int8_off"]["exp"].gen_mask.sum())
        / runs["int8_off"]["secs"],
        bf16_shared_seconds=runs["bf16_on"]["secs"],
        bf16_unshared_seconds=runs["bf16_off"]["secs"],
        decode_steps=on["steps"], unshared_decode_steps=runs["int8_off"][
            "steps"],
        paged_attention_launches=on["pa"], fused_sample_launches=on["fs"],
        paged_attention_per_decode_step=on["pa"] / max(on["steps"], 1),
        int8_pool_calls=on["dtypes"].count("torch.int8"),
        pages_peak=st.pages_in_use,
        unshared_pages_peak=runs["int8_off"]["st"].pages_in_use,
        pool_pages_needed_shared=need, page_capacity=st.page_capacity,
        pool_bytes_int8=int8_bytes, pool_bytes_bf16=bf16_bytes,
        pool_bytes_ratio=int8_bytes / bf16_bytes,
        episodes_started=st.episodes_started,
        episodes_returned=st.episodes_returned,
        kv_dropped_writes=st.kv_dropped_writes,
        int8_shared_vs_unshared=int8_eq, bf16_shared_vs_unshared=bf16_eq,
        route_max_abs_dlogit=d_route, route_logit_scale=scale,
        route_tolerance=0.05 * scale,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    emit(out)
    ok = (all(r["st"].episodes_returned == 64 and r["st"].kv_dropped_writes
              == 0 for r in runs.values())
          and st.pages_in_use <= need and on["steps"] > 0
          and on["pa"] == nl * on["steps"]
          and on["dtypes"] == ["torch.int8"] * on["pa"]
          and int8_eq["tokens_bitwise"] and int8_eq["masks_bitwise"]
          and bf16_eq["tokens_bitwise"] and bf16_eq["masks_bitwise"]
          and d_route <= 0.05 * scale and math.isfinite(d_route)
          and bool(torch.isfinite(on["exp"].logprobs).all()))
    if not ok:
        raise AssertionError(f"shared_path checks failed: {out}")
    report["paged_attention"]["launches_int8"] = on["pa"]
    shared_cow(torch, model, params)


def shared_cow(torch, model, params):
    """The copy-on-write copy at full width, which the engine never needs
    (its shared run is whole pages): an int8 pool after a shared 100-token
    prompt (six full pages and a partial seventh, 4 tokens in), with row
    0's partial page aliased into all 32 rows (refcount 32), as a caller
    that forks a partial page leaves it. One decode step and one K=4
    verify chunk into that page, each through the kernel ("paged") and
    the gather route ("xla") from copies of the pool. Gates: logits of the
    two routes within 5% of their scale (the branch phase's tolerance),
    the allocator state equal, every row writing into its own new page,
    the source page's values and scales untouched and freed, and each
    copy holding the source's 4 entries (values and scales)."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.spec_verify import ops as sv_ops
    from repro_torch.models import transformer as tf

    B, S, ps, nl = 32, 100, 16, model.cfg.n_layers
    fill, slot = S % ps, S // ps
    g = torch.Generator(device="cuda").manual_seed(9)
    toks = torch.randint(3, model.cfg.vocab_size, (1, S), generator=g,
                         device="cuda").to(torch.int32).repeat(B, 1)
    cache = model.init_cache(B, 256, layout="paged", page_size=ps,
                             kv_dtype="int8", device="cuda")
    _, cache = model.prefill(params, toks, cache, shared_prefix_len=S)
    bt, rc = cache.block_table.clone(), cache.refcount.clone()
    page = int(bt[0, slot])
    rc.index_add_(0, bt[1:, slot].long(), -torch.ones_like(rc[:B - 1]))
    rc[page] += B - 1
    bt[1:, slot] = page
    cache = cache._replace(block_table=bt, refcount=rc)
    before = [t[:, page].clone() for t in cache.kv]
    chunk = torch.randint(3, model.cfg.vocab_size, (B, 4), generator=g,
                          device="cuda").to(torch.int32)
    out = dict(phase="shared_path", part="cow", batch=B, prompt=S,
               refcount_before=int(rc[page]))
    ok = True
    for step in ("decode", "verify"):
        res, launches = {}, {}
        for impl in ("paged", "xla"):
            c = cache._replace(
                kv=type(cache.kv)(*(None if t is None else t.clone()
                                    for t in cache.kv)),
                block_table=bt.clone(), refcount=rc.clone(),
                pos=cache.pos.clone())
            pa_ops.reset_launches()
            sv_ops.reset_launches()
            if step == "decode":
                res[impl] = model.decode_step(params, chunk[:, 0], c,
                                              attn_impl=impl)
            else:
                res[impl] = tf.spec_verify_step(model.cfg, params, chunk, c,
                                                attn_impl=impl)
            launches[impl] = (pa_ops.launches if step == "decode"
                              else sv_ops.launches)
        (lk, ck), (lx, cx) = res["paged"], res["xla"]
        scale = float(lx.float().abs().max())
        d = float((lk.float() - lx.float()).abs().max())
        new = ck.block_table[:, slot].long()
        copied = all(
            torch.equal(t[:, page], b) and torch.equal(
                t[:, new, :fill], b[:, None, :fill].expand_as(
                    t[:, new, :fill]))
            for c in (ck, cx) for t, b in zip(c.kv, before))
        r = dict(max_abs_dlogit=d, logit_scale=scale,
                 tolerance=0.05 * scale,
                 allocator_equal=bool(torch.equal(ck.block_table,
                                                  cx.block_table)
                                      and torch.equal(ck.refcount,
                                                      cx.refcount)),
                 private_pages=len(set(new.tolist()) - {page}),
                 source_refcount_after=int(ck.refcount[page]),
                 copies_hold_source=copied,
                 kernel_launches=launches["paged"],
                 int8=ck.kv.k.dtype == torch.int8)
        out[step] = r
        ok = ok and (d <= 0.05 * scale and math.isfinite(d)
                     and r["allocator_equal"] and r["private_pages"] == B
                     and r["source_refcount_after"] == 0 and copied
                     and r["kernel_launches"] == nl and r["int8"])
    emit(out)
    if not ok:
        raise AssertionError(f"shared_path copy-on-write checks failed: "
                             f"{out}")


def greedy_gaps(torch, model, params, exp) -> dict:
    """Teacher-forces a greedy batch's committed contexts through the plain
    bf16 forward (8 rows at a time) and reads, at every generated position,
    the gap between the forward's largest logit and the committed token's
    (0 where the committed token is the forward's argmax), and how far the
    engine's log-prob of that token lies from the forward's."""
    toks, gm, lps = exp.tokens, exp.gen_mask[:, 1:], exp.logprobs[:, 1:]
    gaps, dlps, scale = [], [], 0.0
    with torch.no_grad():
        for r in range(0, toks.shape[0], 8):
            lg = model.forward(params, toks[r:r + 8])[0][:, :-1].float()
            m = gm[r:r + 8]
            at = lg.gather(-1, toks[r:r + 8, 1:, None].long())[..., 0]
            gaps.append((lg.amax(-1) - at)[m])
            lp = (at - torch.logsumexp(lg, -1))[m]
            dlps.append((lp - lps[r:r + 8][m]).abs())
            scale = max(scale, float(lg.abs().max()))
            del lg
    gaps, dlps = torch.cat(gaps), torch.cat(dlps)
    return dict(positions=int(gaps.numel()),
                argmax_fraction=float((gaps == 0).float().mean()),
                max_gap=float(gaps.max()), max_abs_dlogprob=float(dlps.max()),
                logit_scale=scale)


def phase_shared_spec(torch, model, params, report):
    """The shared int8 engine with speculation="self" (spec_k 4, 12 draft
    layers, sampling="reference", greedy), B=32, 32 episodes: the verify
    chunk runs the spec-verify kernel's int8 route on forked prefix pages.
    Gates: every episode returned, 0 dropped writes, exactly one
    spec-verify launch per layer per verify round and one paged attention
    per layer per fed column, every one on an int8 pool. Then the same
    episodes through the non-speculative shared int8 engine (equally
    seeded generators: greedy runs draw only the bandit's reset and payout
    draws, in the same order): tokens, masks and context lengths bitwise
    equal, JAX's contract that speculation does not change greedy output.
    The verify GEMMs see M = B*K rows against M = B, which flips greedy
    near-ties on TicTacToe (spec_branch, ROADMAP Queue 3); on this batch
    they agreed bitwise on an H100. Beside it, for both runs:
    every committed token is the greedy choice of the plain bf16 forward
    over the committed context, up to a gap of 10% of the logit scale
    (the branch phase's 5% for each of the two logits compared; a wrong
    commit sits a large part of the scale below the top), which tells a
    near-tie flip from a wrong commit if the bitwise gate fails."""
    from repro_torch.kernels.fused_sample import ops as fs_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.spec_verify import ops as sv_ops

    nl = model.cfg.n_layers
    kw = dict(kv_dtype="int8", share_prefix=True, sampling="reference")
    engine = bandit_engine(model, speculation="self", spec_k=4,
                           draft_layers=nl // 2, **kw)
    gen = lambda: torch.Generator(device="cuda").manual_seed(8)
    rounds = count_calls(engine, "_more_rounds")
    counter = PagedCounter()
    for ops in (sv_ops, pa_ops, fs_ops):
        ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        exp, st = engine.run(params, 32, 32, generator=gen())
        torch.cuda.synchronize()
    finally:
        counter.close()
    secs = time.perf_counter() - t0
    counts = dict(spec_verify=sv_ops.launches,
                  paged_attention=pa_ops.launches,
                  fused_sample=fs_ops.launches)
    expected = dict(spec_verify=nl * len(rounds),
                    paged_attention=nl * counter.steps, fused_sample=0)
    int8 = all(d == "torch.int8" for k in ("paged", "verify")
               for d in counter.dtypes[k])
    off, _ = bandit_engine(model, **kw).run(params, 32, 32,
                                            generator=gen())
    same = ((exp.tokens == off.tokens).all(dim=1)
            & (exp.gen_mask == off.gen_mask).all(dim=1)
            & (exp.context_len == off.context_len))
    diff = (exp.tokens != off.tokens).any(dim=0).nonzero()
    gaps = dict(spec=greedy_gaps(torch, model, params, exp),
                off=greedy_gaps(torch, model, params, off))
    tol = {k: 0.1 * g["logit_scale"] for k, g in gaps.items()}
    gen_tokens = int(exp.gen_mask.sum())
    out = dict(phase="shared_spec", seconds=secs,
               generated_tokens=gen_tokens, tokens_per_s=gen_tokens / secs,
               verify_rounds=len(rounds), decode_steps=counter.steps,
               spec_proposed=st.spec_proposed,
               spec_accepted=st.spec_accepted, spec_rounds=st.spec_rounds,
               mean_accepted_len=(st.spec_accepted + st.spec_rounds)
               / max(st.spec_rounds, 1),
               launches=counts, expected_launches=expected,
               int8_verify_calls=counter.dtypes["verify"].count("torch.int8"),
               all_int8=int8, pages_peak=st.pages_in_use,
               episodes_returned=st.episodes_returned,
               kv_dropped_writes=st.kv_dropped_writes,
               vs_off_identical_fraction=float(same.float().mean()),
               vs_off_first_divergent_position=(int(diff[0]) if diff.numel()
                                                else None),
               greedy_gaps=gaps, gap_tolerance=tol,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    emit(out)
    if not (counts == expected and len(rounds) > 0 and int8
            and st.episodes_returned == 32 and st.kv_dropped_writes == 0
            and bool(torch.isfinite(exp.logprobs).all())
            and bool(same.all())
            and all(gaps[k]["positions"] > 0
                    and gaps[k]["max_gap"] <= tol[k] for k in gaps)):
        raise AssertionError(f"shared_spec checks failed: {out}")
    report["spec_verify"]["launches_int8"] = counts["spec_verify"]


# the path's settings (B=32 slots, 64 episodes, four turns of up to 32
# tokens, 16-token pages), greedy, on int8 pages, under preemption
PREEMPT = dict(PATH, temperature=0.0, kv_dtype="int8", on_exhaust="preempt",
               admit_watermark=64)


def phase_preempt_path(torch, model, params, report):
    """Full-width qwen2-0.5b on TicTacToe under on_exhaust="preempt" at the
    path's sizes, greedy, int8 pages. The unpressured run (the default
    pool) first; its page peak is the exhaustion-free size for these
    trajectories, and the pressured run gets half of it, which must lie
    above the governor's minimum. Gates: preemptions > 0, 0 dropped writes,
    every episode returned, trajectories (tokens, masks, log-probs,
    rewards, context lengths) bitwise equal to the unpressured run's; a
    pool one page below min_pool_pages raises ValueError;
    pool_growth="double" from the minimum pool grows, stays within
    pool_growth_max (the unpressured peak), drains with 0 dropped writes
    and commits the same trajectories.

    admit_watermark is 64 pages (two a slot). At the default (one turn of
    one slot, 4 pages) the governor of both packages can fail to drain at
    these sizes: admission refills every freed page with a fresh episode,
    which runs first (shortest context first), so the long episodes are
    preempted over and over (ROADMAP Queue 3). 32 pages drains too, but
    the half-pool run took 268 s on an H100 where 64 pages takes fewer
    macro-steps (91-105 against 58-62 on the CPU at smoke size)."""
    from repro_torch.rl.engine import CompiledRolloutEngine
    from repro_torch.rl.envs import TicTacToe

    B, N = 32, 64
    gen = lambda: torch.Generator(device="cuda").manual_seed(5)
    mk = lambda **kw: CompiledRolloutEngine(model, TicTacToe(),
                                            **dict(PREEMPT, **kw))
    runs = {}

    def run(name, engine):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exp, st = engine.run(params, B, N, generator=gen())
        torch.cuda.synchronize()
        runs[name] = (exp, st, time.perf_counter() - t0)

    full = mk()
    run("full", full)
    minimum = full.min_pool_pages(B)
    peak = runs["full"][1].pages_in_use
    half = peak // 2
    if half <= minimum:
        raise AssertionError(f"preempt_path: half the unpressured peak "
                             f"({half} of {peak} pages) is not above the "
                             f"governor's minimum ({minimum})")
    run("half", mk(cache_pages=half))
    run("grow", mk(cache_pages=minimum, pool_growth="double",
                   pool_growth_max=peak))
    try:
        mk(cache_pages=minimum - 1).run(params, B, N, generator=gen())
        refused = False
    except ValueError as e:
        refused = "minimum viable pool" in str(e)

    def same(name):
        a, b = runs["full"][0], runs[name][0]
        return all(torch.equal(getattr(a, f), getattr(b, f)) for f in
                   ("tokens", "gen_mask", "logprobs", "rewards",
                    "context_len"))
    st = {k: v[1] for k, v in runs.items()}
    out = dict(phase="preempt_path", batch=B, episodes=N,
               admit_watermark=full.admit_watermark,
               min_pool_pages=minimum, full_pool=st["full"].page_capacity,
               full_pages_peak=peak, half_pool=half,
               half_pages_peak=st["half"].pages_in_use,
               preemptions=st["half"].preemptions,
               requeue_depth=st["half"].requeue_depth,
               grow_start=minimum, grow_max=peak,
               pool_grows=st["grow"].pool_grows,
               grow_capacity=st["grow"].page_capacity,
               grow_preemptions=st["grow"].preemptions,
               seconds={k: v[2] for k, v in runs.items()},
               tokens_per_s={k: int(v[0].gen_mask.sum()) / v[2]
                             for k, v in runs.items()},
               kv_dropped_writes={k: v.kv_dropped_writes
                                  for k, v in st.items()},
               episodes_returned={k: v.episodes_returned
                                  for k, v in st.items()},
               half_equals_full=same("half"), grow_equals_full=same("grow"),
               below_minimum_refused=refused,
               mean_context_len=st["full"].mean_context_len)
    emit(out)
    if not (st["half"].preemptions > 0 and refused
            and all(s.kv_dropped_writes == 0 and s.episodes_returned == N
                    for s in st.values())
            and out["half_equals_full"] and out["grow_equals_full"]
            and st["grow"].pool_grows >= 1
            and st["grow"].page_capacity <= peak):
        raise AssertionError(f"preempt_path checks failed: {out}")


# the tp path: two processes share the one card over gloo (see
# phase_tp_path), each a rank of tp=2 on full-width qwen2-0.5b
TP_PATH = dict(cache_layout="paged", attn_impl="paged", sampling="fused",
               temperature=0.0, max_turns=2, max_turn_tokens=4,
               max_context=96)
TP_BATCH = 8


class TPWorkers:
    """The rank processes of a gloo group that shares the card
    (``chip_smoke.py --tp-worker``: tp_path's two ranks; ``--seq-worker``:
    seq_path's four), started at once: each joins the group (tp_path's
    also make their seeded weights on the host), then waits until ``go``
    is called (or an hour passes) before it touches the card's kernels.
    ``stop`` kills what is still running, with any process a rank started,
    and removes their directory."""

    def __init__(self, world: int = 2, flag: str = "--tp-worker"):
        import tempfile
        self.tmp = tempfile.mkdtemp()
        store = os.path.join(self.tmp, "store")
        self.go_path = os.path.join(self.tmp, "go")
        self.t_go = None           # when go() was first called
        self.logs = [os.path.join(self.tmp, f"rank{r}.log")
                     for r in range(world)]
        self.procs = []
        for r in range(world):
            with open(self.logs[r], "w") as f:
                self.procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), flag,
                     str(r), str(world), store, self.go_path], stdout=f,
                    stderr=subprocess.STDOUT))

    def go(self) -> None:
        if self.t_go is None:
            self.t_go = time.perf_counter()
        with open(self.go_path, "w") as f:
            f.write("go")

    def go_after(self, other: "TPWorkers") -> None:
        """Let these ranks go once every rank of ``other`` has exited: a
        thread polls them (and gives up if these ranks were stopped)."""
        def wait():
            while any(p.poll() is None for p in other.procs):
                time.sleep(0.5)
            if os.path.isdir(self.tmp):
                self.go()
        threading.Thread(target=wait, daemon=True).start()

    def wait(self, timeout: float):
        """Each rank's exit code and log, once all have exited."""
        codes = []
        for p in self.procs:
            try:
                codes.append(p.wait(timeout=timeout))
            except subprocess.TimeoutExpired:
                codes.append(None)
        return codes, [open(f).read() for f in self.logs]

    def stop(self) -> None:
        import shutil
        from repro_torch.kernels._build import kill_tree
        for p in self.procs:
            if p.poll() is None:
                kill_tree(p.pid)
                p.wait()
        shutil.rmtree(self.tmp, ignore_errors=True)


def _tp_counters():
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.fused_sample import ops as fs_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.spec_verify import ops as sv_ops
    reset = lambda: [m.reset_launches() for m in (da_ops, fa_ops, fs_ops,
                                                  pa_ops, sv_ops)]
    read = lambda: {"paged_attention": pa_ops.launches,
                    "decode_attention": da_ops.launches,
                    "fused_sample": fs_ops.launches,
                    "fused_sample_partial": fs_ops.partial_launches,
                    "flash_fwd": fa_ops.launches["fwd"],
                    "flash_dq": fa_ops.launches["dq"],
                    "flash_dkv": fa_ops.launches["dkv"],
                    "spec_verify": sv_ops.launches}
    return reset, read


# the counters of a rollout's stats that tp_path's option runs compare
TP_STATS = ("spec_proposed", "spec_accepted", "spec_rounds", "preemptions",
            "requeue_depth", "pool_grows", "shared_prefix_len",
            "kv_dropped_writes", "pages_in_use", "page_capacity")
# tp_path's option runs at full width and CUT_LAYERS: (a) speculation on
# TicTacToe, greedy, fp32 params and KV, 2 turns of 8 tokens; (b) the
# SHARED bandit (96 shared tokens) at B=8 and N=16 on int8 pages with
# sharing, then also with preemption and pool growth from a pool of
# TP_POOL_PAGES: min_pool_pages(8) at the bandit's 102-token prompt (six
# shared pages and one private page a slot), which cannot hold 8 slots'
# turns of 32 tokens (three private pages each), so the governor preempts
# and the pool grows; (c) two steps of the SPMD trainer under the async
# pipeline, 1 turn of 4 tokens, with the update on both ranks and the
# reference pass folded in. Its KL term is off (the trainer's default): the folded
# reference decodes on a bf16 cache, where K/V computed in another order at
# tp=2 can round to the neighbouring bf16 value (tp_path's reference rule,
# 1e-2), which step 1's KL of 18 on random weights turned into 4.6e-5 of
# loss on an H100. One TicTacToe turn ends no game, so the rewards, the
# advantages and the loss are 0 in both runs; the batches' log-probs carry
# the signal
TP_SPEC = dict(cache_layout="paged", attn_impl="paged", sampling="reference",
               temperature=0.0, max_turns=2, max_turn_tokens=8,
               max_context=96, kv_dtype="fp32")
TP_SPEC_ON = dict(speculation="self", spec_k=4, draft_layers=6)
TP_EPISODES = 16
TP_POOL_PAGES = 16
TP_ASYNC = dict(batch_size=TP_BATCH, max_turns=1, max_turn_tokens=4,
                max_context=96, kv_dtype="fp32", temperature=0.0,
                kl_coef=0.0, pipeline="async", max_policy_lag=1, seed=0)


def pool_bytes(eng, pages: int) -> int:
    """The bytes of the engine's paged pool at ``pages`` pages (its trash
    page included) on this rank: the rank's kv heads of every layer, K and
    V, with the f32 scales of an int8 pool."""
    cfg = eng.model.cfg
    kv = eng.tp.n_kv_heads if eng.tp is not None else cfg.n_kv_heads
    esz = {"int8": 1, "bf16": 2, "fp32": 4}[eng.kv_dtype]
    per_token = 2 * kv * (cfg.head_dim_ * esz
                          + (4 if eng.kv_dtype == "int8" else 0))
    return (pages + 1) * eng.page_size * cfg.n_layers * per_token


def tp_selector(tp2: int):
    """A profiled selector of "tp1" (one rank) and "tp2" (``tp2`` ranks
    from rank 0); "tp2" wins above one token of context, so the rollout
    switches at step 1 (``tests/test_torch_tp.py``'s)."""
    from repro_torch.core.parallelism_selector import (
        ContextBuckets, ParallelismSelector, ProfileEntry)
    from repro_torch.core.resharding import MeshConfig
    sel = ParallelismSelector(
        [MeshConfig("tp1", 1, 1), MeshConfig("tp2", 1, tp2)],
        lambda c, ctx: ProfileEntry(
            c, ctx, 2.0 if (c.name == "tp2") == (ctx > 1) else 1.0, True),
        ContextBuckets((1,)))
    sel.profile()
    return sel


def tp_options(torch, model, params, rollout, rank, two):
    """tp_path's option runs (a) and (b) on one rank: first the tp=1
    references, each on one rank alone (rank 0 the pressured pool run,
    rank 1 the others, side by side), then each run at tp=2, the
    speculative run's spec-off twin at tp=2 only. Returns this rank's
    results; the tp=1 ones under ``<name>_tp1``."""
    from repro_torch.core.resharding import MeshConfig
    from repro_torch.rl.engine import CompiledRolloutEngine
    from repro_torch.rl.envs import MultiArmedBandit, TicTacToe
    bandit = lambda: MultiArmedBandit(prompt_len=95)
    pool = dict(SHARED, kv_dtype="int8", share_prefix=True)
    runs = (("spec", TicTacToe, dict(TP_SPEC, **TP_SPEC_ON), TP_BATCH),
            ("spec_off", TicTacToe, TP_SPEC, TP_BATCH),
            ("pool", bandit, pool, TP_EPISODES),
            ("pool_preempt", bandit,
             dict(pool, on_exhaust="preempt", pool_growth="double",
                  cache_pages=TP_POOL_PAGES), TP_EPISODES))
    out = {}
    alone = MeshConfig(f"tp1-rank{rank}", 1, 1, device_offset=rank)
    for name, env, kw, n in runs:
        if name != "spec_off" and (name == "pool_preempt") == (rank == 0):
            eng = CompiledRolloutEngine(model, env(), mesh_config=alone,
                                        **kw)
            out[f"{name}_tp1"] = rollout(eng, params, False, True, n=n)
            del eng
    for name, env, kw, n in runs:
        eng = CompiledRolloutEngine(model, env(), mesh_config=two, **kw)
        out[f"{name}_tp2"] = rollout(eng, params, False, False, n=n)
        del eng
    return out


def tp_async(torch, model, params, rank: int, spmd: bool) -> dict:
    """tp_path's run (c): two steps of ``EarlTrainer`` under the async
    pipeline (TP_ASYNC) on ``params`` (host tensors): across the two ranks
    (``spmd``: the rollout on the selector's mesh, tp=1 at step 0 and tp=2
    at step 1, the update on both ranks of the update stage's tp=2 config
    from step 0 (hook ② reads step 0's context), replicated over the model
    axis; the given params are real on rank 0 alone, rank 1 passes meta
    tensors) or on rank 0 alone, the reference. Returns the batches'
    tokens the update was given, the policy lags, the losses, the switch
    rows, the launches, the seconds and (``spmd``) whether both ranks'
    final params are bitwise equal."""
    from repro_torch.core.stages import EarlTrainer
    from repro_torch.rl.envs import TicTacToe
    reset, read = _tp_counters()
    tr = EarlTrainer(model=model, env=TicTacToe(),
                     selector=tp_selector(2 if spmd else 1), **TP_ASYNC)
    rec = _RecordingUpdate(tr.update_stage)
    tr.update_stage = rec
    p = ({k: v.cuda() for k, v in params.items()} if rank == 0 else
         {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
          for k, v in params.items()})
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    p, _, hist = tr.train(2, params=p, opt_state=tr.optimizer.init(p),
                          ref_params=p)
    torch.cuda.synchronize()
    out = dict(seconds=time.perf_counter() - t0, launches=read(),
               tokens=[b.tokens.cpu().tolist() for b in rec.batches],
               logprobs=[b.logprobs.cpu().tolist() for b in rec.batches],
               ref_logprobs=[b.ref_logprobs.cpu().tolist()
                             for b in rec.batches],
               lags=[r.policy_lag for r in hist],
               losses=[r.loss for r in hist],
               switches=[r.selector_switch for r in hist],
               params_equal=_same_on_ranks(torch, p) if spmd else None)
    del tr, rec, p, hist
    torch.cuda.empty_cache()
    return out


# the dp runs of tp_path's ranks (tp_dp, dp_train): full-width qwen2-0.5b
# at dp=2 with TP_PATH's settings, each rank a data row of 4 of TP_BATCH's
# slots on its half of the pool. (d) is two steps of the SPMD trainer at
# CUT_LAYERS whose selector switches dp2 -> tp2 at step 1, sampled with
# injected draws, the KL term off (tp_async's reason): five turns of four
# tokens, so that games end, and sampled, because greedy random weights
# repeat one illegal move in every game (all returns -1, so every
# advantage and the loss are 0)
DP2 = ("dp2", 2, 1)
DP_DEVICE = "cuda"        # the dp runs' device (a CPU rehearsal sets "cpu")
DP_INT8 = dict(TP_PATH, kv_dtype="int8")
DP_TRAIN = dict(batch_size=TP_BATCH, max_turns=5, max_turn_tokens=4,
                max_context=96, kv_dtype="fp32", temperature=1.0,
                kl_coef=0.0, seed=0)


def dp_tp_selector(world: int):
    """A profiled selector of "dp2" (``world`` data rows) and "tp2" (a
    ``world``-rank tp group), one-device configs of the same names on one
    rank; "dp2" wins the bucket below one token of context, "tp2" above,
    so the rollout switches at step 1."""
    from repro_torch.core.parallelism_selector import (
        ContextBuckets, ParallelismSelector, ProfileEntry)
    from repro_torch.core.resharding import MeshConfig
    sel = ParallelismSelector(
        [MeshConfig("dp2", world, 1), MeshConfig("tp2", 1, world)],
        lambda c, ctx: ProfileEntry(
            c, ctx, 2.0 if (c.name == "dp2") == (ctx <= 1) else 1.0, True),
        ContextBuckets((1,)))
    sel.profile()
    return sel


def dp_noise(torch):
    """(d)'s injected draws: Gumbel draws of the global batch (the
    sampler's and the opponent's), keyed by (step, kind, macro-step,
    index) from seeded host generators, the same on every rank."""
    from repro_torch.rl.engine.common import gumbel_from_uniform

    def step_noise(step):
        def noise(kind, m, index, shape):
            g = torch.Generator().manual_seed(
                (step * 1000 + m * 10 + index) * 2 + (kind == "env"))
            u = torch.rand(shape, generator=g).clamp_min(1e-30)
            return gumbel_from_uniform(u).to(DP_DEVICE)
        return noise
    return step_noise


def tp_dp(torch, model, full32, cut, cut32, rollout, rank, gen, reset,
          read):
    """tp_path's dp runs (a)-(c) on one rank (``tp_worker``, after its tp
    runs): (a) full-width qwen2-0.5b at dp=2, paged, fp32 params and KV,
    the folded reference, fused sampling, greedy, B=8 (each rank 4 slots);
    (b) the same at bf16, one turn without the reference, and the first
    decode step's logits after a 12-token prompt on the rank's 4 rows
    against all 8 rows on the rank; (c) int8 pages at dp=2 at CUT_LAYERS,
    fp32 params, against the same run at dp=1 on rank 1 alone. Each run
    holds the whole params on the card (``rollout``'s ``to_card``). (c)'s
    dp=1 run is ``tp_worker``'s, on rank 1 while rank 0 runs tp=1."""
    from repro_torch.core.resharding import MeshConfig
    from repro_torch.models import transformer
    from repro_torch.rl.engine import CompiledRolloutEngine
    from repro_torch.rl.envs import TicTacToe
    dp2 = MeshConfig(*DP2)
    out = {}
    eng = CompiledRolloutEngine(model, TicTacToe(), mesh_config=dp2,
                                kv_dtype="fp32", **TP_PATH)
    out["fp32_dp2"] = rollout(eng, full32, True, True)
    full16 = {k: v.bfloat16() for k, v in full32.items()}
    eng = CompiledRolloutEngine(model, TicTacToe(), mesh_config=dp2,
                                kv_dtype="bf16", **dict(TP_PATH,
                                                        max_turns=1))
    out["bf16_dp2"] = rollout(eng, full16, False, True)
    del eng
    # the first decode step at the rank's rows (prefill on the flash
    # forward, decode on the paged kernel) against all rows
    cfg, B = model.cfg, TP_BATCH
    tok = torch.randint(0, cfg.vocab_size, (B, 13), device=DP_DEVICE,
                        generator=gen())
    g16 = {k: v.to(DP_DEVICE) for k, v in full16.items()}
    mine = slice(rank * B // 2, (rank + 1) * B // 2)
    lg = {}
    reset()
    with torch.no_grad():
        for name, rows in (("rank", tok[mine]), ("all", tok)):
            c = transformer.init_cache(cfg, rows.shape[0], 32, layout="paged",
                                       device=DP_DEVICE)
            _, c = transformer.prefill(cfg, g16, rows[:, :12], c,
                                       attn_impl="paged")
            lg[name], _ = transformer.decode_step(cfg, g16, rows[:, 12], c,
                                                  attn_impl="paged")
    ref = lg["all"][mine].float()
    out["bf16_logits"] = dict(
        max_abs_err=float((lg["rank"].float() - ref).abs().max()),
        scale=float(ref.abs().max()), launches=read())
    del g16, full16, c, lg, ref
    torch.cuda.empty_cache()
    eng = CompiledRolloutEngine(cut, TicTacToe(), mesh_config=dp2, **DP_INT8)
    out["int8_dp2"] = rollout(eng, cut32, True, True)
    del eng
    torch.cuda.empty_cache()
    return out


def dp_options(torch, model, params, rollout):
    """tp_path's dp option runs on one rank (``tp_worker``, after
    ``tp_options``, whose tp=1 runs of the same configs are their dp=1
    references): at dp=2 and CUT_LAYERS, each rank a data row of half the
    slots, (a) speculation ``"self"`` (TP_SPEC_ON: K=4, 6 draft layers)
    on TicTacToe, fp32, greedy, B=8, 2 turns of 8 tokens; (b) the shared
    bandit (96 shared tokens) at B=8, N=16 on int8 pages with sharing,
    preemption and pool growth from TP_POOL_PAGES pages. Both run on the
    global page count: the round loop's flag over both rows, and the
    governor, admission and growth on the global batch."""
    from repro_torch.core.resharding import MeshConfig
    from repro_torch.rl.engine import CompiledRolloutEngine
    from repro_torch.rl.envs import MultiArmedBandit, TicTacToe
    dp2 = MeshConfig(*DP2)
    pool = dict(SHARED, kv_dtype="int8", share_prefix=True,
                on_exhaust="preempt", pool_growth="double",
                cache_pages=TP_POOL_PAGES)
    out = {}
    for name, env, kw, n in (
            ("spec", TicTacToe(), dict(TP_SPEC, **TP_SPEC_ON), TP_BATCH),
            ("pool_preempt", MultiArmedBandit(prompt_len=95), pool,
             TP_EPISODES)):
        eng = CompiledRolloutEngine(model, env, mesh_config=dp2, **kw)
        out[f"{name}_dp2"] = rollout(eng, params, False, True, n=n)
        del eng
    return out


def dp_train(torch, model, params, rank: int, spmd: bool) -> dict:
    """tp_path's dp run (d): two steps of ``EarlTrainer`` (DP_TRAIN) on
    ``params`` (host tensors) whose selector switches the rollout dp2 ->
    tp2 at step 1: across the two ranks (``spmd``; the update on both
    ranks of the update stage's tp2 config from step 0, replicated over
    the model axis; the given params are real on rank 0 alone) or on this
    rank alone, the reference. Returns the records, the launches, the
    seconds and (``spmd``) whether both ranks' final params are bitwise
    equal."""
    from repro_torch.core.stages import EarlTrainer
    from repro_torch.rl.envs import TicTacToe
    reset, read = _tp_counters()
    tr = EarlTrainer(model=model, env=TicTacToe(),
                     selector=dp_tp_selector(2 if spmd else 1),
                     noise=dp_noise(torch), **DP_TRAIN)
    p = ({k: v.to(DP_DEVICE) for k, v in params.items()}
         if rank == 0 or not spmd else
         {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
          for k, v in params.items()})
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    p, _, hist = tr.train(2, params=p, opt_state=tr.optimizer.init(p))
    torch.cuda.synchronize()
    out = dict(seconds=time.perf_counter() - t0, launches=read(),
               records=[dict(loss=r.loss, kl=r.kl, ret=r.mean_return,
                             ctx=r.mean_context_len, turn=r.mean_turn_len,
                             sw=r.selector_switch) for r in hist],
               params_equal=_same_on_ranks(torch, p) if spmd else None)
    del tr, p, hist
    torch.cuda.empty_cache()
    return out


def _same_on_ranks(torch, tree) -> bool:
    """Whether rank 1's tensors of ``tree`` equal rank 0's bitwise: rank 1
    sends each tensor's bytes to rank 0 through the host, and rank 0
    broadcasts the answer (both ranks of tp_path call)."""
    import torch.distributed as dist
    same = True
    for k in sorted(tree):
        v = tree[k].detach().contiguous().view(-1).view(torch.uint8).cpu()
        if dist.get_rank() == 1:
            dist.send(v, 0)
        else:
            got = torch.empty_like(v)
            dist.recv(got, 1)
            same &= torch.equal(got, v)
    box = [same]
    dist.broadcast_object_list(box, src=0)
    return box[0]


# tp_path's run (e): the update step alone, data-parallel over the update
# mesh dp=2 (each rank 4 of TP_BATCH rows, the gradients summed over the
# ranks in f32), on full-width qwen2-0.5b at all 24 layers in bf16, with
# every loss term and metric on (PPO clip, KL, truncated IS), on one
# batch of UPDATE_DP_SEQ tokens a row made from a seed, against rank 0's
# one-rank update of all 8 rows (tests/test_torch_update_dp.py is its CPU
# twin against JAX's two-device UpdateStage)
UPDATE_DP_SEQ = 256
UPDATE_DP = dict(clip_eps=0.2, kl_coef=0.05, is_rho_max=2.0)


def update_batch(torch, vocab: int, device, rows: int = TP_BATCH):
    """Run (e)'s ``ExperienceBatch``: ``rows`` rows of UPDATE_DP_SEQ
    random tokens, 40% of them in the loss, with behaviour and reference
    log-probs there, from a seeded host generator."""
    from repro_torch.rl.experience import ExperienceBatch
    g = torch.Generator().manual_seed(7)
    B, T = rows, UPDATE_DP_SEQ
    gen = torch.rand((B, T), generator=g) < 0.4
    lp = lambda: torch.where(gen, -torch.rand((B, T), generator=g) * 8 - 4,
                             0.0)
    rewards = torch.randint(-1, 2, (B,), generator=g).float()
    batch = ExperienceBatch(
        tokens=torch.randint(0, vocab, (B, T), generator=g,
                             dtype=torch.int32),
        gen_mask=gen, loss_mask=gen, logprobs=lp(), ref_logprobs=lp(),
        rewards=rewards, returns=rewards,
        advantages=rewards - rewards.mean(),
        context_len=torch.full((B,), T, dtype=torch.int32),
        truncated=torch.zeros((B,), dtype=torch.bool))
    return ExperienceBatch(*(x.to(device) for x in batch))


def update_dp(torch, model, full32, rank: int) -> dict:
    """tp_path's run (e) on one rank (both call): the dp=2 update step on
    this rank's 4 rows (the gradients and metrics summed over the ranks'
    update group), then, on rank 0, the one-rank update of all 8 rows.
    Returns each run's seconds, flash launches, peak bytes above the
    params and loss, whether both ranks' new params are bitwise equal,
    and (rank 0) each leaf's largest gradient error between the dp=2 run,
    the one-rank run and an f32 evaluation of the same bf16 weights on
    the same rows, absolute and over the f32 leaf's largest |g|."""
    from repro_torch.core.resharding import MeshConfig
    from repro_torch.core.train_step import make_rl_train_step
    from repro_torch.models.tensor_parallel import update_group
    from repro_torch.optim.adamw import adamw, apply_updates
    from repro_torch.rl.experience import ExperienceBatch
    reset, read = _tp_counters()
    opt = adamw(1e-3, weight_decay=0.0)
    step = make_rl_train_step(model, opt, attn_impl="flash", **UPDATE_DP)
    params = {k: v.to(DP_DEVICE, torch.bfloat16) for k, v in full32.items()}
    batch = update_batch(torch, model.cfg.vocab_size, DP_DEVICE)
    h = TP_BATCH // 2
    group = update_group(MeshConfig(*DP2))

    def run(rows, g):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset()
        t0 = time.perf_counter()
        (loss, metrics), grads = step.grads_of(params, rows, group=g)
        updates, _ = opt.update(grads, opt.init(params), params)
        new = apply_updates(params, updates)
        torch.cuda.synchronize()
        res = dict(seconds=time.perf_counter() - t0, launches=read(),
                   peak_bytes=torch.cuda.max_memory_allocated() - base,
                   loss=float(loss),
                   metrics={k: float(v) for k, v in metrics.items()})
        return res, grads, new

    mine = ExperienceBatch(*(x[rank * h:(rank + 1) * h] for x in batch))
    dp, grads, new = run(mine, group)
    t0 = time.perf_counter()
    dp["params_equal"] = _same_on_ranks(torch, new)
    dp["compare_seconds"] = time.perf_counter() - t0
    out = {"dp": dp}
    del new
    if rank == 0:
        one, grads_one, new = run(batch, None)
        del new
        # an f32 evaluation of the same bf16 weights on the same rows: how
        # far each bf16 run's gradients lie from it, leaf by leaf
        p32 = {k: v.float() for k, v in params.items()}
        _, g32 = step.grads_of(p32, batch)
        del p32
        pairs = {"dp_vs_one": (grads, grads_one), "dp_vs_f32": (grads, g32),
                 "one_vs_f32": (grads_one, g32)}
        absolute = {n: {k: float((a[k].float() - b[k].float()).abs().max())
                        for k in b} for n, (a, b) in pairs.items()}
        errs = {n: {k: e / float(g32[k].abs().max().clamp_min(1e-30))
                    for k, e in d.items()} for n, d in absolute.items()}
        del g32
        worst = {n: max(e, key=e.get) for n, e in errs.items()}
        out.update(one=one, grad_abs=absolute, grad_errs=errs, grad_worst={
            n: [k, errs[n][k]] for n, k in worst.items()},
            remat=model.cfg.remat)
        del grads_one
    del grads, params
    torch.cuda.empty_cache()
    return out


# tp_path's runs (f) and (g): layouts whose moe dispatch groups or LM
# microbatch slices straddle the update's two ranks, on full-width
# granite-moe-3b-a800m (d 1,536, 24/8 heads, 40 experts top-8, V 49,155)
# cut to STRADDLE_LAYERS of its 32 layers, in bf16 with its remat: B=6
# rows of UPDATE_DP_SEQ tokens, 3 a rank. (f) the policy-gradient step:
# 1,536 tokens in three 512-token groups, the middle one cut by the ranks'
# edge; (g) the LM step in STRADDLE_MICROBATCH slices of 2 rows, one
# 512-token group each, the middle slice (and its group) cut the same way
STRADDLE_LAYERS = 4
STRADDLE_ROWS = 6
STRADDLE_MICROBATCH = 3


def _recording(opt, log):
    """``opt`` logging the gradients each update is given."""
    from repro_torch.optim.adamw import Optimizer

    def update(grads, state, params):
        log.append(grads)
        return opt.update(grads, state, params)
    return Optimizer(init=opt.init, update=update)


def straddle_dp(torch, weights, rank: int) -> dict:
    """tp_path's runs (f) and (g) on one rank (both call), on ``weights``
    (granite-moe's fp32 and bf16 host tensors at MOE_LAYERS, viewed at
    STRADDLE_LAYERS): each step at dp=2 on this rank's 3 rows (the
    straddling group's tokens moved between the ranks in every layer,
    forward, backward and the remat's rerun), then on rank 0 the one-rank
    step on all 6 rows and an f32 evaluation of the same weights. Returns
    each run's seconds, flash launches, peak bytes above the params, loss
    and metrics, whether both ranks' new params are bitwise equal, and
    (rank 0) each leaf's largest gradient error between the dp=2 run, the
    one-rank run and the f32 evaluation, absolute and over the f32 leaf's
    largest |g| (the gradients AdamW is given: (g)'s are the slices' f32
    sums over ``microbatch``)."""
    from repro_torch.configs import get_config
    from repro_torch.core.resharding import MeshConfig
    from repro_torch.core.train_step import (make_lm_train_step,
                                             make_rl_train_step)
    from repro_torch.models.registry import build_model
    from repro_torch.models.tensor_parallel import update_group
    from repro_torch.models.transformer import draft_params_view
    from repro_torch.optim.adamw import adamw, apply_updates
    from repro_torch.rl.experience import ExperienceBatch
    reset, read = _tp_counters()
    model = build_model(dataclasses.replace(
        get_config("granite-moe-3b-a800m"), n_layers=STRADDLE_LAYERS))
    opt = adamw(1e-3, weight_decay=0.0)
    rl = make_rl_train_step(model, opt, attn_impl="flash", **UPDATE_DP)
    full32, full16 = (draft_params_view(w, STRADDLE_LAYERS)
                      for w in weights)
    params = {k: v.to(DP_DEVICE) for k, v in full16.items()}
    batch = update_batch(torch, model.cfg.vocab_size, DP_DEVICE,
                         STRADDLE_ROWS)
    tokens = batch.tokens.long()
    labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -1)],
                       dim=1)
    h = STRADDLE_ROWS // 2
    group = update_group(MeshConfig(*DP2))

    def timed(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset()
        t0 = time.perf_counter()
        loss, metrics, grads, new = fn()
        torch.cuda.synchronize()
        res = dict(seconds=time.perf_counter() - t0, launches=read(),
                   peak_bytes=torch.cuda.max_memory_allocated() - base,
                   loss=float(loss),
                   metrics={k: float(v) for k, v in metrics.items()})
        return res, grads, new

    def rl_step(p, rows, g):
        def fn():
            (loss, metrics), grads = rl.grads_of(p, rows, group=g)
            updates, _ = opt.update(grads, opt.init(p), p)
            return loss, metrics, grads, apply_updates(p, updates)
        return timed(fn)

    def lm_step(p, rows, g):
        def fn():
            log = []
            step = make_lm_train_step(model, _recording(opt, log),
                                      attn_impl="flash",
                                      microbatch=STRADDLE_MICROBATCH)
            new, _, metrics = step(p, opt.init(p), tokens[rows],
                                   labels[rows], group=g)
            return metrics["loss"], metrics, log[0], new
        return timed(fn)

    # the dp=2 runs first, so that each rank's seconds are its own; then
    # rank 0's references. The card's bytes in use by every process
    # (beside preempt_path's) before and after them
    free, total = torch.cuda.mem_get_info()
    out, held = {"card_used_bytes": [total - free]}, {}
    for name, run, mine in (
            ("f", rl_step, ExperienceBatch(*(x[rank * h:(rank + 1) * h]
                                             for x in batch))),
            ("g", lm_step, slice(rank * h, (rank + 1) * h))):
        dp, grads, new = run(params, mine, group)
        t0 = time.perf_counter()
        dp["params_equal"] = _same_on_ranks(torch, new)
        dp["compare_seconds"] = time.perf_counter() - t0
        del new
        out[name] = {"dp": dp}
        if rank == 0:
            held[name] = grads
        del grads
    free, total = torch.cuda.mem_get_info()
    out["card_used_bytes"].append(total - free)
    for name, run, everything in (("f", rl_step, batch),
                                  ("g", lm_step, slice(None))):
        if rank:
            break
        grads = held.pop(name)
        one, grads_one, new = run(params, everything, None)
        del new
        p32 = {k: v.to(DP_DEVICE) for k, v in full32.items()}
        _, g32, new = run(p32, everything, None)
        del p32, new
        pairs = {"dp_vs_one": (grads, grads_one), "dp_vs_f32": (grads, g32),
                 "one_vs_f32": (grads_one, g32)}
        absolute = {n: {k: float((a[k].float() - b[k].float()).abs().max())
                        for k in b} for n, (a, b) in pairs.items()}
        errs = {n: {k: e / float(g32[k].abs().max().clamp_min(1e-30))
                    for k, e in d.items()} for n, d in absolute.items()}
        del g32, grads_one, grads
        torch.cuda.empty_cache()
        worst = {n: max(e, key=e.get) for n, e in errs.items()}
        out[name].update(one=one, grad_abs=absolute, grad_errs=errs,
                         grad_worst={n: [k, errs[n][k]]
                                     for n, k in worst.items()})
    out["remat"] = model.cfg.remat
    del params
    torch.cuda.empty_cache()
    return out


# the tp path's families: each at the depth its one-card phases run
# (MOE_LAYERS, SSM_LAYERS, HYBRID_LAYERS), on its own dense cache
TP_FAMILY_PATH = dict(cache_layout="dense", sampling="fused",
                      temperature=0.0, max_turns=2, max_turn_tokens=4,
                      max_context=96)


def _tp_families():
    """(arch, depth) of each family tp_path runs after qwen2-0.5b."""
    return (("granite-moe-3b-a800m", MOE_LAYERS), ("mamba2-370m", SSM_LAYERS),
            ("zamba2-1.2b", HYBRID_LAYERS))


def _f32_cache_model(torch, model):
    """``model`` on f32 caches: the moe, ssm and hybrid caches take no
    kv_dtype (as in JAX), so the fp32 rollouts swap ``init_cache``."""
    from repro_torch.models import hybrid, mamba, moe
    fam = {"moe": moe.init_cache, "ssm": mamba.init_cache,
           "hybrid": hybrid.init_cache}[model.cfg.family]
    return dataclasses.replace(
        model, _init_cache=lambda cfg, b, s, dtype=None, *, device=None,
        tp=None: fam(cfg, b, s, torch.float32, device=device, tp=tp))


def tp_worker(rank: int, world: int, store: str, go: str) -> int:
    """One rank of phase_tp_path (``chip_smoke.py --tp-worker RANK WORLD
    STORE GO``): joins the group, makes the weights, waits for the file
    ``GO``, runs, and prints its results as one ``TPRESULT`` JSON line."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config
    from repro_torch.core.resharding import MeshConfig, shard_params
    from repro_torch.models import transformer
    from repro_torch.models.registry import build_model
    from repro_torch.rl.engine import CompiledRolloutEngine
    from repro_torch.rl.envs import TicTacToe

    torch.backends.cuda.matmul.allow_tf32 = False
    # two threads: the other phases run beside the wait below
    torch.set_num_threads(2)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    cfg = get_config("qwen2-0.5b")
    model = build_model(cfg)
    # the same seeded weights on both ranks, made and kept on the host:
    # each rank moves only its shards to the card
    full32 = model.init(torch.Generator().manual_seed(0),
                        dtype=torch.float32, device="cpu")
    # and each family's, in fp32 and bf16 (tp_family)
    weights = {arch: _host_weights(torch, arch, depth)
               for arch, depth in _tp_families()}
    t_wait = time.perf_counter()
    while not os.path.exists(go):
        if time.perf_counter() - t_wait > 3600:
            return 1
        time.sleep(0.1)
    # the script waits for this phase: one thread, whose gloo all-reduces
    # of CUDA tensors took 1.57 ms against 2.21 with torch's default
    # threads (tools/gloo_allreduce_bench.py, PR 25)
    torch.set_num_threads(1)
    t_start = time.perf_counter()
    one, two = MeshConfig("tp1", 1, 1), MeshConfig("tp2", 1, 2)
    reset, read = _tp_counters()
    B = TP_BATCH
    gen = lambda: torch.Generator(device="cuda").manual_seed(1)
    out = {"rank": rank}

    def rollout(eng, params, ref, to_card, n=B):
        """One run of ``eng`` on ``params`` (host tensors: the whole tree
        copied to the card inside the run at tp=1, ``to_card``, and the
        rank's shards by the engine at tp=2) over ``n`` episodes, its
        launches, counters, seconds, pool bytes and peak memory."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset()
        t0 = time.perf_counter()
        if to_card:
            params = {k: v.cuda() for k, v in params.items()}
        exp, st = eng.run(params, B, n, ref_params=params if ref else None,
                          generator=gen())
        torch.cuda.synchronize()
        # this rank's own pool: a data row's share of the global one
        res = dict(seconds=time.perf_counter() - t0, launches=read(),
                   peak_bytes=torch.cuda.max_memory_allocated() - base,
                   returned=st.episodes_returned,
                   counters={c: int(getattr(st, c)) for c in TP_STATS},
                   pool_bytes=(pool_bytes(eng, eng.rank_pool_pages)
                               if eng.cache_layout == "paged" else 0),
                   pool_pages=eng.rank_pool_pages,
                   page_bytes=(pool_bytes(eng, 0)
                               if eng.cache_layout == "paged" else 0),
                   layout=repr(eng.experience_shardings.tokens.spec),
                   tokens=exp.tokens.cpu().tolist(),
                   logprobs=exp.logprobs.cpu().tolist(),
                   ref_logprobs=exp.ref_logprobs.cpu().tolist())
        del params, exp
        torch.cuda.empty_cache()
        return res

    # the option runs (a)-(c) and the dp runs (c)-(d) at CUT_LAYERS, views
    # of the same weights
    cut = build_model(dataclasses.replace(cfg, n_layers=CUT_LAYERS))
    cut32 = transformer.draft_params_view(full32, CUT_LAYERS)
    for kv in ("fp32", "bf16"):
        held_params = (full32 if kv == "fp32" else
                       {k: v.bfloat16() for k, v in full32.items()})
        # the bf16 rollouts, which only report token agreement, take one
        # turn and no folded reference
        settings = dict(TP_PATH, **({} if kv == "fp32" else
                                    {"max_turns": 1}))
        eng = CompiledRolloutEngine(model, TicTacToe(), mesh_config=one,
                                    kv_dtype=kv, **settings)
        if eng.in_mesh:          # rank 1 takes no part at tp=1
            out[f"{kv}_tp1"] = rollout(eng, held_params, kv == "fp32", True)
        elif kv == "fp32":
            # meanwhile rank 1 runs the dp runs' (c) at dp=1, alone
            alone = MeshConfig("dp1-rank1", 1, 1, device_offset=rank)
            out["int8_dp1"] = rollout(CompiledRolloutEngine(
                cut, TicTacToe(), mesh_config=alone, **DP_INT8), cut32, True,
                True)
        # the selector's switch: re-bind the engine to tp=2
        eng.bind_mesh(two)
        out[f"{kv}_tp"] = dict(heads=eng.tp.n_heads,
                               kv_heads=eng.tp.n_kv_heads,
                               vocab_local=eng.tp.vocab_local,
                               vocab_offset=eng.tp.vocab_offset,
                               d_ff_local=eng.tp.plan.d_ff_local)
        out[f"{kv}_tp2"] = rollout(eng, held_params, kv == "fp32", False)
        if kv == "bf16":
            # the first decode step's logits after a 12-token prompt
            # (prefill on the flash forward, decode on the paged kernel),
            # the shards gathered, against tp=1 on rank 0
            tok = torch.randint(0, cfg.vocab_size, (B, 13), device="cuda",
                                generator=gen())
            local = shard_params(held_params, eng.tp.plan, device="cuda")
            reset()
            with torch.no_grad():
                c = transformer.init_cache(cfg, B, 32, layout="paged",
                                           tp=eng.tp, device="cuda")
                _, c = transformer.prefill(cfg, local, tok[:, :12], c,
                                           attn_impl="paged", tp=eng.tp)
                lg, _ = transformer.decode_step(cfg, local, tok[:, 12], c,
                                                attn_impl="paged", tp=eng.tp)
                lg = eng.tp.gather_row(lg.float())
            out["logits_launches"] = read()
            del local, c
            if rank == 0:
                g16 = {k: v.cuda() for k, v in held_params.items()}
                with torch.no_grad():
                    c = transformer.init_cache(cfg, B, 32, layout="paged",
                                               device="cuda")
                    _, c = transformer.prefill(cfg, g16, tok[:, :12], c,
                                               attn_impl="paged")
                    lg1, _ = transformer.decode_step(cfg, g16, tok[:, 12], c,
                                                     attn_impl="paged")
                out["bf16_logits"] = dict(
                    max_abs_err=float((lg - lg1.float()).abs().max()),
                    scale=float(lg1.float().abs().max()))
                del g16, c
        del eng
        torch.cuda.empty_cache()
    del held_params
    out["seconds"] = time.perf_counter() - t_start
    t0 = time.perf_counter()
    out["dp"] = tp_dp(torch, model, full32, cut, cut32, rollout, rank, gen,
                      reset, read)
    out["dp_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["options"] = tp_options(torch, cut, cut32, rollout, rank, two)
    out["options_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["dp_options"] = dp_options(torch, cut, cut32, rollout)
    out["dp_options_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["async"] = tp_async(torch, cut, cut32, rank, spmd=True)
    out["async_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["dp_train"] = dp_train(torch, cut, cut32, rank, spmd=True)
    out["dp_train_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["update_dp"] = update_dp(torch, model, full32, rank)
    out["update_dp_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["straddle"] = straddle_dp(torch, weights["granite-moe-3b-a800m"],
                                  rank)
    out["straddle_seconds"] = time.perf_counter() - t0
    out["families"] = {}
    for arch, depth in _tp_families():
        t0 = time.perf_counter()
        fam = tp_family(torch, arch, depth, weights.pop(arch), rank, rollout,
                        reset, read, gen)
        out["families"][arch] = dict(fam, seconds=time.perf_counter() - t0)
    dist.barrier()
    dist.destroy_process_group()
    # the references of (c) and (d): the same two steps on one rank alone,
    # outside any process group, (c)'s on rank 0 and (d)'s on rank 1
    if rank == 0:
        out["async_one"] = tp_async(torch, cut, cut32, rank, spmd=False)
    else:
        out["dp_train_one"] = dp_train(torch, cut, cut32, rank, spmd=False)
    del full32, cut32
    print("TPRESULT " + json.dumps(out), flush=True)
    return 0


# seq_path: qwen2-0.5b's 14 q heads do not divide 4 model ranks, so the tp
# plan replicates attention and a prompt of SEQ_TOKENS (JAX's threshold,
# layers.SEQ_PARALLEL_MIN_S) splits its queries over the ranks
SEQ_WORLD = 4
SEQ_TOKENS = 16384


def seq_worker(rank: int, world: int, store: str, go: str) -> int:
    """One rank of phase_seq_path (``chip_smoke.py --seq-worker RANK WORLD
    STORE GO``): joins the gloo group, waits for the file ``GO``, makes
    qwen2-0.5b's weights from seed 0 on the host (tp_path's, in bf16),
    runs, and prints its results as one ``SEQRESULT`` JSON line.

    The rank's paged prefill of one SEQ_TOKENS-token prompt at tp=4 with
    the flash kernels, twice: first with the split off (the module's
    threshold set above the prompt in this process: attention replicated,
    every rank all rows), then on (each rank its 4,096 rows at its
    offset, gathered before the o-proj). Each run: the forward's
    launches, the (S_q, Sk, q_offset) of each call and the FLOPs
    ``ops.work`` counts for them, seconds and peak bytes; then whether
    the split run's cache (every layer's K/V, the block table) and its
    gathered last-position logits are bitwise the replicated run's. In
    turns, one rank at a time, each times the forward at its first
    layer's inputs of both runs (median of 20 cold calls). After the
    group ends, rank 0 runs the whole model at tp=1 in bf16 and in fp32
    (fp32 params and cache, the f32 SIMT kernel): the split run's logits
    against tp=1's, and tp=1's own distance from fp32."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config
    from repro_torch.core.resharding import MeshConfig, shard_params, tp_plan
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import layers, transformer
    from repro_torch.models.registry import build_model
    from repro_torch.models.tensor_parallel import TPContext

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    t_wait = time.perf_counter()
    while not os.path.exists(go):
        if time.perf_counter() - t_wait > 3600:
            return 1
        time.sleep(0.1)
    t_start = time.perf_counter()
    cfg = get_config("qwen2-0.5b")
    model = build_model(cfg)
    full32 = model.init(torch.Generator().manual_seed(0),
                        dtype=torch.float32, device="cpu")
    params = {k: v.bfloat16() for k, v in full32.items()}
    if rank:
        del full32
    tok = torch.randint(0, cfg.vocab_size, (1, SEQ_TOKENS),
                        generator=torch.Generator().manual_seed(3)).cuda()
    plan = tp_plan(model, MeshConfig(f"tp{world}", 1, world))
    tp = TPContext(plan)
    local = shard_params(params, plan, device="cuda")
    out = {"rank": rank, "index": tp.index, "attn": plan.attn,
           "fallbacks": plan.fallbacks,
           "init_seconds": time.perf_counter() - t_start}
    fwd = fa_ops.flash_attention_fwd
    calls, first = [], []

    def recorded(q, k, v, causal=True, window=0, q_offset=0):
        calls.append((q.shape[1], k.shape[1], int(q_offset)))
        if not first:
            first.append((q, k, v, int(q_offset)))
        return fwd(q, k, v, causal, window, q_offset)

    fa_ops.flash_attention_fwd = recorded
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_

    def prefill(split: bool):
        layers.SEQ_PARALLEL_MIN_S = SEQ_TOKENS if split else SEQ_TOKENS + 1
        calls.clear()
        first.clear()
        fa_ops.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        dist.barrier()
        t0 = time.perf_counter()
        with torch.no_grad():
            c = transformer.init_cache(cfg, 1, SEQ_TOKENS, layout="paged",
                                       tp=tp, device="cuda")
            lg, c = transformer.prefill(cfg, local, tok, c,
                                        attn_impl="flash", tp=tp)
            lg = tp.gather_row(lg.float())
        torch.cuda.synchronize()
        res = dict(seconds=time.perf_counter() - t0,
                   launches=fa_ops.launches["fwd"],
                   shapes=sorted(set(calls)),
                   flops=sum(fa_ops.work("fwd", 1, sq, sk, H, KV, hd, 2,
                                         True, 0, off)[1]
                             for sq, sk, off in calls),
                   peak_bytes=torch.cuda.max_memory_allocated() - base)
        return res, lg, c, first[0]

    out["replicated"], lg_rep, c_rep, qkv_rep = prefill(False)
    out["split"], lg_spl, c_spl, qkv_spl = prefill(True)
    layers.SEQ_PARALLEL_MIN_S = SEQ_TOKENS
    out["cache_bitwise"] = all(torch.equal(a, b) for a, b in (
        (c_rep.kv.k, c_spl.kv.k), (c_rep.kv.v, c_spl.kv.v),
        (c_rep.block_table, c_spl.block_table)))
    out["logits_bitwise"] = torch.equal(lg_rep, lg_spl)
    del c_rep, c_spl, lg_rep
    torch.cuda.empty_cache()
    # the forward at this rank's first-layer inputs, one rank at a time
    for r in range(world):
        dist.barrier()
        if r == rank:
            for key, (q, k, v, off) in (("split", qkv_spl),
                                        ("replicated", qkv_rep)):
                out[key]["kernel_ms"] = time_cold(
                    torch, lambda: fwd(q, k, v, True, 0, off), 20)
    del qkv_rep, qkv_spl, local
    out["seconds"] = time.perf_counter() - t_start
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        def one_rank(p, kv_dtype):
            p = {k: v.cuda() for k, v in p.items()}
            with torch.no_grad():
                c = transformer.init_cache(cfg, 1, SEQ_TOKENS, layout="paged",
                                           kv_dtype=kv_dtype, device="cuda")
                lg, _ = transformer.prefill(cfg, p, tok, c, attn_impl="flash")
            del p, c
            torch.cuda.empty_cache()
            return lg.float()

        lg1 = one_rank(params, "bf16")
        lg32 = one_rank(full32, "fp32")
        out["tp1"] = dict(
            max_abs_err=float((lg_spl - lg1).abs().max()),
            scale=float(lg1.abs().max()),
            tp1_from_f32=float((lg1 - lg32).abs().max()),
            split_from_f32=float((lg_spl - lg32).abs().max()),
            greedy_equal=bool((lg_spl.argmax(-1) == lg1.argmax(-1)).all()))
        out["tp1_seconds"] = time.perf_counter() - t_start - out["seconds"]
    print("SEQRESULT " + json.dumps(out), flush=True)
    return 0


def _host_weights(torch, arch, depth):
    """``arch``'s seeded weights at ``depth`` layers on the host, fp32 and
    bf16: the same on every rank."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    model = build_model(dataclasses.replace(get_config(arch),
                                            n_layers=depth))
    full32 = model.init(torch.Generator().manual_seed(0),
                        dtype=torch.float32, device="cpu")
    return full32, {k: v.bfloat16() for k, v in full32.items()}


def tp_family(torch, arch, depth, weights, rank, rollout, reset, read, gen):
    """One family's part of a tp_path rank (``tp_worker``): ``arch`` at
    its published widths and ``depth`` layers, on ``weights`` (its fp32
    and bf16 host tensors, ``_host_weights``); the fp32 rollouts (2 turns,
    the folded reference) on f32 caches at tp=1 (rank 0) and, after
    ``bind_mesh``, at tp=2; then the bf16 ones (1 turn) on the family's
    bf16 caches; then the bf16 first decode step's logits after a
    12-token prompt (prefill on the flash forward where the family has
    attention, decode on the decode attention kernel), the shards
    gathered, against tp=1 on rank 0, and rank 0's tp=1 f32 evaluation
    of the same step (the bf16 runs' drift from it). Also the bytes the
    rank receives under the plan (carried: ``in_proj`` and the conv travel
    whole) and keeps."""
    from repro_torch.configs import get_config
    from repro_torch.core.resharding import (MeshConfig, shard_bytes,
                                             shard_params, tp_plan)
    from repro_torch.models.registry import build_model
    from repro_torch.rl.engine import CompiledRolloutEngine
    from repro_torch.rl.envs import TicTacToe

    cfg = dataclasses.replace(get_config(arch), n_layers=depth)
    model = build_model(cfg)
    one, two = MeshConfig("tp1", 1, 1), MeshConfig("tp2", 1, 2)
    B = TP_BATCH
    full32, full16 = weights
    plan = tp_plan(model, two)
    carried, kept = shard_bytes(full32, plan)
    out = dict(param_bytes=sum(v.nbytes for v in full32.values()),
               carried_bytes=carried, kept_bytes=kept,
               fallbacks=plan.fallbacks)
    for kv in ("fp32", "bf16"):
        fp32 = kv == "fp32"
        held = full32 if fp32 else full16
        m = _f32_cache_model(torch, model) if fp32 else model
        settings = dict(TP_FAMILY_PATH, **({} if fp32 else
                                           {"max_turns": 1}))
        eng = CompiledRolloutEngine(m, TicTacToe(), mesh_config=one,
                                    **settings)
        if eng.in_mesh:          # rank 1 takes no part at tp=1
            out[f"{kv}_tp1"] = rollout(eng, held, fp32, True)
        eng.bind_mesh(two)
        tp = eng.tp
        out["tp"] = dict(heads=tp.n_heads, kv_heads=tp.n_kv_heads,
                         experts=tp.experts_local, ssm_heads=tp.ssm_heads,
                         vocab_local=tp.vocab_local,
                         vocab_split=tp.vocab_split)
        out[f"{kv}_tp2"] = rollout(eng, held, fp32, False)
        if not fp32:
            tok = torch.randint(0, cfg.vocab_size, (B, 13), device="cuda",
                                generator=gen())
            pre = "xla" if cfg.family == "ssm" else "flash"
            local = shard_params(held, tp.plan, device="cuda")
            reset()
            with torch.no_grad():
                c = model.init_cache(B, 32, device="cuda", tp=tp)
                _, c = model.prefill(local, tok[:, :12], c, attn_impl=pre,
                                     tp=tp)
                lg, _ = model.decode_step(local, tok[:, 12], c,
                                          attn_impl="pallas", tp=tp)
                lg = tp.gather_row(lg.float())
            out["logits_launches"] = read()
            del local, c
            if rank == 0:
                lg1, lg32 = (_first_step_logits(torch, mm, params, tok, pre)
                             for mm, params in (
                                 (model, full16),
                                 (_f32_cache_model(torch, model), full32)))
                out["bf16_logits"] = dict(
                    max_abs_err=float((lg - lg1).abs().max()),
                    scale=float(lg1.abs().max()),
                    tp1_drift_from_f32=float((lg1 - lg32).abs().max()),
                    tp2_drift_from_f32=float((lg - lg32).abs().max()))
        del eng, held
        torch.cuda.empty_cache()
    return out


def _first_step_logits(torch, model, params, tok, pre):
    """tp=1 logits (f32) of the decode step after a prefill of ``tok``'s
    first 12 tokens, with ``params`` (host tensors) moved to the card."""
    params = {k: v.cuda() for k, v in params.items()}
    with torch.no_grad():
        c = model.init_cache(tok.shape[0], 32, device="cuda")
        _, c = model.prefill(params, tok[:, :12], c, attn_impl=pre)
        lg, _ = model.decode_step(params, tok[:, 12], c, attn_impl="pallas")
    del params, c
    torch.cuda.empty_cache()
    return lg.float()


def phase_tp_path(torch, report, workers: TPWorkers):
    """Full-width qwen2-0.5b (24 layers, 14/2 heads, d_ff 4,864, V=151,936)
    at tp=2: two processes (``tp_worker``), each a rank with 7 q heads,
    1 kv head, d_ff 2,432 and V=75,968, share the one H100 over gloo. NCCL
    refuses two ranks on one device; gloo all-reduces and broadcasts CUDA
    tensors by staging them through the host, which is all the tp rollout
    calls. So this shows correctness and per-rank memory, not speed, and
    the one-host-read-per-turn check (set_sync_debug_mode("error")) cannot
    hold here: every all-reduce is a host round trip. The sync phases keep
    that check on every other path.

    Each rank binds the engine to tp=1 (rank 1 outside it takes no part)
    and rank 0 rolls out the whole model; then both re-bind to tp=2 (the
    selector's switch) and roll out on their shards: a paged rollout with
    the folded reference and fused sampling, B=8, 2 turns of 4 tokens,
    greedy, at fp32 params and KV; then at bf16, one turn without the
    reference.
    The workers start with the script and wait (``TPWorkers``), so their
    start-up is not this phase's; the script lets them go just before
    preempt_path, which runs beside them, so ``seconds`` is the
    wait left after preempt_path and ``since_go_s`` the ranks' whole span
    (their runs' seconds are read beside preempt_path's work). Gates: at
    fp32 the tp=2 tokens equal
    tp=1's on both ranks, the log-probs within 1e-4 (f32 sums in another
    order) and the reference's within 1e-2 (it decodes on a bf16 cache in
    both runs, as in JAX: K/V computed in another order can round to the
    neighbouring bf16 value, 2^-8 of it); both ranks' launch counts
    equal, paged and decode attention launches equal to tp=1's, the
    partial sampler's launches equal to tp=1's one-launch sampler's and
    no one-launch sampler at tp=2; the bf16 first decode step's logits
    within 5% of their scale (the port's bf16 rule), with one flash
    forward per layer in its prefill. Reported: bf16 token agreement
    (ungated, as in spec_branch), each rank's peak memory against tp=1,
    its launches and the seconds.

    Then the same ranks run the moe, ssm and hybrid families at their
    published widths (``tp_family``): granite-moe-3b-a800m at MOE_LAYERS
    (12/4 heads, 20 of 40 experts a rank; its 49,155 vocab rows stay whole
    on each rank), mamba2-370m at SSM_LAYERS (16 of 32 SSM heads, V=25,140
    a rank) and zamba2-1.2b at HYBRID_LAYERS (32 of 64 SSM heads, the
    shared block at 16/16 heads and d_ff 4,096, V=16,000 a rank), each on
    its dense cache: the fp32 rollouts on f32 caches with the folded
    reference, then bf16, then the bf16 first-step logits. Their gates and
    reports are ``tp_family_results``'s; each family also reports the
    bytes a rank receives (mamba2's and zamba2's ``in_proj`` and conv
    travel whole) and keeps.

    Between the two, the dp runs (``tp_dp``, ``dp_train``; gates and
    reports in ``tp_dp_results``): full-width qwen2-0.5b at dp=2, each rank
    a data row of 4 of the 8 slots on its half of the pool, at fp32 with
    the folded reference against the dp=1 run above, at bf16 for one turn,
    int8 pages at CUT_LAYERS against dp=1 on rank 0, two SPMD trainer
    steps at CUT_LAYERS switching dp2 -> tp2 against rank 0 alone, and the
    update step at dp=2 (run (e), below); after
    the option runs, their (a) and (b)'s pressured run again at dp=2
    (``dp_options``, gated by ``dp_option_results``) against their tp=1
    runs, on the global page count. And the option runs at full width and
    CUT_LAYERS
    (``tp_options``, ``tp_async``), each at tp=1 (rank 0) and tp=2: (a)
    speculation (``"self"``, K=4, 6 draft layers) on TicTacToe with its
    spec-off twin at tp=2; (b) the SHARED bandit at B=8, N=16 on int8
    pages with sharing, then also with preemption and pool growth from
    TP_POOL_PAGES pages; (c) two async steps of the SPMD trainer (the
    rollout switching to tp=2 at step 1, the update on both ranks of the
    update stage's tp=2 config, replicated) against the same two steps on
    rank 0 alone. Their gates and reports are ``tp_option_results``'s.
    Last of the dp runs, (e) the update step alone at dp=2 on full-width
    qwen2-0.5b in bf16, each rank 4 of 8 rows of 256 tokens, the
    gradients summed over the ranks, against rank 0's one-rank update
    (``update_dp``, gated by ``update_dp_results``); then (f) and (g), the
    layouts whose moe dispatch group or LM microbatch slice straddles the
    two ranks, on full-width granite-moe-3b-a800m at STRADDLE_LAYERS, each
    against rank 0's one-rank step (``straddle_dp``, gated by
    ``straddle_results``)."""
    t0 = time.perf_counter()
    workers.go()
    codes, texts = workers.wait(timeout=900)
    if any(codes):
        raise AssertionError("tp_path: a rank failed:\n" + "\n".join(
            t[-3000:] for t in texts))
    res = [json.loads(next(ln[9:] for ln in t.splitlines()
                           if ln.startswith("TPRESULT ")))
           for t in texts]
    r0, r1 = res
    T = lambda d, k: torch.tensor(d[k])
    fp = r0["fp32_tp1"], r0["fp32_tp2"], r1["fp32_tp2"]
    same_tokens = (fp[0]["tokens"] == fp[1]["tokens"] == fp[2]["tokens"])
    lp_err, ref_err = (float((T(fp[0], k) - T(fp[1], k)).abs().max())
                       for k in ("logprobs", "ref_logprobs"))
    launches_ok = True
    for kv in ("fp32", "bf16"):
        a, b, c = (r0[f"{kv}_tp1"]["launches"], r0[f"{kv}_tp2"]["launches"],
                   r1[f"{kv}_tp2"]["launches"])
        ref_launches = b["paged_attention"] if kv == "fp32" else 0
        launches_ok &= (b == c and b["paged_attention"] == a["paged_attention"]
                        > 0 and b["decode_attention"] == a["decode_attention"]
                        == ref_launches
                        and b["fused_sample_partial"] == a["fused_sample"]
                        > 0 and b["fused_sample"] == 0
                        and a["fused_sample_partial"] == 0
                        and b["paged_attention"] % 24 == 0)
    bl = r0["bf16_logits"]
    agree = sum(x == y for x, y in zip(r0["bf16_tp1"]["tokens"],
                                       r0["bf16_tp2"]["tokens"]))
    out = dict(
        phase="tp_path", arch="qwen2-0.5b", world=2, backend="gloo",
        batch=TP_BATCH, rank_shapes=r0["fp32_tp"],
        fp32_tokens_equal=same_tokens, fp32_logprob_max_abs_err=lp_err,
        fp32_ref_logprob_max_abs_err=ref_err,
        bf16_logits=dict(bl, tolerance=0.05 * bl["scale"]),
        bf16_rows_equal=agree, bf16_rows=TP_BATCH,
        launches={f"rank{r}": {k: v["launches"] for k, v in x.items()
                               if isinstance(v, dict) and "launches" in v}
                  for r, x in enumerate(res)},
        logits_launches=r0["logits_launches"],
        peak_bytes={f"rank{r}": {k: v["peak_bytes"] for k, v in x.items()
                                 if isinstance(v, dict) and "peak_bytes" in v}
                    for r, x in enumerate(res)},
        rollout_seconds={f"rank{r}": {k: v["seconds"] for k, v in x.items()
                                      if isinstance(v, dict)
                                      and "seconds" in v}
                         for r, x in enumerate(res)},
        worker_seconds=[x["seconds"] for x in res],
        seconds=time.perf_counter() - t0,
        since_go_s=time.perf_counter() - workers.t_go)
    out["peak_ratio_tp2_over_tp1"] = {
        kv: [x[f"{kv}_tp2"]["peak_bytes"] / r0[f"{kv}_tp1"]["peak_bytes"]
             for x in res] for kv in ("fp32", "bf16")}
    out["families"], families_ok = tp_family_results(torch, res)
    out["options"], options_ok = tp_option_results(torch, res)
    out["dp"], dp_ok = tp_dp_results(torch, res)
    out["dp_options"], dp_options_ok = dp_option_results(torch, res)
    emit(out)
    report["fused_sample_partial"]["launches"] = \
        r0["fp32_tp2"]["launches"]["fused_sample_partial"]
    opt = r0["options"]
    report["spec_verify"]["launches_tp2_spec"] = \
        opt["spec_tp2"]["launches"]["spec_verify"]
    report["paged_attention"]["launches_tp2_pool_int8"] = \
        opt["pool_tp2"]["launches"]["paged_attention"]
    report["paged_attention"]["launches_dp2_rank"] = \
        r0["dp"]["fp32_dp2"]["launches"]["paged_attention"]
    report["spec_verify"]["launches_dp2_spec"] = \
        r0["dp_options"]["spec_dp2"]["launches"]["spec_verify"]
    for k in ("flash_fwd", "flash_dq", "flash_dkv"):
        report[k]["launches_dp2_update"] = [
            x["update_dp"]["dp"]["launches"][k] for x in res]
        report[k]["launches_dp2_straddle"] = {
            n: [x["straddle"][n]["dp"]["launches"][k] for x in res]
            for n in ("f", "g")}
    if not (same_tokens and lp_err <= 1e-4 and ref_err <= 1e-2
            and launches_ok and families_ok and options_ok and dp_ok
            and dp_options_ok
            and bl["max_abs_err"] <= 0.05 * bl["scale"]
            and r0["logits_launches"]["flash_fwd"] == 24
            and all(x[f"{kv}_tp2"]["returned"] == TP_BATCH
                    for x in res for kv in ("fp32", "bf16"))):
        raise AssertionError(f"tp_path checks failed: {out}")


def phase_seq_path(torch, report, workers: TPWorkers):
    """Sequence-parallel attention (``models/layers.seq_parallel``) at
    full width: qwen2-0.5b (24 layers, 14/2 heads, bf16 weights from seed
    0) at tp=4, four gloo processes sharing the card (``seq_worker``),
    one SEQ_TOKENS-token prompt (B=1) through the paged prefill with the
    flash kernels, with the split off and on. The ranks start with the
    script and go once tp_path's ranks have exited (``go_after``), beside
    preempt_path; ``seconds`` is the wait left here and ``since_go_s``
    the group's whole span.

    Gates: the split run's cache (every layer's K/V and the block table)
    and last-position logits bitwise the replicated run's on every rank;
    its logits within tp_path's rule of one rank's tp=1 prefill (5% of the
    logit scale, or tp=1's own distance from fp32 where that is larger);
    every rank exactly 24 forward launches in each run, the split run's
    all at 4,096 rows from the rank's offset over 16,384 keys, the
    replicated run's at 16,384 rows; the ranks' counted forward FLOPs
    summing to the replicated rank's, rank r's share of them (2r+1)/16
    within 1e-3 (the causal pairs of a contiguous split). Reported: each
    rank's FLOPs, its forward's cold ms at its inputs against the
    replicated forward's, seconds and peak bytes."""
    t0 = time.perf_counter()
    workers.go()
    codes, texts = workers.wait(timeout=600)
    if any(codes):
        raise AssertionError("seq_path: a rank failed:\n" + "\n".join(
            t[-3000:] for t in texts))
    res = [json.loads(next(ln[10:] for ln in t.splitlines()
                           if ln.startswith("SEQRESULT ")))
           for t in texts]
    n = SEQ_TOKENS // SEQ_WORLD
    full = res[0]["replicated"]["flops"]
    shares = [x["split"]["flops"] / full for x in res]
    t1 = res[0]["tp1"]
    tol = max(0.05 * t1["scale"], t1["tp1_from_f32"])
    out = dict(
        phase="seq_path", arch="qwen2-0.5b", world=SEQ_WORLD,
        backend="gloo", batch=1, tokens=SEQ_TOKENS,
        attention=res[0]["attn"], fallbacks=res[0]["fallbacks"],
        cache_bitwise=[x["cache_bitwise"] for x in res],
        logits_bitwise=[x["logits_bitwise"] for x in res],
        launches={k: [x[k]["launches"] for x in res]
                  for k in ("split", "replicated")},
        shapes={k: [x[k]["shapes"] for x in res]
                for k in ("split", "replicated")},
        flops={k: [x[k]["flops"] for x in res]
               for k in ("split", "replicated")},
        flop_shares=shares,
        kernel_ms={k: [x[k]["kernel_ms"] for x in res]
                   for k in ("split", "replicated")},
        prefill_seconds={k: [x[k]["seconds"] for x in res]
                         for k in ("split", "replicated")},
        peak_bytes={k: [x[k]["peak_bytes"] for x in res]
                    for k in ("split", "replicated")},
        tp1=dict(t1, tolerance=tol),
        worker_seconds=[x["seconds"] for x in res],
        init_seconds=[x["init_seconds"] for x in res],
        tp1_seconds=res[0]["tp1_seconds"],
        seconds=time.perf_counter() - t0,
        since_go_s=time.perf_counter() - workers.t_go)
    emit(out)
    report["flash_fwd"]["launches_seq_tp4"] = out["launches"]["split"]
    ok = (all(out["cache_bitwise"]) and all(out["logits_bitwise"])
          and [x["index"] for x in res] == list(range(SEQ_WORLD))
          and res[0]["attn"] == "replicated"
          and out["launches"]["split"] == [24] * SEQ_WORLD
          and out["launches"]["replicated"] == [24] * SEQ_WORLD
          and all(x["split"]["shapes"] == [[n, SEQ_TOKENS, r * n]]
                  for r, x in enumerate(res))
          and all(x["replicated"]["shapes"] == [[SEQ_TOKENS, SEQ_TOKENS, 0]]
                  for x in res)
          and sum(x["split"]["flops"] for x in res) == full
          and all(x["replicated"]["flops"] == full for x in res)
          and all(abs(sh - (2 * r + 1) / 16) <= 1e-3
                  for r, sh in enumerate(shares))
          and t1["max_abs_err"] <= tol)
    if not ok:
        raise AssertionError(f"seq_path checks failed: {out}")


def tp_option_results(torch, res):
    """The option runs' part of tp_path (``tp_options``, ``tp_async``)
    from both ranks' results: the gates, what is reported, and whether
    every gate held.

    (a) spec: the tp=2 tokens on both ranks equal tp=1's speculative run's
    and tp=2's spec-off run's; the log-probs within 1e-4 of tp=1's (f32
    sums in another order, tp_path's rule); the spec counters (proposed,
    accepted, rounds) and the spec-verify launches equal on both ranks and
    to tp=1's, one launch a layer a verify round.
    (b) pool, pool_preempt: every episode returned and no dropped write;
    the tp=2 tokens on both ranks equal tp=1's same run; preemptions,
    pool growths and the shared prefix equal on both ranks and to tp=1's,
    with at least one preemption and one growth in pool_preempt; paged
    attention launched on both ranks as often as at tp=1. Reported: each
    rank's pool bytes against tp=1's.
    (c) async: both ranks keep the one-rank run's policy lags [0, 1]; the
    update rank's batches' tokens equal the one-rank run's, their
    log-probs within 1e-4 and their folded reference log-probs within
    1e-2 (tp_path's rules); the losses within 1e-5 of the one-rank run's;
    both ranks ran the two updates of the update stage's tp2 config
    (replicated over the model axis): rank 1 saw rank 0's batches, each
    launched the flash backward as often as the one-rank run, and their
    final params are bitwise equal; the rollout switched to tp2 at step
    1."""
    T = lambda d, k: torch.tensor(d[k])
    o0, o1 = (x["options"] for x in res)
    out, ok = {}, True
    for name in ("spec", "pool", "pool_preempt"):
        a = o0.get(f"{name}_tp1") or o1[f"{name}_tp1"]
        b, c = o0[f"{name}_tp2"], o1[f"{name}_tp2"]
        same = a["tokens"] == b["tokens"] == c["tokens"]
        lp_err = float((T(a, "logprobs") - T(b, "logprobs")).abs().max())
        counters_equal = a["counters"] == b["counters"] == c["counters"]
        la, lb, lc = a["launches"], b["launches"], c["launches"]
        row = dict(tokens_equal=same, logprob_max_abs_err=lp_err,
                   counters=b["counters"], counters_equal=counters_equal,
                   launches={"tp1": la, "rank0": lb, "rank1": lc},
                   seconds={"tp1": a["seconds"], "rank0": b["seconds"],
                            "rank1": c["seconds"]},
                   peak_bytes={"tp1": a["peak_bytes"],
                               "rank0": b["peak_bytes"],
                               "rank1": c["peak_bytes"]})
        if name == "spec":
            off0, off1 = o0["spec_off_tp2"], o1["spec_off_tp2"]
            rounds_layers = lb["spec_verify"] % CUT_LAYERS == 0
            row.update(spec_off_tokens_equal=(
                off0["tokens"] == off1["tokens"] == b["tokens"]),
                spec_off_seconds=[off0["seconds"], off1["seconds"]])
            row_ok = (same and row["spec_off_tokens_equal"]
                      and lp_err <= 1e-4 and counters_equal
                      and lb["spec_verify"] == lc["spec_verify"]
                      == la["spec_verify"] > 0 and rounds_layers
                      and b["counters"]["spec_rounds"] > 0)
        else:
            returned = all(x["returned"] == TP_EPISODES for x in (a, b, c))
            pressured = (b["counters"]["preemptions"] > 0
                         and b["counters"]["pool_grows"] > 0)
            row.update(returned_all=returned,
                       pool_bytes={"tp1": a["pool_bytes"],
                                   "rank0": b["pool_bytes"],
                                   "rank1": c["pool_bytes"]},
                       pool_bytes_ratio=[x["pool_bytes"] / a["pool_bytes"]
                                         for x in (b, c)])
            if name == "pool_preempt":
                row.update(pool_pages=TP_POOL_PAGES, pressured=pressured)
            row_ok = (same and returned and counters_equal
                      and b["counters"]["kv_dropped_writes"] == 0
                      and b["counters"]["shared_prefix_len"] == 96
                      and lb["paged_attention"] == lc["paged_attention"]
                      == la["paged_attention"] > 0
                      and (pressured or name == "pool"))
        row["ok"] = row_ok
        ok &= row_ok
        out[name] = row
    one = res[0]["async_one"]
    a0, a1 = (x["async"] for x in res)
    loss_err = max(abs(x - y) for x, y in zip(a0["losses"], one["losses"]))
    lp_err, ref_err = (float((T(a0, k) - T(one, k)).abs().max())
                       for k in ("logprobs", "ref_logprobs"))
    sw = a0["switches"]
    row_ok = (a0["lags"] == a1["lags"] == one["lags"] == [0, 1]
              and a0["tokens"] == one["tokens"] and len(a0["tokens"]) == 2
              and a1["tokens"] == a0["tokens"] and loss_err <= 1e-5
              and lp_err <= 1e-4 and ref_err <= 1e-2
              and a0["losses"] == a1["losses"]
              and a0["params_equal"] is True
              and a1["launches"]["flash_dq"] == a0["launches"]["flash_dq"]
              == one["launches"]["flash_dq"] > 0
              and sw[1] is not None and sw[1]["to"] == "tp2")
    out["async"] = dict(
        ok=row_ok, lags=a0["lags"], tokens_equal=a0["tokens"] == one["tokens"],
        loss_max_abs_err=loss_err, losses=a0["losses"],
        params_equal=a0["params_equal"],
        logprob_max_abs_err=lp_err, ref_logprob_max_abs_err=ref_err,
        switches=sw, launches={"rank0": a0["launches"],
                               "rank1": a1["launches"],
                               "one_rank": one["launches"]},
        seconds={"rank0": a0["seconds"], "rank1": a1["seconds"],
                 "one_rank": one["seconds"]})
    ok &= row_ok
    out["seconds"] = {f"rank{r}": {"options": x["options_seconds"],
                                   "async": x["async_seconds"]}
                      for r, x in enumerate(res)}
    return out, ok


def tp_dp_results(torch, res):
    """The dp runs' part of tp_path (``tp_dp``, ``dp_train``) from both
    ranks' results: the gates, what is reported, and whether every gate
    held. Rank r holds episodes [4r, 4r + 4) of the dp=1 run's 8.

    (a) fp32_dp2: each rank's tokens equal the dp=1 run's rows (rank 0's
    ``fp32_tp1``), log-probs within 1e-4 (f32 GEMMs at 4 rows against 8
    may sum in another order), the folded reference's within 1e-2
    (tp_path's rule); episodes returned, pages in use and page capacity
    equal dp=1's; each rank's paged, decode-attention and one-launch
    sampler launches equal dp=1's (every row runs the same macro-steps);
    the batch over ``data``; each rank's pool bytes at most half of
    dp=1's plus one page.
    (b) bf16_dp2: every episode returned; the first decode step's logits
    at the rank's 4 rows within 5% of their scale of all 8 rows' (the
    port's bf16 rule). Reported: token agreement with dp=1's bf16 run.
    (c) int8_dp2 at CUT_LAYERS: tokens and TP_STATS counters equal dp=1's
    int8 run's (rank 1's), log-probs within 2e-4 (the int8 rule of tp_path's option
    runs), pool bytes (scales included) at most half of dp=1's plus one
    page, paged launches equal dp=1's.
    (d) dp_train: the records (loss, KL, return, context and turn
    length, the switch row) equal on both ranks and within 1e-5 of the
    one-rank trainer's (rank 1's, after the group is gone), some loss not
    zero, the rollout switched dp2 -> tp2 at step 1, both ranks ran the
    updates of the update stage's tp2 config (replicated over the model
    axis: each launched the flash backward as often as the one-rank run)
    and their final params are bitwise equal.
    (e) update_dp (``update_dp_results``).
    (f) and (g) straddle_dp (``straddle_results``).
    Reported: each run's seconds and each rank's peak memory against
    dp=1's."""
    T = torch.tensor
    h = TP_BATCH // 2
    r0 = res[0]
    d = [x["dp"] for x in res]
    mine = lambda rows, r: rows[r * h:(r + 1) * h]
    err = lambda a, b: float((T(a) - T(b)).abs().max())
    out, ok = {}, True
    for name, one, lp_tol in (("fp32_dp2", r0["fp32_tp1"], 1e-4),
                              ("int8_dp2", res[1]["int8_dp1"], 2e-4)):
        runs = [x[name] for x in d]
        tokens = all(x["tokens"] == mine(one["tokens"], r)
                     for r, x in enumerate(runs))
        lp = max(err(x["logprobs"], mine(one["logprobs"], r))
                 for r, x in enumerate(runs))
        ref = max(err(x["ref_logprobs"], mine(one["ref_logprobs"], r))
                  for r, x in enumerate(runs))
        counters = all(x["counters"] == one["counters"]
                       and x["returned"] == one["returned"] == TP_BATCH
                       for x in runs)
        keys = (("paged_attention",) if name == "int8_dp2" else
                ("paged_attention", "decode_attention", "fused_sample"))
        launches = all(x["launches"][k] == one["launches"][k] > 0
                       for x in runs for k in keys)
        pool = all(x["pool_bytes"] <= 0.5 * one["pool_bytes"]
                   + x["page_bytes"] for x in runs)
        layout = all(x["layout"] == "('data', None)"
                     and len(x["tokens"]) == h for x in runs)
        row_ok = (tokens and lp <= lp_tol and counters and launches
                  and pool and layout
                  and (name == "int8_dp2" or ref <= 1e-2))
        out[name] = dict(
            ok=row_ok, tokens_equal=tokens, logprob_max_abs_err=lp,
            ref_logprob_max_abs_err=ref, counters=runs[0]["counters"],
            counters_equal=counters, launches_equal=launches,
            layout=runs[0]["layout"],
            pool_bytes={"dp1": one["pool_bytes"],
                        "rank0": runs[0]["pool_bytes"],
                        "rank1": runs[1]["pool_bytes"]},
            pool_ratio=[x["pool_bytes"] / one["pool_bytes"] for x in runs],
            launches={"dp1": one["launches"], "rank0": runs[0]["launches"],
                      "rank1": runs[1]["launches"]},
            peak_ratio=[x["peak_bytes"] / one["peak_bytes"] for x in runs],
            seconds={"dp1": one["seconds"], "rank0": runs[0]["seconds"],
                     "rank1": runs[1]["seconds"]})
        ok &= row_ok
    b16 = [x["bf16_dp2"] for x in d]
    bl = [x["bf16_logits"] for x in d]
    row_ok = (all(x["returned"] == TP_BATCH for x in b16)
              and all(x["max_abs_err"] <= 0.05 * x["scale"] for x in bl))
    out["bf16_dp2"] = dict(
        ok=row_ok, logits=bl, rows_equal=sum(
            a == b for r, x in enumerate(b16)
            for a, b in zip(x["tokens"], mine(r0["bf16_tp1"]["tokens"], r))),
        rows=TP_BATCH, peak_ratio=[x["peak_bytes"] / r0["bf16_tp1"][
            "peak_bytes"] for x in b16],
        seconds=[x["seconds"] for x in b16])
    ok &= row_ok
    one = res[1]["dp_train_one"]
    two = [x["dp_train"] for x in res]
    rec = lambda x, k: [r[k] for r in x["records"]]
    errs = {k: max(abs(a - b) for a, b in zip(rec(two[0], k), rec(one, k)))
            for k in ("loss", "kl", "ret", "ctx", "turn")}
    sw = rec(two[0], "sw")
    row_ok = (two[0]["records"] == two[1]["records"]
              and all(e <= 1e-5 for e in errs.values())
              and sw == rec(one, "sw") and sw[0] is None
              and sw[1] is not None and sw[1]["from"] == "dp2"
              and sw[1]["to"] == "tp2" and any(rec(one, "loss"))
              and two[0]["params_equal"] is True
              and two[1]["launches"]["flash_dq"]
              == two[0]["launches"]["flash_dq"]
              == one["launches"]["flash_dq"] > 0)
    out["train"] = dict(ok=row_ok, max_abs_err=errs,
                        params_equal=two[0]["params_equal"],
                        losses=rec(two[0], "loss"), switches=sw,
                        seconds={"rank0": two[0]["seconds"],
                                 "rank1": two[1]["seconds"],
                                 "one_rank": one["seconds"]})
    ok &= row_ok
    out["update"], row_ok = update_dp_results(res)
    ok &= row_ok
    out["straddle"], row_ok = straddle_results(res)
    ok &= row_ok
    out["seconds"] = {f"rank{r}": {"dp": x["dp_seconds"],
                                   "train": x["dp_train_seconds"],
                                   "update": x["update_dp_seconds"],
                                   "straddle": x["straddle_seconds"]}
                      for r, x in enumerate(res)}
    return out, ok


def update_dp_results(res):
    """Run (e) (``update_dp``) from both ranks' results: the gates, what
    is reported, and whether every gate held. The dp=2 loss (the ranks'
    shares summed) within 1e-5 of the one-rank run's, relative; both
    ranks' new params bitwise equal; each rank's flash launches equal the
    one-rank run's: dq and dk/dv once a layer (24), the forward once more
    a layer under full remat (the backward runs each layer again). The
    summed bf16 gradients lie, leaf by leaf, no further from the one-rank
    run's than the one-rank run's lie from an f32 evaluation of the same
    weights and rows (bf16's own noise at this width and depth: a missing
    or misscaled sum moves a leaf by half or all of its scale). Reported:
    each leaf's largest error over its largest |g| for the three pairs,
    each run's seconds (the budget is 30 s a rank), each rank's peak bytes
    above the params against the one-rank run's, and the seconds of the
    bitwise comparison (not in the budget)."""
    r0 = res[0]["update_dp"]
    one = r0["one"]
    dp = [x["update_dp"]["dp"] for x in res]
    loss_err = abs(dp[0]["loss"] - one["loss"]) / abs(one["loss"])
    flash = ("flash_fwd", "flash_dq", "flash_dkv")
    launches = {f"rank{r}": {k: x["launches"][k] for k in flash}
                for r, x in enumerate(dp)}
    launches["one_rank"] = {k: one["launches"][k] for k in flash}
    fwd = 24 * (2 if r0["remat"] == "full" else 1)
    errs = r0["grad_abs"]
    within_noise = {k: errs["dp_vs_one"][k] <= errs["one_vs_f32"][k]
                    for k in errs["dp_vs_one"]}
    row_ok = (loss_err <= 1e-5 and all(within_noise.values())
              and all(x["params_equal"] is True for x in dp)
              and dp[0]["loss"] == dp[1]["loss"]
              and all(x == {"flash_fwd": fwd, "flash_dq": 24,
                            "flash_dkv": 24} for x in launches.values()))
    return dict(
        ok=row_ok, batch=TP_BATCH, seq=UPDATE_DP_SEQ, loss=dp[0]["loss"],
        loss_one_rank=one["loss"], loss_rel_err=loss_err,
        grad_err_over_scale=r0["grad_errs"], grad_worst=r0["grad_worst"],
        grads_within_bf16_noise=within_noise,
        params_equal=dp[0]["params_equal"], launches=launches,
        metrics=dp[0]["metrics"], metrics_one_rank=one["metrics"],
        peak_bytes={"rank0": dp[0]["peak_bytes"],
                    "rank1": dp[1]["peak_bytes"],
                    "one_rank": one["peak_bytes"]},
        peak_ratio=[x["peak_bytes"] / one["peak_bytes"] for x in dp],
        seconds={"rank0": dp[0]["seconds"], "rank1": dp[1]["seconds"],
                 "one_rank": one["seconds"]},
        within_budget=all(x["seconds"] <= 30 for x in dp),
        compare_seconds=[x["compare_seconds"] for x in dp]), row_ok


def straddle_results(res):
    """Runs (f) and (g) (``straddle_dp``) from both ranks' results, by run
    (e)'s rule: the dp=2 loss (the ranks' shares summed) and (f)'s
    ``aux_loss`` within 1e-5 of the one-rank run's, relative, and equal on
    both ranks; both ranks' new params bitwise equal; the gradients,
    leaf by leaf, no further from the one-rank run's than the one-rank
    run's lie from an f32 evaluation of the same weights (bf16's own
    noise); each rank's flash launches exact: (f) a dq and a dk/dv a layer
    (the forward once more a layer under full remat), as one rank's; (g)
    the same for each slice a rank holds rows of, two of the three (one
    whole, its part of the middle one), against three on one rank.
    Reported: each leaf's largest error over its largest |g| for the
    three pairs, each run's seconds on each rank (the budget is 30 s a
    rank for both runs), each rank's peak bytes above the params against
    the one-rank run's, the bitwise comparison's seconds, and the card's
    bytes in use by every process (preempt_path's beside the ranks')
    before and after each rank's dp=2 runs."""
    r0 = res[0]["straddle"]
    layers = STRADDLE_LAYERS * (2 if r0["remat"] == "full" else 1)
    want = lambda n: {"flash_fwd": n * layers,
                      "flash_dq": n * STRADDLE_LAYERS,
                      "flash_dkv": n * STRADDLE_LAYERS}
    rel = lambda a, b: abs(a - b) / abs(b)
    out, ok = {}, True
    for name, held, total in (("f", 1, 1), ("g", 2, STRADDLE_MICROBATCH)):
        one = r0[name]["one"]
        dp = [x["straddle"][name]["dp"] for x in res]
        launches = {f"rank{r}": {k: x["launches"][k] for k in want(1)}
                    for r, x in enumerate(dp)}
        launches["one_rank"] = {k: one["launches"][k] for k in want(1)}
        errs = {"loss": rel(dp[0]["loss"], one["loss"])}
        if name == "f":
            errs["aux_loss"] = rel(dp[0]["metrics"]["aux_loss"],
                                   one["metrics"]["aux_loss"])
        g = r0[name]["grad_abs"]
        within_noise = {k: g["dp_vs_one"][k] <= g["one_vs_f32"][k]
                        for k in g["dp_vs_one"]}
        row_ok = (all(e <= 1e-5 for e in errs.values())
                  and all(within_noise.values())
                  and all(x["params_equal"] is True for x in dp)
                  and dp[0]["loss"] == dp[1]["loss"]
                  and launches == {"rank0": want(held), "rank1": want(held),
                                   "one_rank": want(total)})
        out[name] = dict(
            ok=row_ok, rows=STRADDLE_ROWS, seq=UPDATE_DP_SEQ,
            layers=STRADDLE_LAYERS, loss=dp[0]["loss"],
            loss_one_rank=one["loss"], rel_err=errs,
            metrics=dp[0]["metrics"], metrics_one_rank=one["metrics"],
            grad_err_over_scale=r0[name]["grad_errs"],
            grad_worst=r0[name]["grad_worst"],
            grads_within_bf16_noise=within_noise,
            params_equal=dp[0]["params_equal"], launches=launches,
            peak_bytes={"rank0": dp[0]["peak_bytes"],
                        "rank1": dp[1]["peak_bytes"],
                        "one_rank": one["peak_bytes"]},
            peak_ratio=[x["peak_bytes"] / one["peak_bytes"] for x in dp],
            seconds={"rank0": dp[0]["seconds"], "rank1": dp[1]["seconds"],
                     "one_rank": one["seconds"]},
            compare_seconds=[x["compare_seconds"] for x in dp])
        ok &= row_ok
    rank_s = [sum(x["straddle"][n]["dp"]["seconds"]
                  + x["straddle"][n]["dp"]["compare_seconds"]
                  for n in ("f", "g")) for x in res]
    out.update(remat=r0["remat"], rank_seconds=rank_s,
               within_budget=all(t <= 30 for t in rank_s),
               card_used_bytes=[x["straddle"]["card_used_bytes"]
                                for x in res])
    return out, ok


def dp_option_results(torch, res):
    """The dp option runs' part of tp_path (``dp_options``) from both
    ranks' results, against their dp=1 references (``tp_options``' tp=1
    runs of the same configs: (a)'s on rank 1, (b)'s on rank 0): the
    gates, what is reported, and whether every gate held. Rank r holds
    episodes [r n/2, (r+1) n/2) of the dp=1 run's n.

    (a) spec: each rank's tokens its rows of dp=1's, log-probs within
    1e-5; the TP_STATS counters (rounds, proposed and accepted among
    them: every row runs the global round count, and the rows' counters
    are summed) equal dp=1's, with at least one round; every episode
    returned; each rank's spec-verify launches equal dp=1's (one a layer
    a verify round).
    (b) pool_preempt: each rank's tokens its rows of dp=1's, log-probs
    within 2e-4 (int8 pages: a value stored from K/V computed at another
    row count can land a step away, as in tp_dp's (c)); the TP_STATS counters
    (preemptions, growths, peak pages, the global page capacity, no
    dropped write) equal dp=1's, with at least one preemption and one
    growth; every episode returned; each rank's paged-attention launches
    equal dp=1's.
    Both: each rank's own pool holds min(the global pool, what its half
    of the slots can map) pages. Reported: each rank's pool bytes against
    dp=1's, the seconds."""
    from repro_torch.models.paging import pool_pages_needed_shared
    T = torch.tensor
    out, ok = {}, True
    for name, one, n, tol, kernel, ctx, shared, ps in (
            ("spec", res[1]["options"]["spec_tp1"], TP_BATCH, 1e-5,
             "spec_verify", TP_SPEC["max_context"], 0, 16),
            ("pool_preempt", res[0]["options"]["pool_preempt_tp1"],
             TP_EPISODES, 2e-4, "paged_attention", SHARED["max_context"],
             96, SHARED["page_size"])):
        runs = [x["dp_options"][f"{name}_dp2"] for x in res]
        h = n // 2
        mine = lambda rows, r: rows[r * h:(r + 1) * h]
        tokens = all(x["tokens"] == mine(one["tokens"], r)
                     for r, x in enumerate(runs))
        lp = max(float((T(x["logprobs"]) - T(mine(one["logprobs"], r)))
                       .abs().max()) for r, x in enumerate(runs))
        c = one["counters"]
        counters = all(x["counters"] == c and x["returned"] == n
                       for x in runs) and one["returned"] == n
        pressured = (c["spec_rounds"] > 0 if name == "spec" else
                     c["preemptions"] > 0 and c["pool_grows"] > 0
                     and c["kv_dropped_writes"] == 0)
        launches = all(x["launches"][kernel] == one["launches"][kernel] > 0
                       for x in runs)
        full = pool_pages_needed_shared(TP_BATCH // 2, ctx, shared, ps)
        pools = all(x["pool_pages"] == min(c["page_capacity"], full)
                    for x in runs)
        row_ok = (tokens and lp <= tol and counters and pressured
                  and launches and pools)
        out[name] = dict(
            ok=row_ok, tokens_equal=tokens, logprob_max_abs_err=lp,
            logprob_tolerance=tol, counters=c, counters_equal=counters,
            pressured=pressured, launches_equal=launches,
            launches={"dp1": one["launches"], "rank0": runs[0]["launches"],
                      "rank1": runs[1]["launches"]},
            pool_pages={"dp1": one["pool_pages"],
                        "rank0": runs[0]["pool_pages"],
                        "rank1": runs[1]["pool_pages"],
                        "row_full": full, "global": c["page_capacity"]},
            pool_bytes={"dp1": one["pool_bytes"],
                        "rank0": runs[0]["pool_bytes"],
                        "rank1": runs[1]["pool_bytes"]},
            pool_ratio=[x["pool_bytes"] / one["pool_bytes"] for x in runs],
            peak_ratio=[x["peak_bytes"] / one["peak_bytes"] for x in runs],
            seconds={"dp1": one["seconds"], "rank0": runs[0]["seconds"],
                     "rank1": runs[1]["seconds"]})
        ok &= row_ok
    out["seconds"] = [x["dp_options_seconds"] for x in res]
    return out, ok


def tp_family_results(torch, res):
    """The families' part of tp_path from both ranks' results: each
    family's gates and what is reported, and whether every gate held.
    Gates: every episode returned; the fp32 tp=2 tokens equal tp=1's on
    both ranks, the log-probs within 1e-4 and the folded reference's
    within 1e-2; both ranks' launch counts equal and each kernel's equal
    to tp=1's (the tp=2 samples are the partial mode's where the vocab is
    split and the one-launch sampler's where it is replicated, as
    granite's 49,155 rows are), decode attention launched where the
    family has attention and no flash or paged launch in a rollout; the
    bf16 first step's logits within 5% of their scale, with one flash
    forward and one decode attention per attention layer (none for
    mamba2). Where the tp=1 bf16 logits themselves lie further than 5% of
    the scale from the f32 evaluation of the same weights, bf16's own
    rounding noise is above the 5% rule (random zamba2-1.2b at 12 layers:
    16.6% on the H100, and the tp=2 step, whose sums are ordered
    otherwise, 5.6% from tp=1's): the tp=2 logits are then held no further
    from tp=1's than bf16 moves tp=1's from the f32 evaluation."""
    from repro_torch.configs import get_config
    from repro_torch.models import hybrid
    T = lambda d, k: torch.tensor(d[k])
    out, ok = {}, True
    for arch, depth in _tp_families():
        f0, f1 = (x["families"][arch] for x in res)
        cfg = dataclasses.replace(get_config(arch), n_layers=depth)
        attn = (hybrid.n_attn_sites(cfg) if cfg.family == "hybrid"
                else depth if cfg.family == "moe" else 0)
        split = f0["tp"]["vocab_split"]
        a, b, c = f0["fp32_tp1"], f0["fp32_tp2"], f1["fp32_tp2"]
        same = a["tokens"] == b["tokens"] == c["tokens"]
        lp_err, ref_err = (float((T(a, k) - T(b, k)).abs().max())
                           for k in ("logprobs", "ref_logprobs"))
        launches_ok = True
        for kv in ("fp32", "bf16"):
            t1, t2, t2b = (f0[f"{kv}_tp1"]["launches"],
                           f0[f"{kv}_tp2"]["launches"],
                           f1[f"{kv}_tp2"]["launches"])
            unused = "fused_sample" if split else "fused_sample_partial"
            launches_ok &= (
                t2 == t2b
                and t2["decode_attention"] == t1["decode_attention"]
                and (t1["decode_attention"] > 0) == (attn > 0)
                and t2["paged_attention"] == t1["paged_attention"] == 0
                and t2["flash_fwd"] == t1["flash_fwd"] == 0
                and t1["fused_sample_partial"] == 0 and t2[unused] == 0
                and t2["fused_sample"] + t2["fused_sample_partial"]
                == t1["fused_sample"] > 0)
        ll = f0["logits_launches"]
        bl = f0["bf16_logits"]
        tol = 0.05 * bl["scale"]
        noisy = bl["tp1_drift_from_f32"] > tol
        logits_ok = (bl["max_abs_err"] <= tol or noisy and
                     bl["max_abs_err"] <= bl["tp1_drift_from_f32"])
        returned = all(x[f"{kv}_tp2"]["returned"] == TP_BATCH
                       for x in (f0, f1) for kv in ("fp32", "bf16")) and \
            all(f0[f"{kv}_tp1"]["returned"] == TP_BATCH
                for kv in ("fp32", "bf16"))
        fam_ok = (same and lp_err <= 1e-4 and ref_err <= 1e-2 and launches_ok
                  and returned and ll == f1["logits_launches"]
                  and ll["flash_fwd"] == ll["decode_attention"] == attn
                  and logits_ok)
        ok &= fam_ok
        out[arch] = dict(
            n_layers=depth, rank_shapes=f0["tp"], fallbacks=f0["fallbacks"],
            ok=fam_ok, returned_all=returned,
            fp32_tokens_equal=same, fp32_logprob_max_abs_err=lp_err,
            fp32_ref_logprob_max_abs_err=ref_err,
            bf16_logits=dict(bl, tolerance=tol, bf16_noisier_than_tol=noisy,
                             ok=logits_ok),
            bf16_rows_equal=sum(x == y for x, y in zip(
                f0["bf16_tp1"]["tokens"], f0["bf16_tp2"]["tokens"])),
            bf16_rows=TP_BATCH,
            launches={f"rank{r}": {k: v["launches"] for k, v in x.items()
                                   if isinstance(v, dict)
                                   and "launches" in v}
                      for r, x in enumerate((f0, f1))},
            logits_launches=ll,
            peak_bytes={f"rank{r}": {k: v["peak_bytes"] for k, v in x.items()
                                     if isinstance(v, dict)
                                     and "peak_bytes" in v}
                        for r, x in enumerate((f0, f1))},
            peak_ratio_tp2_over_tp1={
                kv: [x[f"{kv}_tp2"]["peak_bytes"]
                     / f0[f"{kv}_tp1"]["peak_bytes"] for x in (f0, f1)]
                for kv in ("fp32", "bf16")},
            param_bytes=f0["param_bytes"],
            carried_bytes=[f0["carried_bytes"], f1["carried_bytes"]],
            kept_bytes=[f0["kept_bytes"], f1["kept_bytes"]],
            kept_ratio=[x["kept_bytes"] / x["param_bytes"] for x in (f0, f1)],
            rollout_seconds={f"rank{r}": {k: v["seconds"] for k, v in
                                          x.items() if isinstance(v, dict)
                                          and "seconds" in v}
                             for r, x in enumerate((f0, f1))},
            worker_seconds=[f0["seconds"], f1["seconds"]])
    return out, ok


def phase_shared_train(torch, model, report):
    """One EarlTrainer step at full width on MultiArmedBandit (prompt_len
    95) with share_prefix=True and int8 pages, B=N=32, max_context 256,
    KL 0.05, clip 0.2, bf16, remat "full". Sharing unfolds the reference
    pass: the trainer warns once and ExpPrep runs its standalone pass (the
    reference params are a copy, so the behaviour log-probs are not
    reused). Expected launches, exactly: one paged attention per layer per
    decode step, all on int8 pools; one fused sample per generated-token
    step; in ExpPrep one flash forward per layer; in the update the flash
    forward twice per layer (forward and remat recompute) and dq and dk/dv
    once; no decode attention."""
    import warnings
    from repro_torch.core.stages import EarlTrainer
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.fused_sample import ops as fs_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.optim.adamw import adamw
    from repro_torch.rl.envs import MultiArmedBandit

    nl = model.cfg.n_layers
    tr = EarlTrainer(model=model, env=MultiArmedBandit(prompt_len=95),
                     optimizer=adamw(3e-4, weight_decay=0.0), batch_size=32,
                     rollout_episodes=32, max_turns=1, max_turn_tokens=32,
                     max_context=256, kl_coef=0.05, clip_eps=0.2,
                     temperature=1.0, seed=0, share_prefix=True,
                     kv_dtype="int8")
    params, opt_state, _ = tr.init_state()
    ref = {k: v.clone() for k, v in params.items()}
    expprep, stage = {}, tr.expprep_stage

    def timed_expprep(exp, **kw):
        torch.cuda.synchronize()
        n0, t0 = fa_ops.launches["fwd"], time.perf_counter()
        out = stage(exp, **kw)
        torch.cuda.synchronize()
        expprep.update(seconds=time.perf_counter() - t0,
                       flash_fwd=fa_ops.launches["fwd"] - n0)
        return out
    tr.expprep_stage = timed_expprep
    counter = PagedCounter()
    for ops in (pa_ops, fs_ops, fa_ops, da_ops):
        ops.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            new, _, rec = tr.run_step(0, params, opt_state, ref)
        torch.cuda.synchronize()
    finally:
        counter.close()
    counts = dict(paged_attention=pa_ops.launches,
                  fused_sample=fs_ops.launches,
                  flash_fwd=fa_ops.launches["fwd"],
                  flash_dq=fa_ops.launches["dq"],
                  flash_dkv=fa_ops.launches["dkv"],
                  decode_attention=da_ops.launches)
    expected = dict(paged_attention=nl * counter.steps,
                    fused_sample=counts["fused_sample"], flash_fwd=3 * nl,
                    flash_dq=nl, flash_dkv=nl, decode_attention=0)
    warned = [str(w.message) for w in caught
              if issubclass(w.category, RuntimeWarning)
              and "share_prefix" in str(w.message)]
    changed = not torch.equal(new["layers.attn.wq"], params["layers.attn.wq"])
    out = dict(phase="shared_train", step=0, ref_folded=tr.ref_folded,
               fallback_warnings=len(warned), shared_len=tr.rollout.shared_len,
               mean_return=rec.mean_return,
               mean_context_len=rec.mean_context_len, loss=rec.loss,
               kl=rec.kl, rollout_s=rec.rollout_wall_s,
               expprep_s=expprep.get("seconds"),
               expprep_flash_fwd=expprep.get("flash_fwd"),
               update_s=rec.update_wall_s, step_s=rec.wall_time_s,
               decode_steps=counter.steps, launches=counts,
               expected_launches=expected,
               all_int8=all(d == "torch.int8"
                            for d in counter.dtypes["paged"]),
               pages_in_use=rec.pages_in_use,
               page_capacity=rec.page_capacity,
               kv_dropped_writes=rec.kv_dropped_writes,
               params_changed=changed,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    emit(out)
    if not (counts == expected and not tr.ref_folded and len(warned) == 1
            and expprep.get("flash_fwd") == nl and out["all_int8"]
            and counter.steps > 0 and counts["fused_sample"] > 0 and changed
            and math.isfinite(rec.loss) and math.isfinite(rec.kl)
            and rec.kv_dropped_writes == 0):
        raise AssertionError(f"shared_train checks failed: {out}")
    report["shared_train_launches"] = counts


SSM = dict(cache_layout="dense", sampling="fused", temperature=1.0,
           max_turns=4, max_turn_tokens=32, max_context=512)
# the depth the ssm phases run mamba2-370m at (of its 48 layers)
SSM_LAYERS = 8


def _ssm_counters():
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.fused_sample import ops as fs_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.spec_verify import ops as sv_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    return dict(fused_sample=fs_ops, ssd_scan=ssd_ops, paged_attention=pa_ops,
                decode_attention=da_ops, spec_verify=sv_ops,
                flash_attention=fa_ops)


def _read_counters(ops_by_name):
    return {k: (sum(o.launches.values()) if isinstance(o.launches, dict)
                else o.launches) for k, o in ops_by_name.items()}


def phase_ssm_path(torch, model, params, report):
    """mamba2-370m at its published widths, SSM_LAYERS = 8 of its 48
    layers (d=1024, 32 SSM heads x 64, state
    128, V=50280, bf16, random weights from a seeded generator) through
    CompiledRolloutEngine on TicTacToe on its recurrent cache
    (cache_layout="dense"), sampling="fused", with the reference stream
    folded in (ref_params = params): B=32 slots, N=64 episodes,
    max_turns 4, max_turn_tokens 32, max_context 512. One warm-up of one
    turn, then one run with every launch counter set to 0 just before it
    and read just after. Gates: every episode returned; exactly one fused
    sampling launch per generated-token step (max_turn_tokens per
    macro-step); no launch of any attention kernel or of the SSD scan (the
    ssm decode is recurrent, as JAX's)."""
    from repro_torch.rl.engine import CompiledRolloutEngine
    from repro_torch.rl.envs import TicTacToe

    gen = torch.Generator(device="cuda").manual_seed(14)
    t0 = time.perf_counter()
    CompiledRolloutEngine(model, TicTacToe(), **dict(SSM, max_turns=1)).run(
        params, 32, 32, generator=gen, ref_params=params)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    engine = CompiledRolloutEngine(model, TicTacToe(), **SSM)
    turns = count_calls(engine, "turn_step")
    ops = _ssm_counters()
    for o in ops.values():
        o.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    exp, st = engine.run(params, 32, 64, generator=gen, ref_params=params)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _read_counters(ops)
    mtt, olen = engine.max_turn_tokens, engine.env.obs_len
    expected = dict.fromkeys(counts, 0)
    expected["fused_sample"] = len(turns) * mtt
    decode_steps = olen + len(turns) * (mtt + olen)
    gen_tokens = int(exp.gen_mask.sum())
    out = dict(phase="ssm_path", seconds=secs, warmup_seconds=warm_s,
               generated_tokens=gen_tokens, tokens_per_s=gen_tokens / secs,
               macro_steps=len(turns), decode_steps=decode_steps,
               decode_steps_per_s=decode_steps / secs, launches=counts,
               expected_launches=expected,
               episodes_started=st.episodes_started,
               episodes_returned=st.episodes_returned,
               mean_context_len=st.mean_context_len,
               mean_turn_len=st.mean_turn_len, mean_return=st.mean_return,
               ref_logprobs_finite=bool(torch.isfinite(exp.ref_logprobs)
                                        .all()),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    emit(out)
    if not (st.episodes_started == st.episodes_returned == 64
            and counts == expected and len(turns) > 0
            and bool(torch.isfinite(exp.logprobs).all())
            and out["ref_logprobs_finite"]
            and bool((exp.ref_logprobs[exp.gen_mask] < 0).all())
            and bool((exp.context_len > 0).all())):
        raise AssertionError(f"ssm_path checks failed: {out}")
    return engine, exp


def phase_ssm_score(torch, model, params, exp, report):
    """ExpPrep's standalone reference pass (ref_folded=False,
    reuse_behavior_lp=False, ref_params = params) over the first 32
    episodes of ssm_path's batch (32 x 512 tokens): the full-sequence
    forward with attn_impl="pallas", the trainer's choice for ssm, with
    every counter set to 0 just before it: exactly one SSD scan per layer,
    12 (SSM_LAYERS), and nothing else. Log-probs are compared at the scored positions
    (1 <= t < context_len; the KL reads the generated ones among them).

    - fp32: the same weights cast to f32, the kernel pass against the
      plain pass ("xla", the chunked form): within 1e-4 absolute, the
      same f32 math in another order through 48 layers.
    - bf16 (the main path): with random weights the 48-layer residual
      stream amplifies bf16 roundings on every route alike, so the bf16
      log-probs are held against their own drift d_X = max |lp_X -
      lp_f32| from the f32 plain pass: the kernel pass no further from it
      than 1.25 d_plain (the kernel adds no error beyond bf16 rounding);
      against the plain pass within 2 d_plain (two evaluations that each
      drift d_plain); against the folded recurrent log-probs at the
      generated positions within d_plain + d_folded.
    Wall time of the pass with the kernel and with the plain form; the
    scan's device time and its share of the kernel pass, from a trace of
    one more pass that caught all 48 scans."""
    from repro_torch.core.stages import ExpPrepStage
    from repro_torch.rl.experience import ExperienceBatch

    batch = ExperienceBatch(*(t[:32] for t in exp))
    kern = ExpPrepStage(model, attn_impl="pallas")
    plain = ExpPrepStage(model, attn_impl="xla")
    ops = _ssm_counters()
    kw = dict(ref_folded=False, reuse_behavior_lp=False)
    kern(batch, ref_params=params, **kw)                  # warm-up
    torch.cuda.synchronize()
    for o in ops.values():
        o.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lp_k = kern(batch, ref_params=params, **kw).ref_logprobs
    torch.cuda.synchronize()
    kern_s = time.perf_counter() - t0
    counts = _read_counters(ops)
    plain(batch, ref_params=params, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lp_x = plain(batch, ref_params=params, **kw).ref_logprobs
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    # the scan's device time within one more kernel pass, against the
    # timed pass's wall time. A trace started just before the pass lost
    # one of the 48 scans in four of six calls: first one such cold trace,
    # reported with where its scans have a hole (the widest gap between
    # consecutive scans against their median gap, or "ends" when the gaps
    # show none). The reading comes from a trace whose profiler ran a
    # warm-up pass first (schedule: warmup 1, active 1); it is taken
    # again, three times at most, if it holds fewer scans than the pass
    # launched, and the share is reported only from one that holds all.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    def scan_spans(prof):
        return sorted((e.time_range.start, e.time_range.end)
                      for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and any(sym in e.name for sym in SSD_SYMBOLS))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        kern(batch, ref_params=params, **kw)
        torch.cuda.synchronize()
    cold = scan_spans(prof)
    gaps = [b_[0] - a[0] for a, b_ in zip(cold, cold[1:])]
    hole = None
    if len(cold) < model.cfg.n_layers and gaps:
        i = max(range(len(gaps)), key=gaps.__getitem__)
        hole = (f"after scan {i}" if gaps[i] > 1.5 * statistics.median(gaps)
                else "ends")
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                kern(batch, ref_params=params, **kw)
                torch.cuda.synchronize()
                prof.step()
        scans = [e - s_ for s_, e in scan_spans(prof)]
        if len(scans) == model.cfg.n_layers:
            break
    scan_ms = sum(scans) / 1e3
    whole = len(scans) == model.cfg.n_layers
    p32 = {k: v.float() for k, v in params.items()}
    lp_k32 = kern(batch, ref_params=p32, **kw).ref_logprobs
    lp_x32 = plain(batch, ref_params=p32, **kw).ref_logprobs
    del p32
    expected = dict.fromkeys(counts, 0)
    expected["ssd_scan"] = model.cfg.n_layers

    idx = torch.arange(batch.seq, device=batch.tokens.device)[None, :]
    fed = (idx >= 1) & (idx < batch.context_len[:, None])
    gen = batch.gen_mask
    dmax = lambda a, b_, m: float((a - b_)[m].abs().max())
    d_plain = dmax(lp_x, lp_x32, fed)
    d_kern = dmax(lp_k, lp_x32, fed)
    d_fold = dmax(batch.ref_logprobs, lp_x32, gen)

    def compare(a, b_, m, tol):
        d = (a - b_)[m].abs()
        return dict(max_abs_dlogprob=float(d.max()),
                    mean_abs_dlogprob=float(d.mean()),
                    logprob_scale=float(b_[m].abs().max()), tolerance=tol,
                    ok=float(d.max()) <= tol
                    and bool(torch.isfinite(a[m]).all()))
    checks = dict(
        fp32_vs_xla=compare(lp_k32, lp_x32, fed, 1e-4),
        bf16_drift_vs_f32=dict(kernel=d_kern, plain=d_plain, folded=d_fold,
                               tolerance=1.25 * d_plain,
                               ok=d_kern <= 1.25 * d_plain),
        bf16_vs_xla=compare(lp_k, lp_x, fed, 2 * d_plain),
        bf16_vs_folded=compare(lp_k, batch.ref_logprobs, gen,
                               d_plain + d_fold))
    out = dict(phase="ssm_score", batch=list(batch.tokens.shape),
               launches=counts, expected_launches=expected,
               kernel_pass_s=kern_s, plain_pass_s=plain_s,
               scan_launches_traced=len(scans), trace_attempts=attempt + 1,
               cold_trace_scans=len(cold), cold_trace_hole=hole,
               scan_device_ms=scan_ms if whole else None,
               scan_share=scan_ms / (kern_s * 1e3) if whole else None,
               scored_positions=int(fed.sum()),
               generated_positions=int(gen.sum()), **checks)
    emit(out)
    if not (counts == expected and all(c["ok"] for c in checks.values())):
        raise AssertionError(f"ssm_score checks failed: {out}")
    report["ssd_scan"]["launches"] = counts["ssd_scan"]


def phase_ssm_sync(torch, engine, params):
    """One ssm macro-step with the folded reference stream under
    set_sync_debug_mode("error"): nothing in it reads the device, so the
    turn's one host read is the run loop's returned counter."""
    noise = engine.default_noise(torch.Generator(device="cuda").manual_seed(
        15))
    carry = engine.init_feed(params, engine.init_carry(32, 64,
                                                       with_ref=True), params)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        carry = engine.turn_step(params, carry, 0, noise, ref_params=params)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    emit({"phase": "ssm_sync", "macro_steps_checked": 1,
          "returned_after_one_turn": int(carry.returned),
          "ref_logprobs_finite": bool(torch.isfinite(carry.ref_logprobs)
                                      .all())})


def phase_ssm_train(torch, model, report):
    """One EarlTrainer step on full-width mamba2-370m: B=N=32,
    max_context 512, KL 0.05, clip 0.2, lr 3e-4, bf16, remat "full". The
    layout resolves to the recurrent cache and the reference pass is folded
    into the rollout (ref_folded true). Expected launches, exactly: one
    fused sample per generated-token step; no attention kernel and no SSD
    scan (the update runs the chunked form under autograd, as JAX's: the
    kernel has no backward)."""
    from repro_torch.core.stages import EarlTrainer
    from repro_torch.optim.adamw import adamw
    from repro_torch.rl.envs import TicTacToe

    tr = EarlTrainer(model=model, env=TicTacToe(),
                     optimizer=adamw(3e-4, weight_decay=0.0), batch_size=32,
                     rollout_episodes=32, max_turns=4, max_turn_tokens=32,
                     max_context=512, kl_coef=0.05, clip_eps=0.2,
                     temperature=1.0, seed=0)
    turns = count_calls(tr.rollout, "turn_step")
    tr.update_stage = _RecordingUpdate(tr.update_stage)
    params, opt_state, ref = tr.init_state()
    ops = _ssm_counters()
    for o in ops.values():
        o.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    new, _, rec = tr.run_step(0, params, opt_state, ref)
    torch.cuda.synchronize()
    counts = _read_counters(ops)
    expected = dict.fromkeys(counts, 0)
    expected["fused_sample"] = len(turns) * tr.max_turn_tokens
    key = "layers.mixer.in_proj"
    changed = not torch.equal(new[key], params[key])
    out = dict(phase="ssm_train", step=0, ref_folded=tr.ref_folded,
               cache_layout=tr.cache_layout, mean_return=rec.mean_return,
               mean_context_len=rec.mean_context_len,
               truncated_frac=rec.truncated_frac, loss=rec.loss, kl=rec.kl,
               rollout_s=rec.rollout_wall_s, update_s=rec.update_wall_s,
               step_s=rec.wall_time_s, macro_steps=len(turns),
               update_tokens=tr.update_stage.batches[-1].tokens.numel(),
               update_tokens_per_s=tr.update_stage.batches[-1].tokens.numel()
               / rec.update_wall_s,
               launches=counts, expected_launches=expected,
               params_changed=changed,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    emit(out)
    if not (tr.ref_folded and tr.cache_layout == "dense"
            and counts == expected and len(turns) > 0 and changed
            and math.isfinite(rec.loss) and math.isfinite(rec.kl)):
        raise AssertionError(f"ssm_train checks failed: {out}")
    report["ssm_train_launches"] = counts


class _RecordingUpdate:
    """Wraps the trainer's UpdateStage to keep the batches it is given and
    the metrics it returns."""

    def __init__(self, stage):
        self.stage, self.batches, self.metrics = stage, [], []

    def __call__(self, params, opt_state, exp, **kw):
        self.batches.append(exp)
        out = self.stage(params, opt_state, exp, **kw)
        self.metrics.append(out[2])
        return out


class _TimedStage:
    """Wraps a trainer stage to keep its wall seconds per call (the card
    synchronized on both sides)."""

    def __init__(self, torch, stage):
        self.torch, self.stage, self.seconds = torch, stage, []

    def __call__(self, *args, **kw):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.stage(*args, **kw)
        self.torch.cuda.synchronize()
        self.seconds.append(time.perf_counter() - t0)
        return out


# the trainer settings of phase_train and phase_async_train
TRAIN = dict(batch_size=32, rollout_episodes=32, max_turns=4,
             max_turn_tokens=32, max_context=256, kl_coef=0.05, clip_eps=0.2,
             temperature=1.0, seed=0)


def train_launch_gate(cfg, obs_len, mtt, counts, rollouts, updates):
    """The launches ``rollouts`` folded rollouts and ``updates`` updates
    make, by phase_train's formula: per layer per decode step (the initial
    feed, then mtt + obs_len steps per macro-step) one paged and one decode
    attention; one fused sample per generated-token step; per update the
    flash forward twice per layer (remat), dq and dk/dv once."""
    nl = cfg.n_layers
    n_macro = counts["fused_sample"] // mtt
    decode = nl * (rollouts * obs_len + n_macro * (mtt + obs_len))
    return dict(paged_attention=decode, fused_sample=n_macro * mtt,
                flash_fwd=updates * 2 * nl, flash_dq=updates * nl,
                flash_dkv=updates * nl, decode_attention=decode)


def train_counters():
    """Sets the counters of the train step's six kernels to 0; returns a
    function that reads them."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.fused_sample import ops as fs_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    for ops in (pa_ops, fs_ops, fa_ops, da_ops):
        ops.reset_launches()
    return lambda: dict(paged_attention=pa_ops.launches,
                        fused_sample=fs_ops.launches,
                        flash_fwd=fa_ops.launches["fwd"],
                        flash_dq=fa_ops.launches["dq"],
                        flash_dkv=fa_ops.launches["dkv"],
                        decode_attention=da_ops.launches)


def one_device_layouts():
    """Destination layouts of an experience batch on a one-device mesh."""
    from repro_torch.core.resharding import MeshConfig, replicated
    from repro_torch.rl.experience import ExperienceBatch
    return ExperienceBatch(*([replicated(MeshConfig("update-1x1", 1, 1))]
                             * len(ExperienceBatch._fields)))


def two_config_selector():
    """A profiled selector of two one-device candidates, "a" and "b";
    "b" wins above 8 tokens of context, so the rollout switches at step 1
    (``tests/test_core_system.py``'s)."""
    from repro_torch.core.parallelism_selector import (ContextBuckets,
                                                       ParallelismSelector,
                                                       ProfileEntry)
    from repro_torch.core.resharding import MeshConfig
    a = MeshConfig("a", dp=1, tp=1)
    b = MeshConfig("b", dp=1, tp=1, fsdp=False)
    sel = ParallelismSelector(
        [a, b], lambda cfg, ctx: ProfileEntry(
            cfg, ctx, tgs=2.0 if (cfg.name == "b") == (ctx > 8) else 1.0,
            feasible=True), ContextBuckets((8,)), ema_alpha=1.0)
    sel.profile()
    return sel


def phase_train(torch, model, report):
    """Two sync steps of EarlTrainer at full width (the training path).
    The trainer folds the reference pass into the rollout, as JAX's does
    whenever reference params are given (also when the reference IS the
    policy). Launches per step, exactly those of ``train_launch_gate``
    for one rollout and one update. Each step's batch goes through the
    data dispatcher to one-device layouts ("direct", nothing moves), and
    a two-candidate selector switches the rollout's config at step 1 and
    re-binds the engine: both are the identity on one card."""
    from repro_torch.core.data_dispatcher import DataDispatcher
    from repro_torch.core.stages import EarlTrainer
    from repro_torch.optim.adamw import adamw
    from repro_torch.rl.envs import TicTacToe

    selector = two_config_selector()
    tr = EarlTrainer(model=model, env=TicTacToe(),
                     optimizer=adamw(3e-4, weight_decay=0.0),
                     selector=selector, dispatcher=DataDispatcher(), **TRAIN)
    dst = one_device_layouts()
    if not tr.ref_folded:
        raise AssertionError("the trainer does not fold the reference pass")
    tr.update_stage = _RecordingUpdate(tr.update_stage)
    params, opt_state, ref = tr.init_state()
    first = {k: ref[k].clone() for k in ("layers.attn.wq", "embedding")}
    mtt = tr.max_turn_tokens
    totals = dict.fromkeys(("paged_attention", "fused_sample", "flash_fwd",
                            "flash_dq", "flash_dkv", "decode_attention"), 0)
    records = []
    for step in range(2):
        read = train_counters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        new, opt_state, rec = tr.run_step(step, params, opt_state, ref,
                                          dst_shardings=dst)
        torch.cuda.synchronize()
        counts = read()
        n_macro = counts["fused_sample"] // mtt
        expected = train_launch_gate(model.cfg, tr.env.obs_len, mtt, counts,
                                     1, 1)
        exp = tr.update_stage.batches[-1]
        changed = not torch.equal(new["layers.attn.wq"],
                                  params["layers.attn.wq"])
        out = dict(phase="train", step=step, ref_folded=tr.ref_folded,
                   mean_return=rec.mean_return,
                   mean_context_len=rec.mean_context_len,
                   truncated_frac=rec.truncated_frac, loss=rec.loss,
                   kl=rec.kl, rollout_s=rec.rollout_wall_s,
                   update_s=rec.update_wall_s, step_s=rec.wall_time_s,
                   update_tokens=exp.tokens.numel(),
                   update_tokens_per_s=exp.tokens.numel()
                   / rec.update_wall_s,
                   launches=counts, expected_launches=expected,
                   kv_dropped_writes=rec.kv_dropped_writes,
                   params_changed=changed, dispatch=rec.dispatch,
                   selector_switch=rec.selector_switch,
                   engine_mesh=tr.rollout.mesh_config.name,
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        emit(out)
        switched = (rec.selector_switch is None if step == 0 else
                    rec.selector_switch is not None
                    and rec.selector_switch["to"] == "b")
        if not (counts == expected and n_macro > 0 and changed
                and math.isfinite(rec.loss) and math.isfinite(rec.kl)
                and rec.kv_dropped_writes == 0
                and rec.dispatch is not None
                and rec.dispatch["strategy"] == "direct"
                and rec.dispatch["moved_bytes"] == 0 and switched
                and tr.rollout.mesh_config == selector.current):
            raise AssertionError(f"train step {step} checks failed: {out}")
        for k_, n in counts.items():
            totals[k_] += n
        records.append({k_: out[k_] for k_ in (
            "mean_return", "mean_context_len", "truncated_frac", "loss",
            "kl", "rollout_s", "update_s", "step_s")})
        params = new
    if not all(torch.equal(ref[k], v) for k, v in first.items()):
        raise AssertionError("the update wrote the aliased reference params")
    for k_ in ("flash_fwd", "flash_dq", "flash_dkv", "decode_attention"):
        report[k_]["launches"] = totals[k_]
    report["train_launches"] = totals
    report["train_records"] = records
    return tr, params, opt_state, tr.update_stage.batches[-1]


# The kernel symbols behind each flash launch counter: bf16 runs the wgmma
# kernels, fp32 the SIMT ones (substrings of the profiler's kernel names).
FLASH_SYMBOLS = {"fwd": ("fa_fwd_wgmma_kernel", "fa_fwd_kernel"),
                 "dq": ("fa_dq_wgmma_kernel", "fa_dq_kernel"),
                 "dkv": ("fa_dkv_wgmma_kernel", "fa_dkv_kernel")}


def phase_train_trace(torch, trainer, params, opt_state, exp):
    """One more update of the train phase's last batch timed on the host
    clock, and the next under torch.profiler: device busy time, idle
    share, the kernels that took the most device time, and the device ms
    of each flash kernel symbol. Every flash counter that launched in the
    profiled update must read > 0 device ms, so a renamed kernel cannot
    drop out of the reading."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.flash_attention import ops as fa_ops
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.update_stage(params, opt_state, exp)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    fa_ops.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.update_stage(params, opt_state, exp)
        torch.cuda.synchronize()
    from torch.autograd import DeviceType
    averages = prof.key_averages()
    busy_ms, n_events, top = device_busy(torch, prof, averages)
    device = [a for a in averages if a.device_type == DeviceType.CUDA]
    flash_ms = {sym: sum(a.self_device_time_total for a in device
                         if sym in a.key) / 1e3
                for syms in FLASH_SYMBOLS.values() for sym in syms}
    emit({"phase": "train_trace", "update_wall_ms": wall_ms,
          "device_busy_ms": busy_ms,
          "device_idle_share": (None if busy_ms is None
                                else 1.0 - busy_ms / wall_ms),
          "device_events": n_events, "flash_device_ms": flash_ms,
          "flash_launches": dict(fa_ops.launches), "top_device_ms": top})
    unread = [c for c, n in fa_ops.launches.items()
              if n > 0 and sum(flash_ms[s] for s in FLASH_SYMBOLS[c]) <= 0]
    if unread:
        raise AssertionError(f"flash kernels {unread} launched in the traced "
                             f"update but read no device time: {flash_ms}")


def phase_train_branch(torch, model, params, opt_state, exp):
    """One update batch through the update step with the kernels
    ("flash") and with plain attention ("xla"): loss and per-leaf
    gradient norms. The two branches differ only in rounding: bf16
    weights; the xla branch rounds its softmax weights to bf16 before P.V
    and runs its backward through bf16 einsums, while the kernels stay
    f32 inside. On an H100 (seed 0) this phase read a loss gap of 1.9e-5,
    a KL gap of 2.7e-4, a worst leaf gradient-norm gap of 0.21 of the
    leaf bound below and a gradient cosine of 0.9976. The tolerances are
    about 10x those readings: the loss within 2e-4 and the KL within 3e-3
    absolute, the gradient cosine at least 0.98; each leaf's gradient
    norm within 5% of itself plus 0.1% of the global norm (about 5x its
    reading; leaves whose exact gradient is 0, like the key bias, hold
    only rounding noise). The kernels themselves are held elementwise in
    the flash phase."""
    from repro_torch.core.train_step import make_rl_train_step
    from repro_torch.optim.adamw import Optimizer, adamw

    res = {}
    for impl in ("flash", "xla"):
        store = {}
        opt = adamw(3e-4, weight_decay=0.0)

        def update(grads, state, p, opt=opt, store=store):
            store["grads"] = grads
            return opt.update(grads, state, p)
        step = make_rl_train_step(model, Optimizer(init=opt.init,
                                                   update=update),
                                  clip_eps=0.2, kl_coef=0.05,
                                  attn_impl=impl)
        _, _, m = step(params, opt_state, exp)
        grads = store["grads"]
        res[impl] = dict(loss=float(m["loss"]), kl=float(m["kl"]),
                         norms={k: float(g.float().norm())
                                for k, g in grads.items()},
                         flat=torch.cat([g.float().flatten()
                                         for g in grads.values()]))
        del grads, store
    f, x = res["flash"], res["xla"]
    loss_tol, kl_tol, min_cos = 2e-4, 3e-3, 0.98
    gn = float(x["flat"].norm())
    worst = max(abs(f["norms"][k] - n) / (0.05 * n + 1e-3 * gn)
                for k, n in x["norms"].items())
    cos = float((f["flat"] @ x["flat"]) / (f["flat"].norm() * gn))
    out = dict(phase="train_branch", loss_flash=f["loss"],
               loss_xla=x["loss"], kl_flash=f["kl"], kl_xla=x["kl"],
               loss_tolerance=loss_tol, kl_tolerance=kl_tol,
               grad_norm_flash=float(f["flat"].norm()), grad_norm_xla=gn,
               worst_leaf_norm_err_over_tol=worst, grad_cosine=cos,
               min_grad_cosine=min_cos)
    emit(out)
    if not (abs(f["loss"] - x["loss"]) <= loss_tol
            and abs(f["kl"] - x["kl"]) <= kl_tol and worst <= 1.0
            and cos >= min_cos):
        raise AssertionError(f"flash and xla update branches disagree: "
                             f"{out}")


def phase_dispatch(torch, exp, report):
    """The dispatcher's other routes on the train phase's last batch, in
    the NCCL world of one: the centralized strategy (gather to the
    controller, the host round trip, scatter) gives every leaf back
    bitwise, on the card, in its dtype; ``all_to_all_resplit`` on the
    one-rank mesh's data axis is the identity; and
    ``distributed_reinforce_advantages`` (one scalar all_reduce) equals
    ``reinforce_advantages`` within 1e-6 of the scale."""
    from repro_torch.core.data_dispatcher import (DataDispatcher,
                                                  all_to_all_resplit)
    from repro_torch.core.resharding import MeshConfig
    from repro_torch.rl.algo import (distributed_reinforce_advantages,
                                     reinforce_advantages)

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    d = DataDispatcher()
    t0 = time.perf_counter()
    out, rep = d.dispatch(exp, one_device_layouts(), strategy="centralized")
    torch.cuda.synchronize()
    round_trip_ms = (time.perf_counter() - t0) * 1e3
    bad = [name for name, a, b in zip(exp._fields, exp, out)
           if not (b.is_cuda and a.dtype == b.dtype and torch.equal(a, b)
                   and a.data_ptr() != b.data_ptr())]
    mesh = MeshConfig("1x1", dp=1, tp=1).make_mesh("cuda")
    resplit = all_to_all_resplit(exp.tokens, mesh, "data", split_dim=1,
                                 concat_dim=0)
    adv_d = distributed_reinforce_advantages(exp.rewards, mesh)
    adv = reinforce_advantages(exp.rewards)
    adv_err = (adv_d - adv).abs().max().item()
    adv_scale = adv.abs().max().item()
    torch.cuda.synchronize()
    res = dict(phase="dispatch", strategy=rep.strategy,
               total_bytes=rep.total_bytes, moved_bytes=rep.moved_bytes,
               round_trip_ms=round_trip_ms,
               report_wall_ms=rep.wall_time_s * 1e3,
               leaves_differ=bad, resplit_equal=torch.equal(resplit,
                                                             exp.tokens),
               adv_max_abs_err=adv_err, adv_scale=adv_scale,
               phase_s=time.perf_counter() - t_phase)
    emit(res)
    if bad or not res["resplit_equal"] or \
            adv_err > 1e-6 * max(adv_scale, 1.0):
        raise AssertionError(f"dispatch phase failed: {res}")
    report["dispatch"] = res


def _union_ms(iv) -> float:
    total, lo, hi = 0, None, None
    for s_, e_ in sorted(iv):
        if hi is None or s_ > hi:
            total += 0 if hi is None else hi - lo
            lo, hi = s_, e_
        else:
            hi = max(hi, e_)
    return (total + (0 if hi is None else hi - lo)) / 1e6


def stream_overlap(torch, prof, wall_ms) -> dict:
    """From a trace's device kernels: the stream each flash kernel and the
    rollout's paged attention ran on (the profiler's stream ids), the
    device-busy share of the wall time, and the ms during which kernels of
    the flash kernels' stream and of the paged kernel's stream ran at the
    same time (busy(a) + busy(b) - busy(a or b))."""
    from torch.autograd import DeviceType
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    by_stream = collections.defaultdict(list)
    for e in evs:
        by_stream[e.device_resource_id()].append(
            (e.start_ns(), e.start_ns() + e.duration_ns()))
    streams = lambda syms: sorted({e.device_resource_id() for e in evs
                                   if any(x in e.name() for x in syms)})
    flash = {c: streams(syms) for c, syms in FLASH_SYMBOLS.items()}
    rollout = streams(PAGED_SYMBOLS)
    side = sorted({s_ for ids in flash.values() for s_ in ids})
    busy = _union_ms([iv for ivs in by_stream.values() for iv in ivs])
    a = [iv for s_ in side for iv in by_stream[s_]]
    b = [iv for s_ in rollout for iv in by_stream[s_]]
    overlap = (_union_ms(a) + _union_ms(b) - _union_ms(a + b)
               if a and b else 0.0)
    return {"flash_streams": flash, "rollout_streams": rollout,
            "flash_off_the_rollout_stream": bool(side) and not (
                set(side) & set(rollout)),
            "device_events": len(evs), "device_busy_ms": busy,
            "device_busy_share": busy / wall_ms,
            "side_stream_busy_ms": _union_ms(a),
            "overlap_ms": overlap}


def phase_async_train(torch, model, train_params, report):
    """The async pipeline at full width, phase_train's trainer settings.
    (a) Lag 0, two steps through train(): the update runs on the
    schedule's side stream, and the records and final params must equal
    phase_train's exactly, with exact launch totals. (b) Lag 1, IS cap
    2.0, three steps with a checkpoint every 2 and an injected update
    fault at step 2 (max_retries 1, no backoff): the worker saves step 2,
    the fault fires once, the pipeline restarts from the checkpoint and
    rolls step 2 out again on the restored version (lags [0, 1, 0]); the
    launch totals count 4 rollouts and 3 updates. (c) The checkpoint read
    back on the card equals the state the worker saved, bitwise. Then one
    traced lag-1 run of two steps at TRACE_LAYERS layers: the stream of
    each flash kernel, the device-busy share and the overlap of side- and
    main-stream kernels (reported, not gated). The checkpoint directory is
    removed whether the phase passes or not."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import latest_step, restore_checkpoint
    from repro_torch.core import scheduler as sched_mod
    from repro_torch.core.stages import EarlTrainer
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import adamw
    from repro_torch.rl.envs import TicTacToe
    from repro_torch.utils.faults import FaultInjector

    cfg, t_phase = model.cfg, time.perf_counter()
    mk = lambda m=model, **kw: EarlTrainer(
        model=m, env=TicTacToe(), optimizer=adamw(3e-4, weight_decay=0.0),
        **TRAIN, **kw)

    # (a) lag 0 through train()
    tr = mk(pipeline="async", max_policy_lag=0)
    read = train_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, _, hist = tr.train(2)
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    counts = read()
    expected = train_launch_gate(cfg, tr.env.obs_len, tr.max_turn_tokens,
                                 counts, 2, 2)
    ref = report["train_records"]
    same_records = all(
        (r.mean_return, r.mean_context_len, r.truncated_frac)
        == (q["mean_return"], q["mean_context_len"], q["truncated_frac"])
        for r, q in zip(hist, ref))
    diff = [k for k in params if not torch.equal(params[k], train_params[k])]
    out = dict(phase="async_train", part="lag0", steps=[r.step for r in hist],
               policy_lag=[r.policy_lag for r in hist],
               loss=[r.loss for r in hist], train_loss=[q["loss"] for q in ref],
               same_records=same_records, params_bitwise=not diff,
               params_differ=diff[:5], launches=counts,
               expected_launches=expected,
               rollout_s=[r.rollout_wall_s for r in hist],
               update_s=[r.update_wall_s for r in hist],
               step_s=[r.wall_time_s for r in hist],
               train_step_s=[q["step_s"] for q in ref], wall_s=wall_a)
    emit(out)
    if not (same_records and not diff and counts == expected
            and counts == report["train_launches"]
            and [r.policy_lag for r in hist] == [0, 0]):
        raise AssertionError(f"async_train lag 0 differs from phase_train: "
                             f"{out}")
    del tr, params, hist

    # (b) lag 1, a checkpoint at step 2 and an update fault at step 2, at
    # FAULT_LAYERS layers (the pipeline's mechanics do not depend on the
    # depth; the full 24 layers took 83 s of the script here)
    ckdir = tempfile.mkdtemp(prefix="earl-ckpt-")
    m_b = build_model(dataclasses.replace(cfg, n_layers=FAULT_LAYERS))
    try:
        faults = FaultInjector.parse(["update@2"])
        tr = mk(m_b, pipeline="async", max_policy_lag=1, is_rho_max=2.0,
                faults=faults)
        dev = tr.device
        sched = sched_mod.PipelineSchedule(
            tr, mode="async", max_policy_lag=1, max_retries=1,
            retry_backoff_s=0.0, checkpoint_dir=ckdir, checkpoint_every=2)
        saved, timing = {}, {}

        def save(done, p, o, rng, _save=sched._maybe_save):
            # in the worker, after the update's host sync: keep what it
            # saves (no tensor is written in place) and time the save
            t1 = time.perf_counter()
            _save(done, p, o, rng)
            if done % 2 == 0:
                timing["save_s"] = time.perf_counter() - t1
                saved.update(tree=sched._ckpt_tree(p, o, rng))

        def restore(step, p, o, _restore=sched._restore):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            got = _restore(step, p, o)
            torch.cuda.synchronize()
            timing["restart_restore_s"] = time.perf_counter() - t1
            return got
        sched._maybe_save, sched._restore = save, restore
        p0, o0, ref0 = tr.init_state()
        read = train_counters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, _, hist = sched.run(3, params=p0, opt_state=o0, ref_params=ref0,
                               dst_shardings=one_device_layouts())
        torch.cuda.synchronize()
        wall_b = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        del p0, o0, ref0
        counts = read()
        expected = train_launch_gate(m_b.cfg, tr.env.obs_len,
                                     tr.max_turn_tokens, counts, 4, 3)
        ck_file = os.path.join(ckdir, "step_00000002", "state.pt")
        isw = [r.is_weight_mean for r in hist]
        out = dict(phase="async_train", part="lag1_fault_restart",
                   n_layers=m_b.cfg.n_layers, steps=[r.step for r in hist],
                   policy_lag=[r.policy_lag for r in hist],
                   params_version=[r.params_version for r in hist],
                   fault_fired=faults.fired("update"),
                   latest_step=latest_step(ckdir),
                   loss=[r.loss for r in hist], kl=[r.kl for r in hist],
                   is_weight_mean=isw,
                   kv_dropped_writes=[r.kv_dropped_writes for r in hist],
                   launches=counts, expected_launches=expected,
                   rollout_s=[r.rollout_wall_s for r in hist],
                   update_s=[r.update_wall_s for r in hist],
                   step_s=[r.wall_time_s for r in hist], wall_s=wall_b,
                   checkpoint_bytes=(os.path.getsize(ck_file)
                                     if os.path.exists(ck_file) else None),
                   dispatch=[r.dispatch and r.dispatch["strategy"]
                             for r in hist],
                   dispatch_ms=[r.dispatch and r.dispatch["wall_time_s"] * 1e3
                                for r in hist],
                   peak_mem_gib=peak, **timing)
        emit(out)
        if not (faults.fired("update") == 1
                and out["dispatch"] == ["direct-async"] * 3
                and [r.step for r in hist] == [0, 1, 2]
                and [r.policy_lag for r in hist] == [0, 1, 0]
                and latest_step(ckdir) == 2 and counts == expected
                and all(math.isfinite(w) and 0 < w <= 2 for w in isw)
                and all(math.isfinite(r.loss) and math.isfinite(r.kl)
                        and r.kv_dropped_writes == 0 for r in hist)):
            raise AssertionError(f"async_train lag 1 with the injected "
                                 f"fault failed its checks: {out}")
        del tr, sched, hist

        # (c) the checkpoint read back on the card
        tree = saved["tree"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = restore_checkpoint(ckdir, 2, tree, map_location=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        mism = [name for name, a, b in (
            ("params/" + k, got["params"][k], tree["params"][k])
            for k in tree["params"])
            if not torch.equal(a, b)]
        for part in ("mu", "nu"):
            mism += [f"{part}/{k}" for k, v in tree["opt_state"][part].items()
                     if not torch.equal(got["opt_state"][part][k], v)]
        mism += [k for k in ("step",) if not torch.equal(
            got["opt_state"][k], tree["opt_state"][k])]
        if not torch.equal(got["rng"], tree["rng"]):
            mism.append("rng")
        out = dict(phase="async_train", part="checkpoint_round_trip",
                   checkpoint_bytes=os.path.getsize(ck_file),
                   save_s=timing.get("save_s"), restore_s=restore_s,
                   mismatched=mism[:5], bitwise=not mism)
        emit(out)
        if mism:
            raise AssertionError(f"async_train: the checkpoint did not read "
                                 f"back bitwise: {out}")
        del got, tree, saved
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)

    # the trace: a lag-1 run of two steps at TRACE_LAYERS layers, the
    # device traced from the start of step 1's rollout, which overlaps
    # update 0, to the end of update 1 (no synchronize at the start: it
    # would wait for update 0)
    from torch.profiler import ProfilerActivity, profile
    m6 = build_model(dataclasses.replace(cfg, n_layers=TRACE_LAYERS))
    tr = mk(m6, pipeline="async", max_policy_lag=1, is_rho_max=2.0)
    p0, o0, ref0 = tr.init_state()
    sched = sched_mod.PipelineSchedule(tr, mode="async", max_policy_lag=1)
    prof, t_start = profile(activities=[ProfilerActivity.CUDA]), []

    def rollout(step, *a, _stage=tr.rollout_stage, **kw):
        if step == 1:
            prof.start()
            t_start.append(time.perf_counter())
        return _stage(step, *a, **kw)
    tr.rollout_stage = rollout
    _, _, hist = sched.run(2, params=p0, opt_state=o0, ref_params=ref0)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t_start[0]) * 1e3
    prof.stop()
    out = dict(phase="async_trace", n_layers=TRACE_LAYERS,
               profiled_wall_ms=wall_ms,
               policy_lag=[r.policy_lag for r in hist],
               rollout_s=[r.rollout_wall_s for r in hist],
               update_s=[r.update_wall_s for r in hist],
               **stream_overlap(torch, prof, wall_ms),
               phase_s=time.perf_counter() - t_phase)
    emit(out)


# ---------------------------------------------------------------------------
# The moe and hybrid families
# ---------------------------------------------------------------------------

def _all_counters():
    """Every launch counter of the port's kernels, by kernel name."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.fused_sample import ops as fs_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.spec_verify import ops as sv_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    for ops in (da_ops, fa_ops, fs_ops, pa_ops, sv_ops, ssd_ops):
        ops.reset_launches()
    return lambda: dict(paged_attention=pa_ops.launches,
                        fused_sample=fs_ops.launches,
                        flash_fwd=fa_ops.launches["fwd"],
                        flash_dq=fa_ops.launches["dq"],
                        flash_dkv=fa_ops.launches["dkv"],
                        decode_attention=da_ops.launches,
                        spec_verify=sv_ops.launches,
                        ssd_scan=ssd_ops.launches)


def _init_model(torch, cfg):
    """``cfg``'s model with random bf16 weights from seed 0, made on the
    card; emits the init line."""
    from repro_torch.models.registry import build_model
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        dtype=torch.bfloat16)
    torch.cuda.synchronize()
    emit({"phase": "init", "arch": cfg.arch_id, "family": cfg.family,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "vocab": cfg.vocab_size,
          "ssm": vars(cfg.ssm) if cfg.ssm is not None else None,
          "params": sum(t.numel() for t in params.values()),
          "param_count": cfg.param_count(), "remat": cfg.remat,
          "seconds": time.perf_counter() - t0})
    return model, params


HYBRID = dict(cache_layout="dense", sampling="fused", temperature=1.0,
              max_turns=2, max_turn_tokens=32, max_context=256)


# the depths hybrid_path and moe_train run at (of 38 and 32): their
# gates are computed from the cut config
HYBRID_LAYERS = 12
MOE_LAYERS = 12


def phase_hybrid_path(torch, report):
    """Full-width zamba2-1.2b (d=2048, 64 SSM heads x 64, state 64, one
    shared attention block of 32 heads x 64 after every 6th layer,
    V=32000, bf16, random weights from a seeded generator) at
    HYBRID_LAYERS of its 38 Mamba2 layers (12: 2 sites) through
    CompiledRolloutEngine on TicTacToe on its own
    cache (cache_layout="dense": the Mamba states and one KV ring per
    site), sampling="fused", the reference stream folded in, B=N=32,
    max_turns 2, max_turn_tokens 32, max_context 256. Every launch counter
    set to 0 just before the run and read just after. Gates: every
    episode returned; decode attention exactly sites x decode steps x 2
    (policy and reference); one fused sample per generated-token step; no
    flash, paged, spec-verify or SSD scan launch (the Mamba layers decode
    recurrently, as JAX's)."""
    from repro_torch.configs import get_config
    from repro_torch.models import hybrid
    from repro_torch.rl.engine import CompiledRolloutEngine
    from repro_torch.rl.envs import TicTacToe

    model, params = _init_model(torch, dataclasses.replace(
        get_config("zamba2-1.2b"), n_layers=HYBRID_LAYERS))
    sites = hybrid.n_attn_sites(model.cfg)
    engine = CompiledRolloutEngine(model, TicTacToe(), **HYBRID)
    turns = count_calls(engine, "turn_step")
    gen = torch.Generator(device="cuda").manual_seed(23)
    read = _all_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    exp, st = engine.run(params, 32, 32, generator=gen, ref_params=params)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read()
    mtt, olen = engine.max_turn_tokens, engine.env.obs_len
    decode_steps = olen + len(turns) * (mtt + olen)
    expected = dict.fromkeys(counts, 0)
    expected["decode_attention"] = 2 * sites * decode_steps
    expected["fused_sample"] = len(turns) * mtt
    gen_tokens = int(exp.gen_mask.sum())
    out = dict(phase="hybrid_path", arch=model.cfg.arch_id,
               attn_sites=sites, attn_impl=engine.attn_impl, seconds=secs,
               generated_tokens=gen_tokens, tokens_per_s=gen_tokens / secs,
               macro_steps=len(turns), decode_steps=decode_steps,
               decode_steps_per_s=decode_steps / secs, launches=counts,
               expected_launches=expected,
               episodes_started=st.episodes_started,
               episodes_returned=st.episodes_returned,
               mean_context_len=st.mean_context_len,
               mean_turn_len=st.mean_turn_len, mean_return=st.mean_return,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    emit(out)
    if not (st.episodes_started == st.episodes_returned == 32
            and counts == expected and len(turns) > 0
            and bool(torch.isfinite(exp.logprobs).all())
            and bool(torch.isfinite(exp.ref_logprobs).all())
            and bool((exp.ref_logprobs[exp.gen_mask] < 0).all())):
        raise AssertionError(f"hybrid_path checks failed: {out}")
    report["hybrid_launches"] = counts
    phase_hybrid_score(torch, model, params, exp, sites)


def phase_hybrid_score(torch, model, params, exp, sites):
    """ExpPrep's standalone reference pass (ref_folded=False) over the
    hybrid_path batch (32 x 257 tokens), with attn_impl="flash", the
    trainer's choice for the hybrid: exactly one flash forward per site
    and nothing else (the Mamba layers take the plain chunked form, as in
    JAX). Log-probs at the scored positions (1 <= t < context_len):

    - fp32 (the weights cast to f32): the flash pass against the plain
      pass ("xla") within 1e-4 absolute, the same f32 math in another
      order through 38 layers;
    - bf16 (the main path): random weights make the residual stream
      amplify bf16 roundings on every route, so the flash pass is held
      against its drift from the f32 plain pass: no further from it than
      1.25 times the bf16 plain pass's own drift d_plain, and within
      d_plain + d_folded of the folded recurrent log-probs at the
      generated positions.
    Wall seconds of the flash and the plain pass."""
    from repro_torch.core.stages import ExpPrepStage

    kern = ExpPrepStage(model, attn_impl="flash")
    plain = ExpPrepStage(model, attn_impl="xla")
    kw = dict(ref_params=params, ref_folded=False, reuse_behavior_lp=False)
    read = _all_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lp_k = kern(exp, **kw).ref_logprobs
    torch.cuda.synchronize()
    kern_s = time.perf_counter() - t0
    counts = read()
    t0 = time.perf_counter()
    lp_x = plain(exp, **kw).ref_logprobs
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    p32 = {k: v.float() for k, v in params.items()}
    kw32 = dict(kw, ref_params=p32)
    lp_k32 = kern(exp, **kw32).ref_logprobs
    lp_x32 = plain(exp, **kw32).ref_logprobs
    del p32
    expected = dict.fromkeys(counts, 0)
    expected["flash_fwd"] = sites
    idx = torch.arange(exp.seq, device=exp.tokens.device)[None, :]
    fed = (idx >= 1) & (idx < exp.context_len[:, None])
    gen = exp.gen_mask
    dmax = lambda a, b_, m: float((a - b_)[m].abs().max())
    d_plain = dmax(lp_x, lp_x32, fed)
    d_kern = dmax(lp_k, lp_x32, fed)
    d_fold = dmax(exp.ref_logprobs, lp_x32, gen)
    checks = dict(
        fp32_vs_xla=dict(max_abs_dlogprob=dmax(lp_k32, lp_x32, fed),
                         tolerance=1e-4,
                         ok=dmax(lp_k32, lp_x32, fed) <= 1e-4),
        bf16_drift_vs_f32=dict(kernel=d_kern, plain=d_plain, folded=d_fold,
                               tolerance=1.25 * d_plain,
                               ok=d_kern <= 1.25 * d_plain),
        bf16_vs_folded=dict(max_abs_dlogprob=dmax(lp_k, exp.ref_logprobs,
                                                  gen),
                            tolerance=d_plain + d_fold,
                            ok=dmax(lp_k, exp.ref_logprobs, gen)
                            <= d_plain + d_fold))
    finite = bool(torch.isfinite(lp_k[fed]).all())
    out = dict(phase="hybrid_score", batch=list(exp.tokens.shape),
               launches=counts, expected_launches=expected,
               flash_pass_s=kern_s, plain_pass_s=plain_s, finite=finite,
               scored_positions=int(fed.sum()), **checks)
    emit(out)
    if not (counts == expected and finite
            and all(c["ok"] for c in checks.values())):
        raise AssertionError(f"hybrid_score checks failed: {out}")


def phase_moe_train(torch, report):
    """One folded sync EarlTrainer step of granite-moe-3b-a800m at its
    published widths (MOE_LAYERS = 12 of its 32 layers, d=1536, 24/8
    heads x 64, 40 experts of
    512 top-8, V=49155, bf16, random weights from seed 0 made on the
    card), at the train phase's settings (TicTacToe, B=N=32, max_turns 4,
    max_turn_tokens 32, max_context 256, KL 0.05, clip 0.2, remat
    "full"). The layout resolves to the dense KV ring; the rollout decodes
    with the drop-free dense MoE and the Update dispatches with capacity
    (one-hot, groups of 512 tokens across rows), as JAX's. Every counter
    set to 0 just before the step and read just after. Gates: every
    episode returned; exactly 2 x 32 decode attentions per decode step
    (policy and folded reference), one fused sample per generated-token
    step, the flash forward twice per layer (remat), dq and dk/dv once;
    nothing else; the aux loss finite and positive, loss and KL finite,
    the params changed. Reports the rollout, ExpPrep and update seconds
    and the peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.core.stages import EarlTrainer
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import adamw
    from repro_torch.rl.envs import TicTacToe

    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m"),
                              n_layers=MOE_LAYERS)
    model = build_model(cfg)
    tr = EarlTrainer(model=model, env=TicTacToe(),
                     optimizer=adamw(3e-4, weight_decay=0.0), **TRAIN)
    turns = count_calls(tr.rollout, "turn_step")
    tr.update_stage = _RecordingUpdate(tr.update_stage)
    tr.expprep_stage = _TimedStage(torch, tr.expprep_stage)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt_state, ref = tr.init_state()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    emit({"phase": "init", "arch": cfg.arch_id, "family": cfg.family,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "vocab": cfg.vocab_size, "moe": vars(cfg.moe),
          "params": sum(t.numel() for t in params.values()),
          "param_count": cfg.param_count(),
          "active_param_count": cfg.active_param_count(),
          "remat": cfg.remat, "seconds": init_s})
    read = _all_counters()
    torch.cuda.synchronize()
    new, opt_state, rec = tr.run_step(0, params, opt_state, ref)
    torch.cuda.synchronize()
    counts = read()
    nl, mtt, olen = cfg.n_layers, tr.max_turn_tokens, tr.env.obs_len
    decode_steps = olen + len(turns) * (mtt + olen)
    expected = dict.fromkeys(counts, 0)
    expected.update(decode_attention=2 * nl * decode_steps,
                    fused_sample=len(turns) * mtt,
                    flash_fwd=(2 if cfg.remat == "full" else 1) * nl,
                    flash_dq=nl, flash_dkv=nl)
    metrics = tr.update_stage.metrics[-1]
    aux = float(metrics["aux_loss"])
    batch = tr.update_stage.batches[-1]
    # the router's gradient holds the aux loss's, whatever the rewards
    changed = not torch.equal(new["layers.moe.router"],
                              params["layers.moe.router"])
    out = dict(phase="moe_train", arch=cfg.arch_id, step=0,
               ref_folded=tr.ref_folded, cache_layout=tr.cache_layout,
               attn_impl=tr.rollout.attn_impl,
               moe_dispatch=cfg.moe_dispatch, mean_return=rec.mean_return,
               mean_context_len=rec.mean_context_len,
               truncated_frac=rec.truncated_frac, loss=rec.loss, kl=rec.kl,
               aux_loss=aux, rollout_s=rec.rollout_wall_s,
               expprep_s=tr.expprep_stage.seconds[-1],
               update_s=rec.update_wall_s, step_s=rec.wall_time_s,
               macro_steps=len(turns), decode_steps=decode_steps,
               update_tokens=batch.tokens.numel(),
               update_tokens_per_s=batch.tokens.numel() / rec.update_wall_s,
               launches=counts, expected_launches=expected,
               episodes_returned=int(batch.tokens.shape[0]),
               params_changed=changed,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    emit(out)
    if not (tr.ref_folded and tr.cache_layout == "dense"
            and counts == expected and len(turns) > 0 and changed
            and batch.tokens.shape[0] == TRAIN["rollout_episodes"]
            and bool((batch.context_len > 0).all())
            and math.isfinite(aux) and aux > 0
            and math.isfinite(rec.loss) and math.isfinite(rec.kl)):
        raise AssertionError(f"moe_train checks failed: {out}")
    report["moe_train_launches"] = counts


AUDIO = dict(batch=16, prompt=64, steps=32, train_tokens=256)


def phase_audio_serve(torch, model, params, report):
    """Full-width whisper-large-v3 served through the stage programs
    (``make_prefill_step``, then ``make_serve_step``): B=16 rows of a
    64-token prompt over 1,500 frames from ``make_extras``, the prefill
    with the flash kernels, then 32 greedy decode steps with the decode
    kernel; then the same with "xla" on the same weights, the first decode
    token teacher-forced to the kernel route's so that both first steps
    see one input. Counters set to 0 just before the prefill and again
    before the decode loop, read after each. Gates: exactly one flash
    forward per decoder layer in the prefill and one decode attention per
    decoder layer per step (the encoder and the cross-attention launch no
    kernel), none on the plain route; the prefill and first-step logits
    finite and within 5% of the plain route's scale (the tolerance the
    branch phases hold bf16 full-width kernel and plain branches to).
    Reports the greedy agreement over the 32 steps (not gated: the random
    model's bf16 logits are near-tied, ROADMAP Queue 3), the prefill
    seconds, ms per decode step, tokens/s, the self and cross cache bytes
    and the peak memory."""
    from repro_torch.core.train_step import make_prefill_step, make_serve_step

    cfg = model.cfg
    B, P, steps = AUDIO["batch"], AUDIO["prompt"], AUDIO["steps"]
    gen = torch.Generator(device="cuda").manual_seed(24)
    extra = model.make_extras(gen, B)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                           device="cuda")
    runs = {}
    first = None
    for route, pre, dec in (("kernel", "flash", "pallas"),
                            ("plain", "xla", "xla")):
        prefill = make_prefill_step(model, attn_impl=pre)
        serve = make_serve_step(model, attn_impl=dec)
        cache = model.init_cache(B, P + steps, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        read = _all_counters()
        t0 = time.perf_counter()
        logits0, cache = prefill(params, prompt, cache, extra)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        pre_counts = read()
        tok = logits0.argmax(-1).to(torch.int32) if first is None else first
        first = tok
        read = _all_counters()
        toks, step1 = [], None
        t0 = time.perf_counter()
        for i in range(steps):
            tok, logits, cache = serve(params, tok, cache, extra)
            toks.append(tok)
            if i == 0:
                step1 = logits.float()
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        runs[route] = dict(
            logits0=logits0.float(), step1=step1, toks=torch.stack(toks, 1),
            pre_counts=pre_counts, dec_counts=read(), prefill_s=prefill_s,
            decode_s=decode_s, pos=cache.pos.tolist(),
            self_cache_bytes=sum(t.numel() * t.element_size()
                                 for t in cache.self_kv[:2]),
            cross_cache_bytes=sum(t.numel() * t.element_size()
                                  for t in cache.cross_kv[:2]),
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        del cache
    k, x = runs["kernel"], runs["plain"]
    zero = dict.fromkeys(k["pre_counts"], 0)
    expected = dict(kernel=(dict(zero, flash_fwd=cfg.n_layers),
                            dict(zero, decode_attention=cfg.n_layers * steps)),
                    plain=(zero, zero))
    checks = {}
    for name in ("logits0", "step1"):
        a, b_ = k[name], x[name]
        tol = 0.05 * float(b_.abs().max())
        err = float((a - b_).abs().max())
        checks[name] = dict(max_abs_err=err, tolerance=tol,
                            ok=bool(torch.isfinite(a).all()) and err <= tol)
    launches_ok = all((runs[r]["pre_counts"], runs[r]["dec_counts"])
                      == expected[r] for r in runs)
    agree = float((k["toks"] == x["toks"]).float().mean())
    out = dict(phase="audio_serve", arch=cfg.arch_id, batch=B, prompt=P,
               frames=cfg.n_audio_frames, decode_steps=steps,
               prefill_s=k["prefill_s"], plain_prefill_s=x["prefill_s"],
               decode_ms_per_step=k["decode_s"] / steps * 1e3,
               plain_decode_ms_per_step=x["decode_s"] / steps * 1e3,
               tokens_per_s=B * steps / k["decode_s"],
               self_cache_bytes=k["self_cache_bytes"],
               cross_cache_bytes=k["cross_cache_bytes"],
               peak_mem_gib=max(k["peak_mem_gib"], x["peak_mem_gib"]),
               launches={r: dict(prefill=runs[r]["pre_counts"],
                                 decode=runs[r]["dec_counts"])
                         for r in runs},
               greedy_agreement=agree, **checks)
    emit(out)
    if not (launches_ok and all(c["ok"] for c in checks.values())
            and k["pos"] == x["pos"] == [P + steps] * B):
        raise AssertionError(f"audio_serve checks failed: {out}")
    report["flash_fwd"]["launches_audio_prefill"] = \
        k["pre_counts"]["flash_fwd"]
    report["decode_attention"]["launches_audio_serve"] = \
        k["dec_counts"]["decode_attention"]


def phase_audio_train(torch, model, params, report):
    """One ``make_lm_train_step`` of full-width whisper-large-v3 with the
    flash kernels, ``remat="full"`` and AdamW: B=16 rows of 256 decoder
    tokens (labels the tokens shifted left, the last masked) over 1,500
    frames, then one ``make_ref_logprob_step`` pass with the frames on the
    same pre-step weights. Counters set to 0 just before each and read
    just after. Gates: exactly two flash forwards per decoder layer in the
    step (forward and remat), one dq and one dk/dv, and one forward per
    layer in the reference pass (the encoder launches none); the loss
    finite and within 1% of the plain ("xla") loss of the same batch and
    weights (a forward under no_grad); the reference pass's mean
    log-prob over the scored positions within 1e-3 of minus the step's
    loss (the same positions through the same kernels); the params moved.
    Reports the step and pass seconds, tokens/s and the peak memory."""
    from repro_torch.core.train_step import (lm_loss, make_lm_train_step,
                                             make_ref_logprob_step)
    from repro_torch.optim.adamw import adamw

    cfg = model.cfg
    B, S = AUDIO["batch"], AUDIO["train_tokens"]
    gen = torch.Generator(device="cuda").manual_seed(25)
    extra = model.make_extras(gen, B)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda")
    labels = torch.roll(tokens, -1, dims=1)
    labels[:, -1] = -1
    opt = adamw(3e-4, weight_decay=0.0)
    step = make_lm_train_step(model, opt, attn_impl="flash")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    opt_state = opt.init(params)
    read = _all_counters()
    t0 = time.perf_counter()
    new, opt_state, metrics = step(params, opt_state, tokens, labels, extra)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    counts = read()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    loss = float(metrics["loss"])
    moved = not torch.equal(new["decoder.self_attn.wq"],
                            params["decoder.self_attn.wq"])
    del new, opt_state
    with torch.no_grad():
        plain_loss = float(lm_loss(model, params, tokens, labels,
                                   extra=extra, attn_impl="xla")[0])
    ref = make_ref_logprob_step(model, attn_impl="flash")
    read = _all_counters()
    t0 = time.perf_counter()
    lp = ref(params, tokens, extra)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    ref_counts = read()
    zero = dict.fromkeys(counts, 0)
    nl = cfg.n_layers
    expected = dict(zero, flash_fwd=2 * nl, flash_dq=nl, flash_dkv=nl)
    ref_mean = float(lp[:, 1:].mean())
    out = dict(phase="audio_train", arch=cfg.arch_id, batch=B, tokens=S,
               frames=cfg.n_audio_frames, remat=cfg.remat, loss=loss,
               plain_loss=plain_loss,
               loss_rel_diff=abs(loss - plain_loss) / abs(plain_loss),
               loss_tolerance=0.01, ref_mean_logprob=ref_mean,
               step_s=step_s, tokens_per_s=B * S / step_s, ref_pass_s=ref_s,
               ref_tokens_per_s=B * S / ref_s, launches=counts,
               expected_launches=expected, ref_launches=ref_counts,
               params_changed=moved, peak_mem_gib=peak)
    emit(out)
    if not (counts == expected
            and ref_counts == dict(zero, flash_fwd=nl)
            and math.isfinite(loss) and moved
            and out["loss_rel_diff"] <= 0.01
            and bool(torch.isfinite(lp).all())
            and abs(ref_mean + loss) <= 1e-3 * abs(loss)):
        raise AssertionError(f"audio_train checks failed: {out}")
    for k_ in ("flash_fwd", "flash_dq", "flash_dkv"):
        report[k_]["launches_audio_train"] = counts[k_]


# ---------------------------------------------------------------------------
# The selector's cost model against the card
# ---------------------------------------------------------------------------

# the path's rows and TicTacToe's 12-token prompt into a cache of the
# path's max_context; the LM update at B=4 x 256 tokens
COST_PREFILL = dict(batch=32, prompt=12, s_max=256)
COST_LM = dict(batch=4, seq=256)
COST_CANDIDATES = (("1", 1, 1), ("dp2", 2, 1), ("tp2", 1, 2))
COST_BUCKETS = (4096, 32768)
COST_REPEATS = 5


def cost_model_steps(torch, model, device):
    """The cost_model phase's two programs, ``{name: (fn, make_args)}``:
    the prefill (flash) of ``COST_PREFILL`` and the LM update step (flash,
    the config's full remat, AdamW) of ``COST_LM``. ``make_args(params,
    zeros)`` builds the inputs on ``device`` around ``params``; ``zeros``
    makes a tensor (``torch.zeros`` on the card, ``torch.empty`` of fakes
    in the trace, where values do not exist). The AdamW state has full f32
    moments, as after a first step."""
    from repro_torch.core.train_step import (make_lm_train_step,
                                             make_prefill_step)
    from repro_torch.optim.adamw import OptState, adamw
    pf, lm = COST_PREFILL, COST_LM

    def prefill_args(params, zeros):
        return (params, zeros((pf["batch"], pf["prompt"]), torch.int32),
                model.init_cache(pf["batch"], pf["s_max"], device=device))

    def lm_args(params, zeros):
        moments = lambda: {k: zeros(p.shape, torch.float32)
                           for k, p in params.items()}
        toks = zeros((lm["batch"], lm["seq"]), torch.int32)
        return (params, OptState(step=zeros((), torch.int32),
                                 mu=moments(), nu=moments()), toks, toks)

    return {"prefill": (make_prefill_step(model, attn_impl="flash"),
                        prefill_args),
            "lm_step": (make_lm_train_step(model, adamw(3e-4),
                                           attn_impl="flash"), lm_args)}


def cost_model_trace(out_path: str) -> int:
    """``chip_smoke.py --cost-model-trace OUT``: in a process of its own,
    with the card hidden, trace the cost_model phase's two programs at full
    width (qwen2-0.5b, bf16) on fake tensors (``utils/cost.full_cost``),
    score them on the H100's roofline, and profile a ParallelismSelector of
    ``COST_CANDIDATES`` x ``COST_BUCKETS`` through
    ``make_cost_model_measure`` (the prefill of the path's 32 rows at each
    bucket's context, on a fake world); writes one JSON object to
    ``out_path``."""
    t0 = time.perf_counter()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.parallelism_selector import (
        ContextBuckets, ParallelismSelector, make_cost_model_measure)
    from repro_torch.core.resharding import MeshConfig
    from repro_torch.launch.dryrun import prefill_stage
    from repro_torch.models.param import abstract_params
    from repro_torch.models.registry import build_model
    from repro_torch.utils import roofline
    from repro_torch.utils.cost import fake_mode, full_cost, trace_device

    model = build_model(get_config("qwen2-0.5b"))
    dev = trace_device()
    out = {"device": dev, "programs": {}}
    for name, (fn, make_args) in cost_model_steps(torch, model,
                                                  dev).items():
        with fake_mode():
            params = abstract_params(model.defs, device=dev)
            args = make_args(params, lambda shape, dt: torch.empty(
                shape, dtype=dt, device=dev))
        t1 = time.perf_counter()
        fc = full_cost(fn, *args)
        rep = roofline.analyze(
            name, chips=1, cost_analysis={"flops": fc.flops,
                                          "bytes accessed": fc.bytes_accessed},
            collective_bytes=fc.collective_bytes, model_flops=0.0,
            peak_memory_bytes=fc.peak_bytes)
        out["programs"][name] = dict(
            flops=fc.flops, bytes=fc.bytes_accessed, peak_bytes=fc.peak_bytes,
            argument_bytes=fc.argument_bytes, kernels=fc.kernels,
            step_time_s=rep.step_time_s, bottleneck=rep.bottleneck,
            trace_s=time.perf_counter() - t1)
    t1 = time.perf_counter()
    batch = COST_PREFILL["batch"]
    sel = ParallelismSelector(
        [MeshConfig(*c) for c in COST_CANDIDATES],
        make_cost_model_measure(prefill_stage(model, batch),
                                hbm_bytes=roofline.H100.hbm_bytes,
                                seq_tokens_fn=lambda ctx: batch * ctx),
        ContextBuckets(COST_BUCKETS))
    pol = sel.profile()
    out["selector"] = dict(
        table={pol.buckets.label(b): c.name for b, c in pol.table.items()},
        entries=[dict(config=e.config.name, context=e.context_len,
                      tgs=e.tgs, feasible=e.feasible,
                      peak_gib=e.peak_bytes / 2 ** 30,
                      step_time_s=e.step_time_s) for e in pol.entries],
        seconds=time.perf_counter() - t1)
    out["seconds"] = time.perf_counter() - t0
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


class CostModelTrace:
    """``cost_model_trace`` in a subprocess started at once (the card
    hidden from it: it needs none), collected by ``result``."""

    def __init__(self):
        import tempfile
        self.tmp = tempfile.mkdtemp()
        self.out = os.path.join(self.tmp, "trace.json")
        self.log = os.path.join(self.tmp, "trace.log")
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        with open(self.log, "w") as f:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--cost-model-trace", self.out], stdout=f,
                stderr=subprocess.STDOUT, env=env)

    def result(self, timeout: float = 600.0) -> dict:
        code = self.proc.wait(timeout=timeout)
        if code != 0:
            raise AssertionError(f"cost_model trace exited {code}:\n"
                                 f"{open(self.log).read()[-4000:]}")
        with open(self.out) as f:
            return json.load(f)

    def stop(self) -> None:
        import shutil
        from repro_torch.kernels._build import kill_tree
        if self.proc.poll() is None:
            kill_tree(self.proc.pid)
            self.proc.wait()
        shutil.rmtree(self.tmp, ignore_errors=True)


def phase_cost_model(torch, model, params, trace: CostModelTrace, report):
    """The roofline of ``utils/roofline`` over ``utils/cost``'s count
    against the card: the prefill and the LM update step of
    ``cost_model_steps`` on full-width qwen2-0.5b (the path's bf16
    weights), each warmed once and timed as a median of five, beside the
    trace of the same programs on fake tensors in ``CostModelTrace``'s
    process. Gates: the predicted step time is at most the measured
    median (a ratio below 1 would mean the count misses work); the
    predicted peak less the arguments lies within 15% of the measured
    bytes above what was allocated before the step; the traced launches
    equal the card's, per kernel. Also prints the policy table the
    subprocess's selector profiled at full width."""
    from repro_torch.utils.cost import measure_step
    t0 = time.perf_counter()
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(31)
    V = model.cfg.vocab_size

    def zeros(shape, dt):
        if dt == torch.int32 and len(shape) == 2:      # token ids
            return torch.randint(0, V, shape, generator=g, device=dev,
                                 dtype=dt)
        return torch.zeros(shape, dtype=dt, device=dev)

    measured = {}
    for name, (fn, make_args) in cost_model_steps(torch, model,
                                                  dev).items():
        args = make_args(params, zeros)
        measured[name] = measure_step(fn, args, _all_counters(),
                                      COST_REPEATS)
        del args
    t_card = time.perf_counter() - t0
    traced = trace.result()
    rows, ok = {}, True
    for name, m in measured.items():
        tr = traced["programs"][name]
        predicted_s, measured_s = tr["step_time_s"], m["ms"] / 1e3
        alloc = tr["peak_bytes"] - tr["argument_bytes"]
        row = dict(
            predicted_s=predicted_s, measured_s=measured_s,
            measured_over_predicted=measured_s / predicted_s,
            bottleneck=tr["bottleneck"], flops=tr["flops"], bytes=tr["bytes"],
            predicted_alloc_bytes=alloc, measured_alloc_bytes=m["peak_bytes"],
            alloc_rel_err=alloc / m["peak_bytes"] - 1.0,
            traced_launches=tr["kernels"], card_launches=m["launches"],
            ms_all=m["ms_all"], trace_s=tr["trace_s"])
        row["ok"] = (predicted_s <= measured_s
                     and abs(row["alloc_rel_err"]) <= 0.15
                     and tr["kernels"] == m["launches"])
        ok &= row["ok"]
        rows[name] = row
        emit({"phase": "cost_model", "program": name, **row})
    emit({"phase": "cost_model", "selector": traced["selector"],
          "trace_process_s": traced["seconds"], "card_s": t_card,
          "phase_s": time.perf_counter() - t0})
    report["cost_model"] = rows
    if not ok:
        raise AssertionError(f"cost_model gates: {rows}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    # full-f32 matmuls wherever results are compared
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    # every nvcc starts now; each kernel phase below waits for its own
    # sources only, so the kernels that are built run while the others
    # compile
    # whatever the script starts is stopped when it ends, passed or failed:
    # the builds still running, the ranks, the cost model's trace
    stops = [_build.stop_all]
    try:
        t_build = time.perf_counter()
        _build.start_all()
        emit({"phase": "build_started", "sources": list(_build.KERNELS)})

        # the tp path's two ranks start now and wait (phase_tp_path): their
        # start-up and weight init hide under the kernel phases, as the cost
        # model's trace (phase_cost_model) does
        tp_workers = TPWorkers()
        stops.append(tp_workers.stop)
        seq_workers = TPWorkers(SEQ_WORLD, "--seq-worker")
        stops.append(seq_workers.stop)
        cost_trace = CostModelTrace()
        stops.append(cost_trace.stop)
        report = {}
        phase_kernels(torch, report)
        phase_decode(torch, report)
        phase_flash(torch, report)
        phase_spec_verify(torch, report)
        phase_ssd(torch, report)
        phase_tp_kernels(torch, report)
        _build.build_all()
        emit({"phase": "build", "seconds": max(_build.build_seconds.values(),
                                               default=0.0),
              "until_all_loaded_s": time.perf_counter() - t_build,
              "per_source_s": dict(_build.build_seconds)})
        model, params = _init_model(torch, get_config("qwen2-0.5b"))
        engine = phase_path(torch, model, params, report)
        dense_engine = phase_dense_path(torch, model, params, report)
        phase_branch(torch, model, params)
        phase_macro_step(torch, engine, dense_engine, params)
        del engine, dense_engine
        # CUT_LAYERS of the 24 layers, as views of the same weights (the full
        # depth took 180-250 s of the script in these phases)
        from repro_torch.models import transformer
        from repro_torch.models.registry import build_model
        cut = build_model(dataclasses.replace(model.cfg, n_layers=CUT_LAYERS))
        cut_params = transformer.draft_params_view(params, CUT_LAYERS)
        spec_engine = phase_spec_path(torch, cut, cut_params, report)
        phase_spec_branch(torch, cut, cut_params)
        phase_spec_sync(torch, spec_engine, cut_params)
        del spec_engine
        phase_shared_path(torch, cut, cut_params, report)
        phase_shared_spec(torch, cut, cut_params, report)
        del cut_params
        # after the path phases, whose peak_mem_gib is the peak since the
        # process started: this phase resets the peak before each step
        phase_cost_model(torch, model, params, cost_trace, report)
        # tp_path's ranks run beside preempt_path: both are host-bound (the
        # eager loop, gloo's staging), each process keeps its own cores,
        # and the card holds both; preempt_path's gates are not timed
        tp_workers.go()
        # seq_path's four ranks go once tp_path's have exited, beside the
        # rest of preempt_path
        seq_workers.go_after(tp_workers)
        phase_preempt_path(torch, model, params, report)
        del params
        phase_tp_path(torch, report, tp_workers)
        phase_seq_path(torch, report, seq_workers)
        # the dispatcher's and the selector's distributed code runs in a
        # process group of one rank (NCCL allows one rank per card)
        import torch.distributed as dist
        t0 = time.perf_counter()
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1)
        emit({"phase": "process_group", "backend": dist.get_backend(),
              "world_size": dist.get_world_size(),
              "seconds": time.perf_counter() - t0})
        try:
            trainer, params, opt_state, exp = phase_train(torch, model, report)
            phase_dispatch(torch, exp, report)
            phase_train_trace(torch, trainer, params, opt_state, exp)
            phase_train_branch(torch, model, params, opt_state, exp)
            del trainer, opt_state, exp
            phase_async_train(torch, model, params, report)
            del params
        finally:
            dist.destroy_process_group()
        phase_spec_train(torch, cut, report)
        phase_shared_train(torch, cut, report)
        del model, cut

        # mamba2-370m at SSM_LAYERS of its 48 layers (the full depth took
        # 116 s of the script in its four phases, 24 layers 67 s on a slow
        # host)
        model, params = _init_model(torch, dataclasses.replace(
            get_config("mamba2-370m"), n_layers=SSM_LAYERS))
        ssm_engine, ssm_exp = phase_ssm_path(torch, model, params, report)
        phase_ssm_score(torch, model, params, ssm_exp, report)
        phase_ssm_sync(torch, ssm_engine, params)
        del ssm_engine, ssm_exp, params
        phase_ssm_train(torch, model, report)
        del model

        phase_hybrid_path(torch, report)
        phase_moe_train(torch, report)

        # full-width, full-depth whisper-large-v3 (32 encoder and 32 decoder
        # layers, d=1280, 20/20 heads x 64, V=51866, 1,500 frames)
        model, params = _init_model(torch, get_config("whisper-large-v3"))
        phase_audio_serve(torch, model, params, report)
        phase_audio_train(torch, model, params, report)
        del model, params

        kernels = []
        for name, src, replaces in (
                ("paged_attention", "src/repro_torch/csrc/paged_attention.cu",
                 "src/repro/kernels/paged_attention/kernel.py:33"),
                ("fused_sample", "src/repro_torch/csrc/fused_sample.cu",
                 "src/repro/kernels/fused_sample/kernel.py:34"),
                ("fused_sample_partial",
                 "src/repro_torch/csrc/fused_sample.cu",
                 "src/repro/kernels/fused_sample/kernel.py:34"),
                ("flash_fwd", "src/repro_torch/csrc/flash_fwd.cuh",
                 "src/repro/kernels/flash_attention/kernel.py:28"),
                ("flash_dq", "src/repro_torch/csrc/flash_bwd.cuh",
                 "src/repro/kernels/flash_attention/bwd_kernel.py:39"),
                ("flash_dkv", "src/repro_torch/csrc/flash_bwd.cuh",
                 "src/repro/kernels/flash_attention/bwd_kernel.py:63"),
                ("decode_attention",
                 "src/repro_torch/csrc/decode_attention.cu",
                 "src/repro/kernels/decode_attention/kernel.py:28"),
                ("spec_verify", "src/repro_torch/csrc/spec_verify.cuh",
                 "src/repro/kernels/spec_verify/kernel.py:44"),
                ("ssd_scan", "src/repro_torch/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan/kernel.py:31")):
            r = report[name]
            extra = {k: v for k, v in r.items() if k.startswith("launches_")}
            kernels.append({
                "name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": r["launches"],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
                "cases": {c: {k: v[k] for k in ("max_abs_err", "atol", "rtol",
                                                "err_over_tol", "ms")}
                          for c, v in r["cases"].items()}, **extra})
        emit({"kernels": kernels})
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
    finally:
        for stop in reversed(stops):
            stop()
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tp-worker"]:
        sys.exit(tp_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                           sys.argv[5]))
    if sys.argv[1:2] == ["--seq-worker"]:
        sys.exit(seq_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                            sys.argv[5]))
    if sys.argv[1:2] == ["--cost-model-trace"]:
        sys.exit(cost_model_trace(sys.argv[2]))
    sys.exit(main())
