#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and ``nvcc``.
Phases, in order; any failure raises and exits non-zero:

  1. device  — refuse to run without CUDA; print the card's name and power
               limit as nvidia-smi reports them.
  2. build   — compile every kernel under src/repro_torch/csrc/ with nvcc
               (one process per source, in parallel).
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
               of P / dS would give in place of the kernels' split.
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
 12. spec_path — the engine with speculation="self" (spec_k 4, 12 draft
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
 17. shared_spec — the same with speculation="self" (spec_k 4, 12 draft
               layers), 32 episodes: one int8 spec-verify launch per layer
               per verify round; greedy tokens bitwise equal to the
               non-speculative shared int8 run, and every committed token
               of both the greedy choice of a teacher-forced plain forward.
 18. preempt_path — TicTacToe under on_exhaust="preempt" at the path's
               sizes (B=32, 64 episodes, 16-token pages, turns of 32
               tokens), greedy, int8, admit_watermark 64: preemptions in a
               pool of half the unpressured peak with trajectories bitwise
               equal to the unpressured run; the minimum-pool ValueError;
               pool_growth="double" from the minimum pool.
 19. shared_train — one EarlTrainer step on the bandit with sharing and
               int8 pages: the fallback warning once, ExpPrep's standalone
               pass (one flash forward per layer), exact launch counts.
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
               episodes (32 x 512 tokens): exactly 48 SSD scan launches,
               its log-probs against the plain pass and against the folded
               recurrent ones; kernel and plain wall time, and the scan's
               device time in a traced kernel pass (after a profiler
               warm-up pass) and its share of the pass's wall time.
 22. ssm_sync — one ssm macro-step with the reference stream under
               set_sync_debug_mode("error").
 23. ssm_train — one EarlTrainer step on mamba2 (B=N=32, max_context 512,
               KL 0.05, clip 0.2, remat "full"): reference folded, exact
               launch counts (the update runs the plain chunked form).

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
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_FLOPS = 67e12             # H100 SXM, f32 outside the tensor cores
BF16_FLOPS = 989e12           # H100 SXM, bf16 dense tensor cores
N_TIMED = 50
T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; phase lines carry ``t_s``, the seconds since the
    script started, so the time each phase takes can be read off."""
    if "phase" in obj:
        obj = dict(obj, t_s=time.perf_counter() - T_START)
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, flops: float, peak: float = F32_FLOPS):
    """Least ms for the work: bytes over HBM bandwidth or operations over
    the peak rate of the inputs' type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


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
    which the spins separate by about half a millisecond. The trace must
    hold exactly ``n`` calls; one that lost kernel events (the card's
    tracer has dropped a few on an H100) is taken again, three times at
    most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                flush.zero_()
                torch.cuda._sleep(1_000_000)
                fn()
            torch.cuda.synchronize()
        evs = sorted(((e.time_range.start, e.time_range.end, e.name)
                      for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and any(sym in e.name for sym in symbols)))
        calls = []
        for ev in evs:
            if not calls or ev[0] - calls[-1][-1][1] > 100.0:
                calls.append([])
            calls[-1].append(ev)
        if len(calls) == n:
            break
    if len(calls) != n:
        raise AssertionError(f"kernel_profile: {len(calls)} calls of "
                             f"{symbols} in the trace, expected {n}")
    med = statistics.median
    per_sym = {sym: med(sum(e - s0 for s0, e, nm in c if sym in nm)
                        for c in calls) for sym in symbols}
    span = med(c[-1][1] - c[0][0] for c in calls)
    return dict(launches_per_call=med(len(c) for c in calls),
                device_us=per_sym, span_us=span,
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
        esz = kp.element_size()
        nbytes = (2 * n_valid * KV * hd * esz
                  + (2 * n_valid * KV * 4 if ks is not None else 0)
                  + 2 * q.numel() * q.element_size() + bt.numel() * 4 + B * 4)
        flops = 4 * n_valid * (H // KV) * KV * hd
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS
                           if q.dtype == torch.bfloat16 else F32_FLOPS)
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
        b_ms, b_by = bound(2 * B * V * 4 + B * 8, 4 * B * V)
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
    b_ms, b_by = bound(2 * B * V2 * 4 + B * 8, 4 * B * V2)
    cases["gumbel_v50280"] = dict(
        chk, tokens_equal=True,
        plan=fs_ops.cluster_plan(B, V2, _build.sm_count(0)),
        ms=time_cold(torch, lambda: fs_ops.fused_sample(lg2, gum2)),
        plain_ms=time_cold(torch, lambda: fused_sample_ref(lg2, gum2)),
        bound_ms=b_ms, bound_by=b_by)
    emit({"phase": "kernels", "kernel": "fused_sample",
          "case": "gumbel_v50280", **cases["gumbel_v50280"]})
    # the engine samples at temperature 1.0 from aligned logits
    report["fused_sample"] = dict(cases["gumbel"], cases=cases)


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
    cores' balance. Each is held against ``ref.py`` and timed beside its
    bound, the plain version and torch's scaled_dot_product_attention
    (forward, or its autograd backward, which computes dq, dk and dv in
    one call). At the update's bf16 shape every case also reports the
    error one bf16 rounding of its f32 A operands would give
    (``one_rounding_errors``)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_fwd_ref)

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(5)
    H, KV, hd = 14, 2, 64
    cases = {"flash_fwd": {}, "flash_dq": {}, "flash_dkv": {}}
    # Tolerances at each output's own scale s = max|ref|: O and L within
    # 32 f32 ulps of s (atol 2^-18 s), as for paged attention; gradients
    # within 2^-14 s, because each sums up to 7 x S products of terms
    # that cancel in dS = P(dP - D). bf16 outputs add one bf16 ulp of
    # each element (rtol 2^-7).
    for name, B, S, dt, peak, rtol in (
            ("bf16", 32, 256, torch.bfloat16, BF16_FLOPS, 2.0 ** -7),
            ("fp32", 32, 256, torch.float32, F32_FLOPS, 0.0),
            ("bf16_s2048", 4, 2048, torch.bfloat16, BF16_FLOPS, 2.0 ** -7)):
        pairs = B * H * S * (S + 1) // 2        # causal (query, key) pairs
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
        e = q.element_size()
        qb, kvb, lb = B * S * H * hd * e, B * S * KV * hd * e, B * H * S * 4
        work = {"flash_fwd": (2 * qb + 2 * kvb + lb, 4 * hd * pairs),
                "flash_dq": (3 * qb + 2 * kvb + 2 * lb, 6 * hd * pairs),
                "flash_dkv": (2 * qb + 4 * kvb + 2 * lb, 8 * hd * pairs)}
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
            case = dict(B=B, S=S, max_abs_err=max(c["max_abs_err"]
                                                  for c in chk),
                        atol=[c["atol"] for c in chk], rtol=rtol,
                        err_over_tol=max(c["err_over_tol"] for c in chk))
            if kname in one_rounding:
                case["one_rounding_err_over_tol"] = one_rounding[kname]
            if not ok:
                raise AssertionError(f"{kname} {name}: {case}")
            kern, plain, lib = times[kname]
            b_ms, b_by = bound(*work[kname], peak)
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
            case.update(bound_ms=b_ms, bound_by=b_by, bytes=work[kname][0],
                        flops=work[kname][1])
            cases[kname][name] = case
            emit({"phase": "kernels", "kernel": kname, "case": name, **case})
        del out_r, L_r, dq_r, dk_r, dv_r, o_lib
    for kname, by_case in cases.items():
        report[kname] = dict(by_case["bf16"], cases=by_case)


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
            esz = kp.element_size()
            nbytes = (2 * live * KV * hd * esz
                      + (2 * live * KV * 4 if ks is not None else 0)
                      + 2 * q.numel() * q.element_size() + bt.numel() * 4
                      + B * 4)
            b_ms, b_by = bound(nbytes, 4 * hd * pairs, BF16_FLOPS
                               if qdt == torch.bfloat16 else F32_FLOPS)
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
    four masks, and in bf16 at S=2048 under a random fill. Each case is
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
    def run_case(name, q, k, v, valid, peak, rtol):
        out = da_ops.decode_attention(q, k, v, valid)
        ref = decode_attention_ref(q, k, v, valid)
        torch.cuda.synchronize()
        chk = held(torch, out, ref,
                   2.0 ** -18 * float(ref.float().abs().max()), rtol)
        if not chk["ok"]:
            raise AssertionError(f"decode_attention {name}: {chk}")
        # The least work: K and V of each row's valid keys (a row with no
        # valid key needs only all of V, for its mean), q, the output and
        # the mask; 4 hd flops per valid (query head, key) pair, and one
        # add per V element of a row with no valid key.
        Bq, Sk = valid.shape
        _, _, kvh, d = k.shape
        n_valid = valid.sum(1)
        n_keys, n_empty = int(n_valid.sum()), int((n_valid == 0).sum())
        nbytes = ((2 * n_keys + n_empty * Sk) * kvh * d * k.element_size()
                  + 2 * q.numel() * q.element_size() + Bq * Sk)
        flops = 4 * q.shape[1] * d * n_keys + n_empty * Sk * kvh * d
        b_ms, b_by = bound(nbytes, flops, peak)
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

    for dname, dt, peak, rtol in (("bf16", torch.bfloat16, BF16_FLOPS,
                                   2.0 ** -7),
                                  ("fp32", torch.float32, F32_FLOPS, 0.0)):
        q = torch.randn((B, H, hd), generator=g, device=dev).to(dt)
        k, v = (torch.randn((B, S, KV, hd), generator=g, device=dev).to(dt)
                for _ in range(2))
        for mname, valid in masks.items():
            run_case(f"{dname}_{mname}", q, k, v, valid.contiguous(), peak,
                     rtol)
    # a long context, S=2048 in bf16 under a random fill, where each block
    # walks eight tiles
    S = 2048
    fill = torch.randint(1, S, (B, 1), generator=g, device=dev)
    q = torch.randn((B, H, hd), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((B, S, KV, hd), generator=g, device=dev).bfloat16()
            for _ in range(2))
    run_case("bf16_fill_s2048", q, k, v,
             (torch.arange(S, device=dev)[None, :] <= fill).contiguous(),
             BF16_FLOPS, 2.0 ** -7)
    # the main path: the bf16 reference stream over a filling cache
    report["decode_attention"] = dict(cases["bf16_fill"], cases=cases)


def ssd_work(b, s, h, g, p, n, q, esz):
    """(bytes, flops) of one SSD scan: x and y, dt, A, B and C each read
    or written once, and the final f32 state (dA is the wrapper's dt * A,
    not an input); per (row, group, chunk) of L real positions the causal
    half of the Gram C B^T (2 L(L+1)/2 n), formed once since B and C are
    per group; per (row, head, chunk) W x over the same pairs (2 L(L+1)/2
    p) and the state update (2 L p n), and the carried-state term (2 L p
    n) in every chunk but the first, which starts from zero state."""
    nbytes = (2 * b * s * h * p * esz + b * s * h * 4 + h * 4
              + 2 * b * s * g * n * esz + b * h * p * n * 4)
    gram = per_head = 0
    for c0 in range(0, s, q):
        L = min(q, s - c0)
        pairs = L * (L + 1) // 2
        gram += 2 * pairs * n
        per_head += 2 * pairs * p + (4 if c0 else 2) * L * p * n
    return nbytes, b * (g * gram + h * per_head)


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
            peak = BF16_FLOPS if bf else F32_FLOPS
            nbytes, flops = ssd_work(b, s, h, gg, p, n, q, x.element_size())
            b_ms, b_by = bound(nbytes, flops, peak)
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
                f32_fma_floor_ms=flops / F32_FLOPS * 1e3,
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
    per decode step of the reference stream)."""
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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


SPEC = dict(cache_layout="paged", attn_impl="paged", sampling="reference",
            speculation="self", spec_k=4, draft_layers=12, max_turns=4,
            max_turn_tokens=32, max_context=256, page_size=16)


def phase_spec_path(torch, model, params, report):
    """Full-width qwen2-0.5b through the engine with speculation="self"
    (spec_k 4, draft_layers 12, JAX's default of n_layers // 2) on the
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
    """One EarlTrainer step at full width with speculation="self" (spec_k
    4, draft_layers 12) on the train phase's other settings (B=N=32,
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
                     draft_layers=12)
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
                           draft_layers=12, **kw)
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
    """Full-width mamba2-370m (48 layers, d=1024, 32 SSM heads x 64, state
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
    48, and nothing else. Log-probs are compared at the scored positions
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
    """Wraps the trainer's UpdateStage to keep the batches it is given."""

    def __init__(self, stage):
        self.stage, self.batches = stage, []

    def __call__(self, params, opt_state, exp):
        self.batches.append(exp)
        return self.stage(params, opt_state, exp)


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

    # (b) lag 1, a checkpoint at step 2 and an update fault at step 2
    ckdir = tempfile.mkdtemp(prefix="earl-ckpt-")
    try:
        faults = FaultInjector.parse(["update@2"])
        tr = mk(pipeline="async", max_policy_lag=1, is_rho_max=2.0,
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
        expected = train_launch_gate(cfg, tr.env.obs_len, tr.max_turn_tokens,
                                     counts, 4, 3)
        ck_file = os.path.join(ckdir, "step_00000002", "state.pt")
        isw = [r.is_weight_mean for r in hist]
        out = dict(phase="async_train", part="lag1_fault_restart",
                   steps=[r.step for r in hist],
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
def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.registry import build_model

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

    emit({"phase": "build", "seconds": _build.build_all()})

    report = {}
    phase_kernels(torch, report)
    phase_flash(torch, report)
    phase_decode(torch, report)
    phase_spec_verify(torch, report)
    phase_ssd(torch, report)
    cfg = get_config("qwen2-0.5b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        dtype=torch.bfloat16)
    torch.cuda.synchronize()
    emit({"phase": "init", "arch": cfg.arch_id, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "vocab": cfg.vocab_size,
          "params": sum(t.numel() for t in params.values()),
          "remat": cfg.remat, "seconds": time.perf_counter() - t0})
    engine = phase_path(torch, model, params, report)
    dense_engine = phase_dense_path(torch, model, params, report)
    phase_branch(torch, model, params)
    phase_macro_step(torch, engine, dense_engine, params)
    del engine, dense_engine
    spec_engine = phase_spec_path(torch, model, params, report)
    phase_spec_branch(torch, model, params)
    phase_spec_sync(torch, spec_engine, params)
    del spec_engine
    phase_shared_path(torch, model, params, report)
    phase_shared_spec(torch, model, params, report)
    phase_preempt_path(torch, model, params, report)
    del params
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
    phase_spec_train(torch, model, report)
    phase_shared_train(torch, model, report)
    del model

    cfg = get_config("mamba2-370m")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        dtype=torch.bfloat16)
    torch.cuda.synchronize()
    emit({"phase": "init", "arch": cfg.arch_id, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "vocab": cfg.vocab_size,
          "ssm": vars(cfg.ssm),
          "params": sum(t.numel() for t in params.values()),
          "remat": cfg.remat, "seconds": time.perf_counter() - t0})
    ssm_engine, ssm_exp = phase_ssm_path(torch, model, params, report)
    phase_ssm_score(torch, model, params, ssm_exp, report)
    phase_ssm_sync(torch, ssm_engine, params)
    del ssm_engine, ssm_exp, params
    phase_ssm_train(torch, model, report)

    kernels = []
    for name, src, replaces in (
            ("paged_attention", "src/repro_torch/csrc/paged_attention.cu",
             "src/repro/kernels/paged_attention/kernel.py:33"),
            ("fused_sample", "src/repro_torch/csrc/fused_sample.cu",
             "src/repro/kernels/fused_sample/kernel.py:34"),
            ("flash_fwd", "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:28"),
            ("flash_dq", "src/repro_torch/csrc/flash_attention_bwd.cu",
             "src/repro/kernels/flash_attention/bwd_kernel.py:39"),
            ("flash_dkv", "src/repro_torch/csrc/flash_attention_bwd.cu",
             "src/repro/kernels/flash_attention/bwd_kernel.py:63"),
            ("decode_attention", "src/repro_torch/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention/kernel.py:28"),
            ("spec_verify", "src/repro_torch/csrc/spec_verify.cu",
             "src/repro/kernels/spec_verify/kernel.py:44"),
            ("ssd_scan", "src/repro_torch/csrc/ssd_scan.cu",
             "src/repro/kernels/ssd_scan/kernel.py:31")):
        r = report[name]
        extra = ({"launches_int8": r["launches_int8"]}
                 if "launches_int8" in r else {})
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
