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
  4. path    — full-width qwen2-0.5b (24 layers, d=896, 14/2 heads,
               V=151936, bf16, random weights from a seeded generator)
               driven through CompiledRolloutEngine on TicTacToe with
               attn_impl="paged", sampling="fused": one warm-up run, then
               one timed run with every launch counter set to 0 just
               before it and read just after.
  5. branch  — one token stream teacher-forced through decode_step with
               the kernel (attn_impl="paged") and with the gather path
               ("xla") from the same empty cache; logits compared.
  6. sync    — one macro-step under torch.cuda.set_sync_debug_mode("error").
  7. trace   — one macro-step timed on the host clock, and the next under
               torch.profiler: device busy time and idle share.

Prints JSON lines; the line before the last lists every kernel, and the
last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_FLOPS = 67e12             # H100 SXM, f32 outside the tensor cores
N_TIMED = 50


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def time_cold(torch, fn, n: int = N_TIMED) -> float:
    """Median ms of ``n`` single calls, each after a 256 MiB write that
    evicts the 50 MB L2."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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
    from repro_torch.kernels.fused_sample import ops as fs_ops
    from repro_torch.kernels.fused_sample.ref import fused_sample_ref
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention.ref import (
        paged_decode_attention_ref)

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(1)
    # --- paged attention at the rollout's shapes: B=32 slots, qwen2-0.5b
    #     heads (14 q / 2 kv, hd 64), page 16, 256-token context (NP=16),
    #     full provisioning (512 pages + the trash page)
    B, H, KV, hd, ps, NP = 32, 14, 2, 64, 16, 16
    P = B * NP + 1
    lens = torch.randint(1, NP * ps + 1, (B,), generator=g, device=dev)
    lens[0] = 0                      # a row with nothing to attend to
    lens[1] = 3 * ps + 5             # a partially filled last page
    lens = lens.to(torch.int32)
    perm = torch.randperm(P - 1, generator=g, device=dev)[:B * NP]
    bt = perm.reshape(B, NP).to(torch.int32)
    npages = (lens + ps - 1) // ps
    bt = torch.where(torch.arange(NP, device=dev)[None, :] < npages[:, None],
                     bt, -1)
    bt[2, 1] = -1                    # an unmapped entry inside a live range
    bt = bt.contiguous()
    valid = ((torch.arange(NP * ps, device=dev)[None, :] < lens[:, None])
             & (bt >= 0)[:, :, None].expand(B, NP, ps).reshape(B, NP * ps))
    n_valid = int(valid.sum())
    cases = {}
    # Tolerances at each case's own output scale s = max|ref|. Kernel and
    # plain version do the same f32 math in another order: f32 output
    # within 32 f32 ulps of s (atol 2^-18 s). A bf16 output is that f32
    # result rounded once, and two nearby f32 values may round to adjacent
    # bf16 values: one bf16 ulp of each element (rtol 2^-7) on top.
    for name, qdt, kvdt, rtol in (("fp32", torch.float32, torch.float32, 0.0),
                                  ("bf16", torch.bfloat16, torch.bfloat16,
                                   2.0 ** -7),
                                  ("int8", torch.bfloat16, torch.int8,
                                   2.0 ** -7)):
        q = torch.randn((B, H, hd), generator=g, device=dev).to(qdt)
        if kvdt == torch.int8:
            kp = torch.randint(-127, 128, (P, ps, KV, hd), generator=g,
                               device=dev).to(torch.int8)
            vp = torch.randint(-127, 128, (P, ps, KV, hd), generator=g,
                               device=dev).to(torch.int8)
            ks = torch.rand((P, ps, KV), generator=g, device=dev) / 127
            vs = torch.rand((P, ps, KV), generator=g, device=dev) / 127
        else:
            kp = torch.randn((P, ps, KV, hd), generator=g, device=dev).to(kvdt)
            vp = torch.randn((P, ps, KV, hd), generator=g, device=dev).to(kvdt)
            ks = vs = None
        out = pa_ops.paged_decode_attention(q, kp, vp, bt, lens, k_scales=ks,
                                            v_scales=vs)
        ref = paged_decode_attention_ref(q, kp, vp, bt, lens, ks, vs)
        torch.cuda.synchronize()
        chk = held(torch, out, ref,
                   2.0 ** -18 * float(ref.float().abs().max()), rtol)
        if not chk["ok"]:
            raise AssertionError(f"paged_attention {name}: {chk}")
        if bool((out[0] != 0).any()):
            raise AssertionError("paged_attention: lens=0 row is not zero")
        esz = kp.element_size()
        nbytes = (2 * n_valid * KV * hd * esz
                  + (2 * n_valid * KV * 4 if ks is not None else 0)
                  + 2 * q.numel() * q.element_size() + bt.numel() * 4 + B * 4)
        flops = 4 * n_valid * (H // KV) * KV * hd
        b_ms, b_by = bound(nbytes, flops)
        case = dict(
            chk,
            ms=time_cold(torch, lambda: pa_ops.paged_decode_attention(
                q, kp, vp, bt, lens, k_scales=ks, v_scales=vs)),
            plain_ms=time_cold(torch, lambda: paged_decode_attention_ref(
                q, kp, vp, bt, lens, ks, vs)),
            bound_ms=b_ms, bound_by=b_by, valid_positions=n_valid)
        cases[name] = case
        emit({"phase": "kernels", "kernel": "paged_attention", "case": name,
              **case})
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
        # kernel V/1024 per thread, then a 10-level tree with a rescale per
        # merge; torch its own tree), so log l carries about (V/1024 + 60)
        # unit roundings between the two, plus a few ulps of |lp| from the
        # last subtractions
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
        cases[name] = case
        emit({"phase": "kernels", "kernel": "fused_sample", "case": name,
              **case})
    # the engine samples at temperature 1.0 from aligned logits
    report["fused_sample"] = dict(cases["gumbel"], cases=cases)


# ---------------------------------------------------------------------------
def phase_path(torch, model, params, report):
    from repro_torch.kernels.fused_sample import ops as fs_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.rl.engine import CompiledRolloutEngine
    from repro_torch.rl.envs import TicTacToe

    engine = CompiledRolloutEngine(
        model, TicTacToe(), cache_layout="paged", attn_impl="paged",
        sampling="fused", temperature=1.0, max_turns=4, max_turn_tokens=32,
        max_context=256, page_size=16)
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


def phase_branch(torch, model, params):
    """Kernel branch vs gather branch on one teacher-forced stream: 12
    observation tokens then 32 generated-length tokens, 32 rows."""
    cfg = model.cfg
    B, steps = 32, 12 + 32
    g = torch.Generator(device="cuda").manual_seed(3)
    stream = torch.randint(0, cfg.vocab_size, (steps, B), generator=g,
                           device="cuda").to(torch.int32)
    logits = {}
    for impl in ("paged", "xla"):
        cache = model.init_cache(B, 256, kv_dtype="bf16", device="cuda")
        outs = []
        for t in range(steps):
            lg, cache = model.decode_step(params, stream[t], cache,
                                          attn_impl=impl)
            outs.append(lg.float())
        logits[impl] = torch.stack(outs)
    d = (logits["paged"] - logits["xla"]).abs()
    scale = float(logits["xla"].abs().max())
    top1 = float((logits["paged"].argmax(-1)
                  == logits["xla"].argmax(-1)).float().mean())
    # bf16 model: both branches read the same bf16 K/V, but the gather
    # branch runs its softmax weights and P@V in bf16 while the kernel
    # stays f32 — a few bf16 ulps of drift per layer over 24 layers
    tol = 0.05 * scale
    out = dict(phase="branch", max_abs_dlogit=float(d.max()),
               mean_abs_dlogit=float(d.mean()), logit_scale=scale,
               tolerance=tol, top1_agreement=top1)
    emit(out)
    if not float(d.max()) <= tol or not bool(torch.isfinite(d).all()):
        raise AssertionError(f"kernel and gather branches disagree: {out}")


def device_busy(torch, prof):
    """Union of the device intervals (kernels, copies, fills) a profiler
    trace holds, in ms, with their count and the five kernels that took the
    most device time; (None, 0, []) when the trace holds no device event."""
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
                  for a in prof.key_averages()
                  if a.device_type == DeviceType.CUDA),
                 key=lambda r: -r[1])[:5]
    return busy_us / 1e3, len(iv), top


def phase_macro_step(torch, engine, params):
    """Three macro-steps of the path's engine from a fresh feed: the first
    under set_sync_debug_mode("error") (the one-sync-per-turn contract),
    the second timed on the host clock, the third under torch.profiler for
    the device's busy time. Idle share = 1 - busy / unprofiled wall time."""
    carry = engine.init_feed(params, engine.init_carry(32, 64))
    noise = engine.default_noise(torch.Generator(device="cuda").manual_seed(4))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        carry = engine.turn_step(params, carry, 0, noise)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    emit({"phase": "sync", "macro_steps_checked": 1,
          "returned_after_one_turn": int(carry.returned)})

    t0 = time.perf_counter()
    carry = engine.turn_step(params, carry, 1, noise)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        carry = engine.turn_step(params, carry, 2, noise)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, n_events, top = device_busy(torch, prof)
    steps = engine.max_turn_tokens + engine.env.obs_len
    emit({"phase": "trace", "decode_steps_per_macro_step": steps,
          "wall_ms": wall_ms, "profiled_wall_ms": prof_wall_ms,
          "device_busy_ms": busy_ms,
          "device_idle_share": (None if busy_ms is None
                                else 1.0 - busy_ms / wall_ms),
          "device_events": n_events,
          "device_events_per_decode_step": n_events / steps,
          "top_device_ms": top})


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
    cfg = get_config("qwen2-0.5b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        dtype=torch.bfloat16)
    torch.cuda.synchronize()
    emit({"phase": "init", "arch": cfg.arch_id, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "vocab": cfg.vocab_size,
          "params": sum(t.numel() for t in params.values()),
          "seconds": time.perf_counter() - t0})
    engine = phase_path(torch, model, params, report)
    phase_branch(torch, model, params)
    phase_macro_step(torch, engine, params)

    kernels = []
    for name, src, replaces in (
            ("paged_attention", "src/repro_torch/csrc/paged_attention.cu",
             "src/repro/kernels/paged_attention/kernel.py:33"),
            ("fused_sample", "src/repro_torch/csrc/fused_sample.cu",
             "src/repro/kernels/fused_sample/kernel.py:34")):
        r = report[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": r["launches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "cases": {c: {k: v[k] for k in ("max_abs_err", "atol", "rtol",
                                            "err_over_tol", "ms")}
                      for c, v in r["cases"].items()}})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
