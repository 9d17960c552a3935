"""Batched serving on the PyTorch port: prefill a batch of ragged prompts,
feed the ragged tails with the advance mask, then decode greedily (the
twin of ``examples/serve_batched.py``). The audio and vlm families
(``whisper-large-v3``, ``llama-3.2-vision-11b``) get their stubbed
modality inputs from ``Model.make_extras``.

    PYTHONPATH=src python examples/torch_serve_batched.py \
        [--arch whisper-large-v3] [--attn-impl pallas] [--device cpu]

``--attn-impl pallas`` takes the kernels: the flash forward in the prefill
and the split-K decode kernel in each decode step (their plain versions
on the CPU). Runs on the GPU unless ``--device cpu`` is given.
"""
import argparse
import time

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.train_step import make_prefill_step, make_serve_step
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model

# the port's kernel names for JAX's "pallas": prefill, decode
KERNELS = {"xla": ("xla", "xla"), "pallas": ("flash", "pallas")}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--attn-impl", default="xla", choices=sorted(KERNELS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen-tokens", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    prefill_impl, decode_impl = KERNELS[args.attn_impl]

    cfg = get_smoke_config(args.arch)
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen)
    extra = model.make_extras(gen, args.batch)

    # ragged prompts: rows of different lengths, left-aligned
    lengths = torch.tensor([5, 9, 3, 7][: args.batch], device=dev)
    max_len = int(lengths.max())
    prompts = torch.randint(1, cfg.vocab_size, (args.batch, max_len),
                            generator=gen, device=dev)

    prefill = make_prefill_step(model, attn_impl=prefill_impl)
    serve = make_serve_step(model, attn_impl=decode_impl)

    # prefill the COMMON prefix length, then feed the ragged tails with the
    # advance mask (the rollout engine's trick, reused for serving)
    common = int(lengths.min())
    cache = model.init_cache(args.batch, args.cache_len, device=dev)
    logits, cache = prefill(params, prompts[:, :common], cache, extra)
    with torch.no_grad():
        for j in range(common, max_len):
            still = lengths > j
            tok = torch.where(still, prompts[:, j], 0).to(torch.int32)
            new, cache = model.decode_step(params, tok, cache, extra=extra,
                                           attn_impl=decode_impl,
                                           advance=still)
            logits = torch.where(still[:, None], new, logits)

    # greedy generation through the serve step
    tok = logits.argmax(-1).to(torch.int32)
    outs = [tok]
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.gen_tokens):
        tok, logits, cache = serve(params, tok, cache, extra)
        outs.append(tok)
    out = torch.stack(outs, dim=1).cpu()
    dt = time.perf_counter() - t0
    assert bool(torch.isfinite(logits).all())
    assert cache.pos.tolist() == (lengths + args.gen_tokens).tolist()
    print(f"arch={cfg.arch_id} attn_impl={args.attn_impl} device={dev}")
    print(f"prompt lengths: {lengths.tolist()}")
    print(f"generated {args.gen_tokens} tokens x {args.batch} rows "
          f"in {dt:.2f}s ({args.gen_tokens * args.batch / dt:.1f} tok/s)")
    print(out.numpy())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
