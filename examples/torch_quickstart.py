"""Quickstart on the PyTorch port: build a model, train it on synthetic
tokens with the LM step, checkpoint it, and generate with the prefill and
serve steps (the twin of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Runs on the GPU unless ``--device cpu`` is given (the kernels then use
their plain PyTorch versions); the checkpoint goes to a temporary
directory, removed at the end.
"""
import argparse
import shutil
import tempfile

import torch

from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.core.train_step import (make_lm_train_step,
                                         make_prefill_step, make_serve_step)
from repro_torch.data import (SyntheticLMDataset, make_batches,
                              pack_documents, shard_batch)
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import adamw


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--epochs", type=int, default=4)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    kernels = dev.type == "cuda"

    # 1. model: any architecture id works (smoke = CPU-sized)
    cfg = get_smoke_config("qwen2-0.5b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    print(f"built {cfg.arch_id} on {dev}: "
          f"{sum(t.numel() for t in params.values()):,} params")

    # 2. data: deterministic synthetic corpus with learnable structure
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seed=0)
    rows = pack_documents(ds.documents(200), seq_len=64)

    # 3. train: LM step (cross-entropy + AdamW), flash kernels on the card
    opt = adamw(3e-3, weight_decay=0.0)
    opt_state = opt.init(params)
    step_fn = make_lm_train_step(model, opt,
                                 attn_impl="flash" if kernels else "xla")
    losses = []
    i = 0
    for epoch in range(args.epochs):
        for batch in make_batches(rows[:128], 16, shuffle_seed=epoch):
            tokens = shard_batch(batch, dev).long()
            labels = torch.roll(tokens, -1, dims=1)
            labels[:, -1] = -1
            params, opt_state, m = step_fn(params, opt_state, tokens, labels)
            losses.append(float(m["loss"]))
            if i % 8 == 0:
                print(f"step {i:3d}  loss {losses[-1]:.4f}")
            i += 1
    assert losses[-1] < losses[0], "loss should decrease"
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")

    # 4. checkpoint round trip
    path = tempfile.mkdtemp(prefix="torch_quickstart_")
    try:
        save_checkpoint(path, 0, {"params": params})
        back = restore_checkpoint(path, 0, {"params": params})["params"]
    finally:
        shutil.rmtree(path, ignore_errors=True)
    assert all(torch.equal(back[k], params[k]) for k in params)
    params = back
    print("checkpoint round-trip ok")

    # 5. generate: the prefill step, then the greedy serve step
    prefill = make_prefill_step(model,
                                attn_impl="flash" if kernels else "xla")
    serve = make_serve_step(model, attn_impl="pallas" if kernels else "xla")
    prompt = shard_batch(rows[:2, :8], dev).long()
    cache = model.init_cache(2, 32, device=dev)
    logits, cache = prefill(params, prompt, cache)
    tok = logits.argmax(-1).to(torch.int32)
    out = [tok]
    for _ in range(8):
        tok, _, cache = serve(params, tok, cache)
        out.append(tok)
    gen = torch.stack(out, dim=1).cpu()
    print("generated continuations:\n", gen.numpy())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
