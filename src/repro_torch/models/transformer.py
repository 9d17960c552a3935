"""Dense decoder-only transformer: the full-sequence forward of training,
the dense ring-buffer cache (prefill and decode), the paged pool (prefill
with prefix sharing, decode with copy-on-write, int8 pages) and the
speculative verify step (port of ``repro/models/transformer.py``).

Layer params keep the stacked leading ``layers`` axis of the JAX tree;
``lax.scan`` over layers becomes a Python loop over views of the stacked
tensors, and ``jax.checkpoint`` (``cfg.remat == "full"``) becomes
``torch.utils.checkpoint`` per layer. The KV tensors of both layouts are
updated IN PLACE by prefill and each decode step; the block table,
refcounts and positions are returned as new tensors.

Tensor parallelism: ``forward``, ``prefill``, ``decode_step``,
``spec_verify_step``, ``init_cache`` and ``decode_scan_body`` take ``tp=`` (a
``models.tensor_parallel.TPContext``; None is one rank). ``params`` are
then the rank's local shards (``core.resharding.shard_params``), the
caches hold the rank's kv heads, and the logits are its vocab columns.
The block table, refcounts and positions stay the same on every rank:
they are replicated, and the collectives never depend on them differing.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import paging
from repro_torch.models.param import pdef
from repro_torch.models.tensor_parallel import heads as _heads


def block_defs(cfg: ModelConfig):
    n = cfg.n_layers
    defs = {
        "ln1": pdef((n, cfg.d_model), ("layers", "embed"), "ones"),
        "ln2": pdef((n, cfg.d_model), ("layers", "embed"), "ones"),
    }
    for k, d in L.attention_defs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.head_dim_, qkv_bias=cfg.qkv_bias,
                                 layers=n).items():
        defs[f"attn.{k}"] = d
    for k, d in L.mlp_defs(cfg.d_model, cfg.d_ff, layers=n).items():
        defs[f"mlp.{k}"] = d
    return defs


def model_defs(cfg: ModelConfig):
    """Flat ParamDef dict with the JAX tree's dotted paths."""
    defs = {"embedding": L.embedding_defs(cfg.vocab_size, cfg.d_model),
            "ln_f": pdef((cfg.d_model,), ("embed",), "ones")}
    for k, d in block_defs(cfg).items():
        defs[f"layers.{k}"] = d
    if not cfg.tie_embeddings:
        defs["lm_head"] = pdef((cfg.d_model, cfg.vocab_size),
                               ("embed", "vocab"), "scaled")
    return defs


def layer_params(params, i: int, prefix: str = "layers"):
    """Views of layer ``i``'s params sliced from the stacked leaves under
    ``prefix``: ``layers.<name>`` becomes ``out[name]`` and
    ``layers.<block>.<name>`` ``out[block][name]`` (dense: ``{"ln1",
    "ln2", "attn": {...}, "mlp": {...}}``; ssm: ``{"ln", "mixer":
    {...}}``; the audio family's stacks are ``encoder`` and ``decoder``,
    the vlm's ``layers`` and ``cross_layers``)."""
    out = {}
    for path, t in params.items():
        parts = path.split(".")
        if parts[0] != prefix:
            continue
        if len(parts) == 2:
            out[parts[1]] = t[i]
        else:
            out.setdefault(parts[1], {})[parts[2]] = t[i]
    return out


def _block_apply(cfg: ModelConfig, p, x, *, window: int,
                 attn_impl: str = "xla", tp=None):
    H, KV = _heads(cfg, tp)
    h = L.rms_norm(x, p["ln1"], cfg.rms_eps)
    h = L.self_attention(
        p["attn"], h, n_heads=H, n_kv_heads=KV,
        head_dim=cfg.head_dim_, rope_theta=cfg.rope_theta, window=window,
        attn_impl=attn_impl, tp=tp)
    x = x + h
    h = L.rms_norm(x, p["ln2"], cfg.rms_eps)
    return x + L.mlp(p["mlp"], h, tp)


def forward(cfg: ModelConfig, params, tokens, *, extra=None,
            attn_impl: str = "xla", tp=None):
    """Full-sequence forward -> logits (B, S, V). With ``cfg.remat ==
    "full"`` and grad enabled, each layer keeps only its input for the
    backward and runs again inside it (with ``attn_impl="flash"`` that
    recompute launches the forward kernel once more per layer). Under
    ``tp`` (no autograd) the logits are the rank's vocab columns."""
    del extra
    if tp is not None and torch.is_grad_enabled():
        raise ValueError("the tensor-parallel forward takes no gradient: "
                         "run it under torch.no_grad()")
    x = L.embed(params["embedding"], tokens, tp)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        if cfg.remat == "full" and torch.is_grad_enabled():
            x = checkpoint(_block_apply, cfg, lp, x,
                           window=cfg.sliding_window, attn_impl=attn_impl,
                           use_reentrant=False)
        else:
            x = _block_apply(cfg, lp, x, window=cfg.sliding_window,
                             attn_impl=attn_impl, tp=tp)
    return _chunk_logits(cfg, params, x, tp)


class DecodeCache(NamedTuple):
    """Dense layout: ``kv.k``/``kv.v`` are ``(n_layers, B, s_max, KV, hd)``
    ring buffers (``layers.decode_attention``)."""
    kv: L.KVEntry
    pos: torch.Tensor           # (B,) int32 per-row cache fill


class PagedDecodeCache(NamedTuple):
    """Paged KV layout: one shared page pool per layer plus per-slot block
    tables. ``kv.k``/``kv.v`` are ``(n_layers, n_pages + 1, page_size, KV,
    hd)``: the last page of every layer is the trash page that dropped
    writes land in (see ``layers``). An int8 pool also carries
    ``kv.k_scale``/``kv.v_scale`` of ``(n_layers, n_pages + 1, page_size,
    KV)`` f32, each with its trash page."""
    kv: L.KVEntry
    block_table: torch.Tensor   # (B, pages_per_slot) int32; -1 = unmapped
    refcount: torch.Tensor      # (n_pages,) int32 — 0 = free
    pos: torch.Tensor           # (B,) int32 per-row cache fill

    @property
    def page_size(self) -> int:
        return self.kv.k.shape[2]

    @property
    def n_pages(self) -> int:
        return self.refcount.shape[0]


KV_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16,
             "int8": torch.int8}


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               dtype=torch.bfloat16, *, layout: str = "dense",
               page_size: int = 16, n_pages: Optional[int] = None,
               kv_dtype: Optional[str] = None, device=None, tp=None):
    """A zeroed decode cache. ``layout="dense"`` (the default, as in JAX):
    per-row ring buffers of ``s_max`` slots, ``min(s_max, window)`` for a
    sliding-window config. ``layout="paged"``: a page pool of ``n_pages``
    pages (default: full provisioning, ``batch * pages_per_slot``) plus one
    trash page. ``kv_dtype`` ("fp32" | "bf16" | "int8") overrides ``dtype``
    by name; "int8" (paged layout only) stores page values as int8 with f32
    scale pools of ``(n_layers, n_pages + 1, page_size, KV)`` beside them
    (``paging.quantize_kv``). Under ``tp`` the KV tensors hold the rank's
    kv heads."""
    n_kv = _heads(cfg, tp)[1]
    if kv_dtype is not None:
        if kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype must be one of {list(KV_DTYPES)}, "
                             f"got {kv_dtype!r}")
        if kv_dtype == "int8" and layout != "paged":
            raise ValueError(
                "kv_dtype='int8' requires the paged layout — the scales are "
                "a second page pool sharing the block-table/refcount "
                "lifecycle")
        dtype = KV_DTYPES[kv_dtype]
    zeros = lambda shape: torch.zeros(shape, dtype=dtype, device=device)
    pos = torch.zeros((batch,), dtype=torch.int32, device=device)
    if layout == "dense":
        if cfg.sliding_window > 0:
            s_max = min(s_max, cfg.sliding_window)
        shape = (cfg.n_layers, batch, s_max, n_kv, cfg.head_dim_)
        return DecodeCache(kv=L.KVEntry(zeros(shape), zeros(shape)), pos=pos)
    if layout != "paged":
        raise ValueError(f"layout must be 'dense' or 'paged', got "
                         f"{layout!r}")
    if cfg.sliding_window > 0:
        raise ValueError("the paged cache does not take sliding-window "
                         "configs (the dense ring buffer already holds "
                         "only the window)")
    nps = paging.pages_per_slot(s_max, page_size)
    if n_pages is None:
        n_pages = batch * nps
    shape = (cfg.n_layers, n_pages + 1, page_size, n_kv, cfg.head_dim_)
    kv = L.KVEntry(zeros(shape), zeros(shape))
    if dtype == torch.int8:
        scale = lambda: torch.zeros(shape[:-1], dtype=torch.float32,
                                    device=device)
        kv = kv._replace(k_scale=scale(), v_scale=scale())
    return PagedDecodeCache(
        kv=kv,
        block_table=torch.full((batch, nps), paging.PAGE_UNMAPPED,
                               dtype=torch.int32, device=device),
        refcount=torch.zeros((n_pages,), dtype=torch.int32, device=device),
        pos=pos)


def _apply_layers(cfg: ModelConfig, x, layers, attend, tp=None):
    """The decoder stack around an attention callable ``attend(i, attn
    params, h) -> h``; returns the residual stream after the last layer
    (the final norm is the head's)."""
    for i, lp in enumerate(layers):
        h = L.rms_norm(x, lp["ln1"], cfg.rms_eps)
        x = x + attend(i, lp["attn"], h)
        h = L.rms_norm(x, lp["ln2"], cfg.rms_eps)
        x = x + L.mlp(lp["mlp"], h, tp)
    return x


def _chunk_logits(cfg: ModelConfig, params, x, tp=None):
    """Final norm and head over every position: (B,S,D) -> (B,S,V) (the
    rank's vocab columns under ``tp``). The head is tied exactly when
    the params hold no ``lm_head``, which a vocab shard's shape cannot
    tell."""
    x = L.rms_norm(x, params["ln_f"], cfg.rms_eps)
    tied = "lm_head" not in params
    head = params["embedding"] if tied else params["lm_head"]
    return L.unembed(head, x, tied=tied)


def _logits(cfg: ModelConfig, params, x, tp=None):
    return _chunk_logits(cfg, params, x, tp)[:, 0]


def _paged_prefill(cfg: ModelConfig, params, tokens,
                   cache: PagedDecodeCache, *, attn_impl: str = "xla",
                   shared_prefix_len: int = 0, tp=None):
    """Prompt pass on the paged layout: the covering pages are allocated
    once (every layer shares the block table), then each layer writes its
    K/V into them in place.

    ``shared_prefix_len > 0`` declares the first tokens of EVERY row
    identical: their full pages are prefilled once at batch 1 and forked
    into every row (refcount B), and only the rest of the prompt (the
    partial last page included) runs per row (``L.paged_chunk_attention``).
    The shared run is whole pages and never the whole prompt: the last
    position's logits come from a per-row pass."""
    B, S = tokens.shape
    dev = tokens.device
    ps, P = cache.page_size, cache.n_pages
    npp = paging.pages_per_slot(S, ps)
    if npp > cache.block_table.shape[1]:
        raise ValueError(f"prompt of {S} tokens does not fit "
                         f"{cache.block_table.shape[1]} pages of {ps}")
    shared_pages = min(int(shared_prefix_len), S - 1) // ps if B > 1 else 0
    shared_len = shared_pages * ps
    bt, refcount = cache.block_table, cache.refcount
    H, KV = _heads(cfg, tp)
    akw = dict(n_heads=H, n_kv_heads=KV,
               head_dim=cfg.head_dim_, rope_theta=cfg.rope_theta,
               attn_impl=attn_impl, tp=tp)
    layers = [layer_params(params, i) for i in range(cfg.n_layers)]
    emb = lambda t: L.embed(params["embedding"], t, tp)

    def layer_pass(x, table, attend):
        return _apply_layers(cfg, x, layers, lambda i, p, h: attend(
            p, h, cache.kv.layer(i), table, **akw)[0], tp)

    if shared_pages > 0:
        # the shared prefix ONCE (batch 1) into a fresh page run, forked
        # into every row; the run's own allocation reference is handed
        # over to the rows
        run, refcount = paging.alloc_pages(
            refcount, torch.ones((shared_pages,), dtype=torch.bool,
                                 device=dev))
        layer_pass(emb(tokens[:1, :shared_len]), run[None, :],
                   L.paged_prefill_attention)
        refcount, bt = paging.fork_pages(
            refcount, bt, run, torch.ones((B,), dtype=torch.bool,
                                          device=dev))
        ok = run < P
        refcount = refcount.scatter_add(0, torch.where(ok, run, 0).long(),
                                        -ok.to(refcount.dtype))
    bt = bt.clone()
    for j in range(shared_pages, npp):     # static page-slot loop
        need = bt[:, j] < 0
        pages, refcount = paging.alloc_pages(refcount, need)
        bt[:, j] = torch.where(need & (pages < P), pages, bt[:, j])
    if shared_pages > 0:
        x = layer_pass(
            emb(tokens[:, shared_len:]), bt,
            lambda p, h, kv, table, **kw: L.paged_chunk_attention(
                p, h, kv, table, shared_len, **kw))
    else:
        x = layer_pass(emb(tokens), bt, L.paged_prefill_attention)
    return _logits(cfg, params, x[:, -1:], tp), PagedDecodeCache(
        kv=cache.kv, block_table=bt, refcount=refcount,
        pos=torch.full((B,), S, dtype=torch.int32, device=dev))


def prefill(cfg: ModelConfig, params, tokens, cache, *, extra=None,
            attn_impl: str = "xla", shared_prefix_len: int = 0, tp=None):
    """Run the prompt (B, S) through the model into the cache (its KV
    tensors written in place). Returns ``(logits of the last position
    (B, V), cache)``. attn_impl: "xla" or "flash" (the paged layout also
    takes "paged", its flash route). ``shared_prefix_len`` (paged layout
    only): the first tokens of every row are identical — prefill them once
    and fork their pages (``_paged_prefill``)."""
    del extra
    if isinstance(cache, PagedDecodeCache):
        return _paged_prefill(cfg, params, tokens, cache,
                              attn_impl=attn_impl,
                              shared_prefix_len=shared_prefix_len, tp=tp)
    if shared_prefix_len:
        raise ValueError("shared_prefix_len requires the paged cache layout "
                         "(dense rows have nothing to fork)")
    B, S = tokens.shape
    H, KV = _heads(cfg, tp)
    akw = dict(n_heads=H, n_kv_heads=KV,
               head_dim=cfg.head_dim_, rope_theta=cfg.rope_theta,
               window=cfg.sliding_window, attn_impl=attn_impl, tp=tp)
    layers = [layer_params(params, i) for i in range(cfg.n_layers)]
    x = _apply_layers(
        cfg, L.embed(params["embedding"], tokens, tp), layers,
        lambda i, p, h: L.prefill_attention(
            p, h, cache.kv.layer(i), **akw)[0], tp)
    return _logits(cfg, params, x[:, -1:], tp), cache._replace(
        pos=torch.full((B,), S, dtype=torch.int32, device=tokens.device))


def _dense_decode_step(cfg: ModelConfig, params, token, cache: DecodeCache,
                       *, attn_impl: str = "xla", advance=None, layers=None,
                       tp=None):
    """One decode step on the dense layout: rows with ``advance=False``
    write nothing and keep their position."""
    B = token.shape[0]
    adv = (torch.ones((B,), dtype=torch.bool, device=token.device)
           if advance is None else advance)
    if layers is None:
        layers = [layer_params(params, i) for i in range(cfg.n_layers)]
    H, KV = _heads(cfg, tp)
    akw = dict(n_heads=H, n_kv_heads=KV,
               head_dim=cfg.head_dim_, rope_theta=cfg.rope_theta,
               window=cfg.sliding_window, attn_impl=attn_impl, advance=adv,
               tp=tp)
    x = _apply_layers(
        cfg, L.embed(params["embedding"], token[:, None], tp), layers,
        lambda i, p, h: L.decode_attention(
            p, h, cache.kv.layer(i), cache.pos, **akw)[0], tp)
    return _logits(cfg, params, x, tp), DecodeCache(
        kv=cache.kv, pos=cache.pos + adv.to(torch.int32))


def _paged_decode_step(cfg: ModelConfig, params, token,
                       cache: PagedDecodeCache, *, attn_impl: str = "xla",
                       advance=None, layers=None, cow: bool = True, tp=None,
                       grant=None):
    """One decode step on the paged layout. The page allocator runs ONCE
    per token, outside the layer loop: every layer shares the block table.
    Rows with ``advance=False`` neither allocate nor write (their write
    goes to the trash page) and keep their position. ``layers``: the
    per-layer param views, when the caller has already sliced them.

    A row writing into a SHARED page (refcount > 1: a forked prefix page
    whose run was not page-aligned) privatizes it first (``paging.
    cow_pages``; each layer copies the page before its write); a row that
    finds no free page for its copy drops its write. ``cow=False``
    statically removes this guard, its allocator pass and its per-layer
    copies: only safe when no write can land in a shared page (no sharing,
    or page-aligned sharing whose writes start past the shared run).
    ``grant``: the allocations' global rank rule on a data row of a
    data-parallel rollout (``paging.alloc_pages``)."""
    x = L.embed(params["embedding"], token[:, None], tp)
    B = token.shape[0]
    dev = token.device
    pos = cache.pos
    adv = (torch.ones((B,), dtype=torch.bool, device=dev)
           if advance is None else advance)
    ps, P = cache.page_size, cache.n_pages
    rows = torch.arange(B, device=dev)

    pidx = (pos // ps).clamp(0, cache.block_table.shape[1] - 1).long()
    cur = cache.block_table[rows, pidx]
    need = adv & (cur < 0)
    pages, refcount = paging.alloc_pages(cache.refcount, need, grant)
    fresh = need & (pages < P)
    bt = cache.block_table.clone()
    bt[rows, pidx] = torch.where(fresh, pages, cur)
    cow_src = cow_dst = None
    w_ok = adv
    if cow:
        cow_src, cow_dst, blocked, refcount, bt = paging.cow_pages(
            refcount, bt, pidx, adv & (bt[rows, pidx] >= 0), grant)
        w_ok = adv & ~blocked
    wpage = bt[rows, pidx]                                  # (B,) may be -1
    w_ok = w_ok & (wpage >= 0)
    wpage = torch.where(w_ok, wpage, P)                     # trash page
    woff = pos % ps
    # a page mapped mid-row (recovery from pool exhaustion: writes dropped
    # while pos advanced) is scrubbed, or the offsets below woff would
    # expose a freed episode's K/V as live context (a CoW copy is not: its
    # content below the fill line is the shared prefix, which must stay)
    scrub = torch.where(fresh & (woff > 0), wpage, P)

    if layers is None:
        layers = [layer_params(params, i) for i in range(cfg.n_layers)]
    H, KV = _heads(cfg, tp)
    x = _apply_layers(
        cfg, x, layers,
        lambda i, p, h: L.paged_decode_attention(
            p, h, cache.kv.layer(i), bt, pos, wpage=wpage, woff=woff,
            scrub=scrub, cow_src=cow_src, cow_dst=cow_dst,
            n_heads=H, n_kv_heads=KV, head_dim=cfg.head_dim_,
            rope_theta=cfg.rope_theta, attn_impl=attn_impl, tp=tp)[0], tp)
    return _logits(cfg, params, x, tp), PagedDecodeCache(
        kv=cache.kv, block_table=bt, refcount=refcount,
        pos=pos + adv.to(torch.int32))


def decode_step(cfg: ModelConfig, params, token, cache, *, extra=None,
                attn_impl: str = "xla", advance=None, cow: bool = True,
                tp=None):
    """One decode step. token: (B,) int. Returns (logits (B,V), cache).
    advance: optional (B,) bool — rows with False are no-ops. The KV
    tensors of ``cache`` are written in place. attn_impl: "xla" on either
    layout; "pallas" (the decode kernel) on the dense layout, "paged" (the
    paged kernel) on the paged one. cow: paged layout only — False drops
    the copy-on-write guard (``_paged_decode_step``)."""
    del extra
    if isinstance(cache, PagedDecodeCache):
        return _paged_decode_step(cfg, params, token, cache,
                                  attn_impl=attn_impl, advance=advance,
                                  cow=cow, tp=tp)
    return _dense_decode_step(cfg, params, token, cache,
                              attn_impl=attn_impl, advance=advance, tp=tp)


def spec_verify_step(cfg: ModelConfig, params, chunk,
                     cache: PagedDecodeCache, *, attn_impl: str = "xla",
                     advance=None, eff_k=None, cow: bool = True, tp=None,
                     grant=None):
    """Score a (B, K) chunk of candidate tokens against the full model in
    one batched pass on the paged layout: the verify half of speculative
    decoding. ``chunk[:, 0]`` is the token sequential decode would commit
    next; ``chunk[:, j>0]`` are draft proposals. Returns ``(logits (B, K,
    V), cache)``: ``logits[:, j]`` is the model's next-token distribution
    after consuming ``chunk[:, :j+1]``.

    The page allocator runs once, outside the layer loop: a static loop of
    ``(K + ps - 2) // ps + 1`` rank-match allocations maps every page that
    covers ``[pos, pos + eff_k)``. Every layer then writes the whole
    chunk's K/V into the pool IN PLACE (``layers.
    spec_verify_chunk_attention``). ``cache.pos`` is NOT advanced: the
    caller learns the accepted prefix from the logits and commits it with
    ``spec_commit``.

    advance: (B,) bool — rows with False are no-ops. eff_k: (B,) int32 —
    positions ``j >= eff_k[b]`` are neither allocated nor written (rows
    near their turn's token budget); their logits must not be committed.
    attn_impl: "paged" (the spec-verify kernel) or "xla". cow: as in
    ``_paged_decode_step`` — only the chunk's FIRST page can be a shared
    page (later chunk pages are freshly allocated), so a row whose copy is
    blocked drops its writes into that page only. tp: the rank's
    tensor-parallel context: the kernel runs on the rank's q and kv heads,
    the o-proj and the MLP all-reduce, and the logits are the rank's vocab
    columns; the write plan is replicated. grant: the allocations'
    global rank rule on a data row (``paging.alloc_pages``).
    """
    B, K = chunk.shape
    dev = chunk.device
    x = L.embed(params["embedding"], chunk, tp)              # (B,K,D)
    pos = cache.pos
    adv = (torch.ones((B,), dtype=torch.bool, device=dev)
           if advance is None else advance)
    ek = (torch.full((B,), K, dtype=torch.int32, device=dev)
          if eff_k is None else eff_k.to(torch.int32))
    ps, P = cache.page_size, cache.n_pages
    NP = cache.block_table.shape[1]
    rows = torch.arange(B, device=dev)

    pidx0 = (pos // ps).clamp(0, NP - 1).long()
    last = pos + ek.clamp_min(1) - 1          # last chunk position per row
    lastd = (last // ps).clamp(0, NP - 1).long() - pidx0
    bt = cache.block_table.clone()
    refcount = cache.refcount
    fresh0 = None
    for d in range((K + ps - 2) // ps + 1):   # pages a chunk can touch
        pidx = (pidx0 + d).clamp(0, NP - 1)
        cur = bt[rows, pidx]
        need = adv & (ek > 0) & (d <= lastd) & (cur < 0)
        pages, refcount = paging.alloc_pages(refcount, need, grant)
        fresh = need & (pages < P)
        bt[rows, pidx] = torch.where(fresh, pages, cur)
        if d == 0:
            fresh0 = fresh
    cow_src = cow_dst = None
    if cow:
        cow_src, cow_dst, blocked, refcount, bt = paging.cow_pages(
            refcount, bt, pidx0, adv & (ek > 0) & (bt[rows, pidx0] >= 0),
            grant)
    # a freshly mapped first page mid-row (recovery from pool exhaustion)
    # is scrubbed, as in _paged_decode_step; later chunk pages always map
    # at offset 0
    scrub = torch.where(fresh0 & (pos % ps > 0), bt[rows, pidx0], P)

    # the (B, K) write plan: the trash page P takes non-advancing rows,
    # positions past eff_k, unmapped (exhausted) pages and CoW-blocked
    # writes into the still-shared first page
    j = torch.arange(K, device=dev)[None, :]
    cpos = pos[:, None] + j
    pidx_j = (cpos // ps).clamp(0, NP - 1).long()
    wp = bt[rows[:, None], pidx_j]
    w_ok = adv[:, None] & (j < ek[:, None]) & (wp >= 0)
    if cow:
        w_ok = w_ok & ~(blocked[:, None] & (pidx_j == pidx0[:, None]))
    wpage = torch.where(w_ok, wp, P)
    woff = cpos % ps

    layers = [layer_params(params, i) for i in range(cfg.n_layers)]
    H, KV = _heads(cfg, tp)
    x = _apply_layers(
        cfg, x, layers,
        lambda i, p, h: L.spec_verify_chunk_attention(
            p, h, cache.kv.layer(i), bt, pos, wpage=wpage, woff=woff,
            scrub=scrub, cow_src=cow_src, cow_dst=cow_dst,
            n_heads=H, n_kv_heads=KV, head_dim=cfg.head_dim_,
            rope_theta=cfg.rope_theta, attn_impl=attn_impl, tp=tp)[0], tp)
    return _chunk_logits(cfg, params, x, tp), PagedDecodeCache(
        kv=cache.kv, block_table=bt, refcount=refcount, pos=pos)


def spec_commit(cache: PagedDecodeCache, n_commit):
    """Advance the paged fill line by ``n_commit`` (B,) committed tokens
    after ``spec_verify_step``: validity everywhere is ``idx < pos``, so
    this add is the whole commit."""
    return cache._replace(pos=cache.pos + n_commit.to(torch.int32))


def draft_params_view(params, draft_layers: int):
    """The truncated layer stack of ``speculation="self"``: the first
    ``draft_layers`` entries of every stacked layer leaf, as views (no
    copy), sharing the embedding, ``ln_f`` and the head."""
    return {k: (t[:draft_layers] if k.startswith("layers.") else t)
            for k, t in params.items()}


def scan_body_over(step_fn):
    """Wrap ``(token, advance, cache) -> (logits, cache)`` into the JAX
    scan-body shape ``((logits, cache), (token, advance)) -> ((logits,
    cache), None)``: rows with ``advance=False`` neither write the cache
    nor update their logits."""

    def body(carry, x):
        logits, cache = carry
        token, advance = x
        new_logits, cache = step_fn(token, advance, cache)
        logits = torch.where(advance[:, None], new_logits, logits)
        return (logits, cache), None

    return body


def decode_scan_body(cfg: ModelConfig, params, *, attn_impl: str = "xla",
                     cow: bool = True, tp=None, grant=None):
    """Decode body for in-loop generation, bound to the decode step of the
    cache it is given (per-layer param views are sliced once here, not
    once per token). cow: the paged step's copy-on-write guard. tp: the
    rank's tensor-parallel context (``params`` its local shards). grant:
    the paged step's global rank rule on a data row."""
    layers = [layer_params(params, i) for i in range(cfg.n_layers)]

    def step(token, advance, cache):
        if isinstance(cache, PagedDecodeCache):
            return _paged_decode_step(cfg, params, token, cache,
                                      attn_impl=attn_impl, advance=advance,
                                      layers=layers, cow=cow, tp=tp,
                                      grant=grant)
        return _dense_decode_step(cfg, params, token, cache,
                                  attn_impl=attn_impl, advance=advance,
                                  layers=layers, tp=tp)

    return scan_body_over(step)
