"""Mixture-of-Experts decoder (granite-moe / grok-1 family) (port of
``repro/models/moe.py``).

Expert FFNs use GShard-style capacity-based dispatch over groups of
tokens:

    probs    = softmax(x @ router)                  (G,T,E)
    dispatch = one_hot(top-k, capacity slots)       (G,T,E,C)
    h        = einsum(dispatch, x) -> expert FFN -> combine

Tokens past an expert's capacity are dropped (their expert output is 0;
the residual carries them). The router aux (load-balance) loss follows
Shazeer/GShard: ``aux = E * sum_e(frac_tokens_e * mean_prob_e)``.

Routing is held bitwise to JAX's: the top-k order breaks ties to the
lower expert index as ``lax.top_k`` does (a stable sort), and capacity
slots are the running count over the flattened ``(t, k)`` order, so a
dropped token depends on every earlier token's choices. Prefill and the
Update dispatch with capacity; decode runs every expert on every token
(``moe_mlp_dense``) and drops nothing, as in JAX, so the rollout's and the
update's log-probs differ wherever a token was dropped.

The expert products are plain einsums/matmuls, as JAX's are (no Pallas
kernel in either package); attention takes the dense family's kernels.
As in the port's transformer, ``prefill`` and ``decode_step`` write the
KV ring IN PLACE and return ``pos`` as a new tensor.

Tensor parallelism (``tp=``, a ``models.tensor_parallel.TPContext``):
``init_cache``, ``prefill``, ``decode_step`` and ``decode_scan_body`` run
attention on the rank's heads, as the transformer's, and the expert layer
on the rank's experts (``TPPlan.experts``). The router is replicated, so
every rank routes the whole group, gets the same capacity slots and drops
the same tokens; it fills and runs only its experts' buffers, and the
combine's partial sums, in f32, are all-reduced and rounded once
(``TPContext.partial_sum``).

A data-parallel update (``forward(split=)``) routes the global batch's
dispatch groups, as JAX's one program does: a group that straddles the
update's ranks is routed whole on each of them, its other tokens moved in
(``moe_mlp``, ``_GroupEdges``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.param import pdef
from repro_torch.models.tensor_parallel import exchange, heads as _heads
from repro_torch.models.transformer import (_chunk_logits, layer_params,
                                            scan_body_over)


def moe_mlp_defs(cfg: ModelConfig, *, layers=None):
    m = cfg.moe
    n = (layers,) if layers else ()
    ax = ("layers",) if layers else ()
    d, f, e = cfg.d_model, m.d_ff_expert, m.n_experts
    return {
        "router": pdef(n + (d, e), ax + ("embed", "experts"), "scaled"),
        "w_gate": pdef(n + (e, d, f), ax + ("experts", "embed", "expert_mlp"),
                       "scaled"),
        "w_up": pdef(n + (e, d, f), ax + ("experts", "embed", "expert_mlp"),
                     "scaled"),
        "w_down": pdef(n + (e, f, d), ax + ("experts", "expert_mlp", "embed"),
                       "scaled"),
    }


def _capacity(tokens_per_group: int, n_experts: int, top_k: int,
              factor: float) -> int:
    c = int(math.ceil(tokens_per_group * top_k / n_experts * factor))
    return max(c, top_k)


MOE_GROUP_TOKENS = 512     # GShard group size: capacity tensors are
                           # O(T^2 * E) per group, so T must stay bounded


def moe_mlp(cfg: ModelConfig, p, x, tp=None, *, split=None):
    """x: (B, S, D) -> (out (B,S,D), aux_loss scalar).

    Tokens are regrouped into ``MOE_GROUP_TOKENS``-sized dispatch groups
    when ``B*S`` divides into them (a group then spans batch rows, padding
    tokens included, and they count toward an expert's capacity), else
    into one group per row of ``S``. Under ``tp`` ``p`` holds the rank's
    experts and the output is summed over the ranks.

    ``split`` (a ``models.tensor_parallel.UpdateSplit``): ``x`` is one
    rank's rows of a batch split over a data-parallel update's ranks. The
    groups are the global batch's, cut from its tokens in row-major order,
    as JAX's one program cuts them. A group that straddles ranks is routed
    whole by every rank that holds one of its tokens (capacity slots are a
    running count over the group): the other ranks' tokens of the groups
    at this rank's edges come in by ``_GroupEdges``, and the rank keeps
    its own tokens' outputs. The aux loss is this rank's share of the mean
    over the global groups: each group's term weighted by the share of its
    tokens the rank holds."""
    B_, S_, D_ = x.shape
    rows = (B_,) if split is None else split.rows
    Tg = _group_tokens(sum(rows) * S_, S_)
    a = 0 if split is None else S_ * split.first_row()
    b = a + B_ * S_
    lo, hi = a - a % Tg, -(-b // Tg) * Tg
    straddles = (lo, hi) != (a, b)
    xg = (_GroupEdges.apply(x.reshape(B_ * S_, D_), split, S_, Tg)
          if straddles else x)
    out, aux = _moe_mlp_grouped(cfg, p, xg.reshape(-1, Tg, D_), tp,
                                per_group=straddles)
    if _split(tp):
        out = tp.partial_sum(out, x.dtype)
    n_groups = sum(rows) * S_ // Tg
    if straddles:
        out = out.reshape(hi - lo, D_)[a - lo:b - lo]
        # each group's term weighted by the share of its tokens held here
        starts = torch.arange(lo, hi, Tg, dtype=aux.dtype, device=aux.device)
        held = ((starts + Tg).clamp(max=b) - starts.clamp(min=a)) / Tg
        aux = cfg.moe.n_experts * (aux * held).sum() / n_groups
    elif split is not None:
        # the mean over this rank's whole groups, as a share of the
        # global mean
        aux = aux / (n_groups / (B_ * S_ // Tg))
    return out.reshape(B_, S_, D_), aux


def _group_tokens(n_tokens: int, seq: int) -> int:
    """Tokens a dispatch group of a batch of ``n_tokens`` tokens in rows of
    ``seq`` holds: ``MOE_GROUP_TOKENS`` when they divide into it, else
    one row."""
    return MOE_GROUP_TOKENS if n_tokens % MOE_GROUP_TOKENS == 0 else seq


def edge_transfers(split, seq: int, group_tokens: int):
    """The token ranges ``moe_mlp`` moves between the ranks of ``split``
    so that every rank holds every group it has a token of, whole:
    ``(src, dst, lo, hi)``, rank ``src``'s global tokens ``[lo, hi)`` of
    the groups that cross rank ``dst``'s edges, in one order on every
    rank. Only ranks whose groups straddle send or receive; a rank that
    holds at least one whole group gets at most ``group_tokens - 1``
    tokens on each side."""
    ends = [seq * split.first_row(r) for r in range(len(split.rows) + 1)]
    out = []
    for dst in range(len(split.rows)):
        a, b = ends[dst], ends[dst + 1]
        if a == b:
            continue
        lo = a - a % group_tokens
        hi = -(-b // group_tokens) * group_tokens
        for src in range(len(split.rows)):
            s_lo, s_hi = max(ends[src], lo), min(ends[src + 1], hi)
            if src != dst and s_lo < s_hi:
                out.append((src, dst, s_lo, s_hi))
    return out


class _GroupEdges(torch.autograd.Function):
    """``x`` (n, D), this rank's tokens of a split batch, -> the tokens of
    every dispatch group it has a token of, in global order: the other
    ranks' tokens of its edge groups come by point-to-point transfers
    over the update group (``tensor_parallel.exchange``), and only those.
    The backward is the conjugate: the gradient of each token received is
    sent back to its owner, which adds it to its own, in f32 and rounded
    once. Transfers are point to point, so a rank whose groups are all
    whole takes no part. The ranks that do call this once a moe layer in
    the forward and once in the backward (and again in a remat's rerun),
    layer after layer in one order on every rank, so each pair of ranks
    posts its transfers to each other in one order."""

    @staticmethod
    def forward(ctx, x, split, seq, group_tokens):
        me = split.index
        a = seq * split.first_row()
        lo = a - a % group_tokens
        hi = -(-(a + x.shape[0]) // group_tokens) * group_tokens
        moves = edge_transfers(split, seq, group_tokens)
        ext = x.new_empty((hi - lo, x.shape[1]))
        ext[a - lo:a - lo + x.shape[0]] = x
        exchange([(x[s - a:e - a], dst) for src, dst, s, e in moves
                  if src == me],
                 [(ext[s - lo:e - lo], src) for src, dst, s, e in moves
                  if dst == me], split.group)
        ctx.split, ctx.moves, ctx.a, ctx.lo = split, moves, a, lo
        ctx.n = x.shape[0]
        return ext

    @staticmethod
    def backward(ctx, g):
        me, a, lo, n = ctx.split.index, ctx.a, ctx.lo, ctx.n
        sent = [(dst, s, e) for src, dst, s, e in ctx.moves if src == me]
        back = [g.new_empty((e - s, g.shape[1])) for _, s, e in sent]
        exchange([(g[s - lo:e - lo], src) for src, dst, s, e in ctx.moves
                  if dst == me],
                 [(buf, dst) for buf, (dst, _, _) in zip(back, sent)],
                 ctx.split.group)
        gx = g[a - lo:a - lo + n]
        if back:
            gx = gx.float()
            for buf, (_, s, e) in zip(back, sent):
                gx[s - a:e - a] += buf.float()
            gx = gx.to(g.dtype)
        return gx, None, None, None


def _top_k(probs, k: int):
    """``lax.top_k`` over the last axis: the k largest, ties to the lower
    index (a stable descending sort; ``torch.topk`` promises no order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(cfg: ModelConfig, p, x, per_group: bool = False):
    """Shared router: top-k gates + capacity slots + aux loss.

    Returns (gate_vals (G,T,K) f32, gate_idx (G,T,K) int64, slot (G,T,K)
    int64, in_cap (G,T,K) bool, C, aux): ``aux`` is ``E`` times the mean
    over the groups of each group's ``sum_e(frac_tokens_e *
    mean_prob_e)``; with ``per_group``, those (G,) terms themselves."""
    m = cfg.moe
    G, T, D = x.shape
    E, K = m.n_experts, m.top_k
    C = _capacity(T, E, K, m.capacity_factor)

    router_logits = x @ p["router"]                          # (G,T,E)
    probs = torch.softmax(router_logits.float(), dim=-1)

    gate_vals, gate_idx = _top_k(probs, K)                   # (G,T,K)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # Load-balance aux loss (computed on full probs + hard assignment).
    assign1 = F.one_hot(gate_idx[..., 0], E).float()         # top-1 choice
    frac_tokens = assign1.mean(dim=1)                        # (G,E)
    mean_probs = probs.mean(dim=1)                           # (G,E)
    if per_group:
        aux = (frac_tokens * mean_probs).sum(dim=-1)         # (G,)
    else:
        aux = E * (frac_tokens * mean_probs).sum(dim=-1).mean()

    # Capacity slots: for the k-th choice of token t in expert e, its slot is
    # the running count of earlier tokens that chose e (across all k ranks).
    sel = F.one_hot(gate_idx, E).to(torch.int32)             # (G,T,K,E)
    flat = sel.reshape(G, T * K, E)
    pos_in_e = (torch.cumsum(flat, dim=1) - flat).reshape(G, T, K, E)
    slot = torch.gather(pos_in_e, 3, gate_idx[..., None])[..., 0].long()
    in_cap = slot < C
    return gate_vals, gate_idx, slot, in_cap, C, aux


def _moe_mlp_grouped(cfg: ModelConfig, p, x, tp=None, per_group=False):
    if cfg.moe_dispatch == "scatter":
        return _moe_mlp_grouped_scatter(cfg, p, x, tp, per_group)
    return _moe_mlp_grouped_onehot(cfg, p, x, tp, per_group)


def _split(tp) -> bool:
    """Whether the expert layer's output is a partial sum over the ranks
    (computed in f32, then summed and rounded once)."""
    return tp is not None and tp.moe_split


def _local_experts(cfg: ModelConfig, tp):
    """(first global expert, expert count) of the rank's expert weights:
    all of them without tp."""
    if tp is None:
        return 0, cfg.moe.n_experts
    return tp.expert_offset, tp.experts_local


def _experts(p, xe, dtype, tp=None):
    """The expert SwiGLU on capacity buffers: (G,E,C,D) -> (G,E,C,D);
    in f32 where ``w_down``'s contraction is the rank's ``d_ff_expert``
    slice (a partial sum)."""
    gate = torch.einsum("gecd,edf->gecf", xe, p["w_gate"])
    up = torch.einsum("gecd,edf->gecf", xe, p["w_up"])
    act = F.silu(gate.float()).to(dtype) * up
    if tp is not None and tp.expert_mlp_split:
        return torch.einsum("gecf,efd->gecd", act.float(),
                            p["w_down"].float())
    return torch.einsum("gecf,efd->gecd", act, p["w_down"])


def _moe_mlp_grouped_scatter(cfg: ModelConfig, p, x, tp=None,
                             per_group=False):
    """x: (G, T, D) grouped tokens -> (out (G,T,D), aux_loss scalar, or
    each group's aux term (G,) with ``per_group``: ``_route``'s).

    Scatter/gather dispatch: tokens are added into their (expert,
    capacity-slot) buffers and gathered back by flat slot index; dropped
    tokens write a clamped slot with zero contribution (masked on both
    sides). The same semantics as the one-hot dispatch at no dispatch
    products. Under ``tp`` the buffers are the rank's experts' and the
    other experts' tokens are masked as dropped ones are (the caller sums
    the ranks' partial outputs)."""
    G, T, D = x.shape
    e0, E = _local_experts(cfg, tp)
    gate_vals, gate_idx, slot, in_cap, C, aux = _route(cfg, p, x,
                                                        per_group)
    if tp is not None:
        in_cap = in_cap & (gate_idx >= e0) & (gate_idx < e0 + E)
        gate_idx = (gate_idx - e0).clamp(0, E - 1)

    f_idx = gate_idx * C + torch.clamp(slot, max=C - 1)      # (G,T,K)
    contrib = x[:, :, None, :] * in_cap[..., None].to(x.dtype)  # (G,T,K,D)
    xe_flat = torch.zeros((G, E * C, D), dtype=x.dtype, device=x.device)
    gi = torch.arange(G, device=x.device)[:, None, None]
    xe_flat = xe_flat.index_put((gi, f_idx), contrib, accumulate=True)
    ye = _experts(p, xe_flat.reshape(G, E, C, D), x.dtype, tp)

    y_tok = ye.reshape(G, E * C, D)[gi, f_idx]               # (G,T,K,D)
    w = (gate_vals * in_cap).to(x.dtype)                     # (G,T,K)
    if _split(tp):
        w, y_tok = w.float(), y_tok.float()
    out = torch.einsum("gtk,gtkd->gtd", w, y_tok)
    return out, aux.float()


def _moe_mlp_grouped_onehot(cfg: ModelConfig, p, x, tp=None,
                            per_group=False):
    """GShard einsum formulation with a fused flat-slot one-hot (the JAX
    package's default dispatch and its numeric oracle); returns what the
    scatter dispatch returns. The one-hot is
    built in the model dtype by a scatter (``F.one_hot`` would be int64,
    four times its size). Under ``tp`` the rank keeps its experts'
    columns of the combine (the caller sums the ranks' partial
    outputs)."""
    m = cfg.moe
    G, T, D = x.shape
    E, K = m.n_experts, m.top_k
    gate_vals, gate_idx, slot, in_cap, C, aux = _route(cfg, p, x,
                                                        per_group)

    f_idx = gate_idx * C + torch.clamp(slot, max=C - 1)      # (G,T,K)
    z_oh = torch.zeros((G, T, K, E * C), dtype=x.dtype, device=x.device)
    z_oh.scatter_(3, f_idx[..., None], in_cap[..., None].to(x.dtype))
    combine = torch.einsum("gtk,gtkz->gtz", gate_vals.to(x.dtype),
                           z_oh).reshape(G, T, E, C)
    del z_oh
    if tp is not None:
        e0, El = _local_experts(cfg, tp)
        combine = combine[:, :, e0:e0 + El]
    dispatch = (combine > 0).to(x.dtype)

    xe = torch.einsum("gtec,gtd->gecd", dispatch, x)         # (G,E,C,D)
    ye = _experts(p, xe, x.dtype, tp)                        # (G,E,C,D)
    if _split(tp):
        combine, ye = combine.float(), ye.float()
    out = torch.einsum("gtec,gecd->gtd", combine, ye)
    return out, aux.float()


def moe_mlp_dense(cfg: ModelConfig, p, x, tp=None):
    """Exact (drop-free) top-k combine: every expert runs on every token
    and the one-hot gate selects. Used at decode, where token counts are
    tiny: it costs E/top_k redundant products but never drops a live
    generation token. Under ``tp`` the rank runs its experts on its
    columns of the combine, and one all-reduce sums the ranks.

    x: (B, T, D) -> (out, aux)."""
    m = cfg.moe
    router_logits = x @ p["router"]
    probs = torch.softmax(router_logits.float(), dim=-1)
    gate_vals, gate_idx = _top_k(probs, m.top_k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    combine = torch.einsum("btk,btke->bte", gate_vals,
                           F.one_hot(gate_idx, m.n_experts).float())
    e0, E = _local_experts(cfg, tp)
    combine = combine[..., e0:e0 + E]
    # every expert on every token: (E, B*T, F) products that broadcast the
    # tokens over the stacked expert weights (an einsum over "btd,edf"
    # would copy each weight into a (D, E*F) layout on every call)
    B, T, D = x.shape
    xt = x.reshape(1, B * T, D)
    gate = torch.matmul(xt, p["w_gate"])                     # (E,BT,F)
    up = torch.matmul(xt, p["w_up"])
    act = F.silu(gate.float()).to(x.dtype) * up
    combine = combine.reshape(B * T, -1).to(x.dtype)
    if _split(tp):
        # the rank's partial sum in f32, summed and rounded once
        w_down = p["w_down"]
        ye = (torch.matmul(act.float(), w_down.float())
              if tp.expert_mlp_split else torch.matmul(act, w_down))
        out = tp.partial_sum(torch.einsum("ne,end->nd", combine.float(),
                                          ye.float()), x.dtype)
    else:
        ye = torch.matmul(act, p["w_down"])                  # (E,BT,D)
        out = torch.einsum("ne,end->nd", combine, ye)
    return (out.reshape(B, T, D),
            torch.zeros((), dtype=torch.float32, device=x.device))


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

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
    for k, d in moe_mlp_defs(cfg, layers=n).items():
        defs[f"moe.{k}"] = d
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


def _attn_kw(cfg: ModelConfig, attn_impl: str, tp=None):
    H, KV = _heads(cfg, tp)
    return dict(n_heads=H, n_kv_heads=KV, head_dim=cfg.head_dim_,
                rope_theta=cfg.rope_theta, window=cfg.sliding_window,
                attn_impl=attn_impl, tp=tp)


def _block_apply(cfg: ModelConfig, p, x, *, attn_impl: str = "xla",
                 split=None):
    h = L.rms_norm(x, p["ln1"], cfg.rms_eps)
    x = x + L.self_attention(p["attn"], h, **_attn_kw(cfg, attn_impl))
    h = L.rms_norm(x, p["ln2"], cfg.rms_eps)
    out, aux = moe_mlp(cfg, p["moe"], h, split=split)
    return x + out, aux




def forward(cfg: ModelConfig, params, tokens, *, extra=None,
            attn_impl: str = "xla", split=None):
    """Full-sequence forward -> ``(logits (B,S,V), {"aux_loss": ...})``,
    the aux loss ``mean over layers * router_aux_weight``. attn_impl:
    "xla" or "flash" (the flash-attention kernels). With ``cfg.remat ==
    "full"`` and grad enabled, each layer keeps only its input for the
    backward and runs again inside it (routing and dispatch included).
    ``split``: ``moe_mlp``'s (``tokens`` are one rank's rows of a batch
    split over a data-parallel update's ranks, whose straddling dispatch
    groups move between the ranks in every layer, and again in a remat's
    rerun)."""
    del extra
    x = L.embed(params["embedding"], tokens)
    auxes = []
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        if cfg.remat == "full" and torch.is_grad_enabled():
            x, aux = checkpoint(_block_apply, cfg, lp, x, attn_impl=attn_impl,
                                split=split, use_reentrant=False)
        else:
            x, aux = _block_apply(cfg, lp, x, attn_impl=attn_impl,
                                  split=split)
        auxes.append(aux)
    aux_loss = torch.stack(auxes).mean() * cfg.moe.router_aux_weight
    return _chunk_logits(cfg, params, x), {"aux_loss": aux_loss}


class MoECache(NamedTuple):
    """``kv.k``/``kv.v``: ``(n_layers, B, s_max, KV, hd)`` ring buffers
    (``layers.decode_attention``)."""
    kv: L.KVEntry
    pos: torch.Tensor           # (B,) int32 per-row cache fill


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               dtype=torch.bfloat16, *, device=None, tp=None):
    """A zeroed dense KV ring: ``s_max`` slots, ``min(s_max, window)``
    for a sliding-window config; the rank's kv heads under ``tp``."""
    if cfg.sliding_window > 0:
        s_max = min(s_max, cfg.sliding_window)
    shape = (cfg.n_layers, batch, s_max, _heads(cfg, tp)[1], cfg.head_dim_)
    return MoECache(
        kv=L.KVEntry(torch.zeros(shape, dtype=dtype, device=device),
                     torch.zeros(shape, dtype=dtype, device=device)),
        pos=torch.zeros((batch,), dtype=torch.int32, device=device))


def prefill(cfg: ModelConfig, params, tokens, cache: MoECache, *,
            extra=None, attn_impl: str = "xla", tp=None):
    """Run the prompt (B, S) into the cache (KV written in place; the MoE
    layers dispatch with capacity). Returns ``(logits of the last
    position (B, V), cache)``. attn_impl: "xla" or "flash"."""
    del extra
    x = L.embed(params["embedding"], tokens, tp)
    akw = _attn_kw(cfg, attn_impl, tp)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        h = L.rms_norm(x, lp["ln1"], cfg.rms_eps)
        x = x + L.prefill_attention(lp["attn"], h, cache.kv.layer(i),
                                    **akw)[0]
        h = L.rms_norm(x, lp["ln2"], cfg.rms_eps)
        x = x + moe_mlp(cfg, lp["moe"], h, tp)[0]
    B, S = tokens.shape
    return _chunk_logits(cfg, params, x[:, -1:], tp)[:, 0], cache._replace(
        pos=torch.full((B,), S, dtype=torch.int32, device=tokens.device))


def decode_step(cfg: ModelConfig, params, token, cache: MoECache, *,
                extra=None, attn_impl: str = "xla", advance=None,
                layers=None, tp=None):
    """One decode step. token: (B,) int. Rows with ``advance=False`` write
    nothing and keep their position. The MoE layers run the drop-free
    ``moe_mlp_dense``. attn_impl: "xla" or "pallas" (the split-K decode
    kernel). ``layers``: the per-layer param views, when the caller has
    already sliced them."""
    del extra
    B = token.shape[0]
    adv = (torch.ones((B,), dtype=torch.bool, device=token.device)
           if advance is None else advance)
    if layers is None:
        layers = [layer_params(params, i) for i in range(cfg.n_layers)]
    akw = dict(_attn_kw(cfg, attn_impl, tp), advance=adv)
    x = L.embed(params["embedding"], token[:, None], tp)     # (B,1,D)
    for i, lp in enumerate(layers):
        h = L.rms_norm(x, lp["ln1"], cfg.rms_eps)
        x = x + L.decode_attention(lp["attn"], h, cache.kv.layer(i),
                                   cache.pos, **akw)[0]
        h = L.rms_norm(x, lp["ln2"], cfg.rms_eps)
        x = x + moe_mlp_dense(cfg, lp["moe"], h, tp)[0]
    return _chunk_logits(cfg, params, x, tp)[:, 0], MoECache(
        kv=cache.kv, pos=cache.pos + adv.to(torch.int32))


def decode_scan_body(cfg: ModelConfig, params, *, attn_impl: str = "xla",
                     tp=None):
    """Decode body for in-loop generation: ``decode_step`` wrapped by
    ``transformer.scan_body_over``, as JAX's ``Model`` wraps families
    without a native body (per-layer param views sliced once here)."""
    layers = [layer_params(params, i) for i in range(cfg.n_layers)]
    return scan_body_over(
        lambda token, advance, cache: decode_step(
            cfg, params, token, cache, attn_impl=attn_impl, advance=advance,
            layers=layers, tp=tp))
