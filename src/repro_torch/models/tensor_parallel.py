"""Tensor parallelism of the rollout of the dense, moe, ssm and hybrid
families (port-only; the JAX package gets it from GSPMD under the
engine's mesh shardings).

A ``TPContext`` is one rank's view of a ``core.resharding.TPPlan``: the
model-axis process group, the tp size and this rank's index, its local
head, kv-head, MLP, expert, SSM-head and vocab counts, and its expert
and vocab offsets. The model's
functions take it as ``tp=`` (None: one rank, no collective):

  - attention runs its kernel on the rank's heads; the o-proj's partial
    sums are all-reduced when attention is split (none when replicated);
    replicated attention over a long sequence splits its queries instead
    (``layers.seq_parallel``): each rank's rows, then one all-gather of
    the rows before the o-proj (``gather_seq``);
  - the MLP all-reduces after ``w_down`` when ``d_ff`` is split;
  - a partial sum is computed in f32 and rounded once after the
    all-reduce (``row_parallel``), so a bf16 rank adds no rounding that
    the one-rank product does not make;
  - the embedding is vocab-parallel: rows outside the shard read zero,
    then one all-reduce (exact: the other ranks add zeros);
  - the moe layer runs the rank's experts (whole experts, or each
    expert's ``d_ff_expert`` slice) on a router every rank computes whole,
    so every rank routes, and drops, the same tokens; one all-reduce after
    the combine;
  - the Mamba mixer runs the rank's SSM heads: the gated RMSNorm over the
    whole ``d_inner`` all-reduces its f32 sum of squares, and
    ``out_proj``'s partial sums are all-reduced;
  - the head is vocab-parallel: logits stay ``(B, vocab_local)`` on each
    rank, and sampling and token log-probs combine per-row partials
    (a MAX, a MIN and a SUM all-reduce of a few numbers a row) instead
    of gathering the row.

Plain functions on tensors with no autograd: nothing on the tp path takes
a gradient. The update does not split heads: as GSPMD runs JAX's
``UpdateStage``, it runs whole on every rank of a model-axis row, its
batch rows split over the data rows (``update_group``).
Every collective here is called by every rank of the group in the same
order: the rollout's control flow is replicated, and the values the
collectives return are the same on every rank. bf16 sums are all-reduced
in f32 and rounded once.

On a mesh of several data rows (dp or pods above 1) each row is a tp
group of its own (``model_group``); ``data_group`` joins the ranks of one
model index across the rows, over which the data-parallel rollout
exchanges its turn's counters and its harvest. ``update_group`` joins
the same ranks in groups of their own, over which the update sums its
gradients.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

_GROUPS: Dict[Tuple, object] = {}
_GROUPS_WORLD = None      # the default group the cached groups belong to


def _group_of(lines, tag: str = ""):
    """This rank's group among ``lines`` (lists of ranks), making every
    line's group the first time its ranks are asked for: ``dist.new_group``
    is collective over the default group, so every rank asks for the same
    lines in the same order. The groups are cached by ``tag`` and their
    ranks for the default group that made them: a new default group (a
    world started after ``destroy_process_group``) starts a new cache, so
    it never gets the groups of a destroyed world. None when this rank is
    in no line."""
    global _GROUPS_WORLD
    world = dist.group.WORLD
    if world is not _GROUPS_WORLD:
        _GROUPS.clear()
        _GROUPS_WORLD = world
    me = dist.get_rank()
    mine = None
    for line in lines:
        ranks = [int(r) for r in line]
        key = (tag, *ranks)
        if key not in _GROUPS:
            _GROUPS[key] = dist.new_group(ranks)
        if me in ranks:
            mine = _GROUPS[key]
    return mine


def model_group(mesh_cfg):
    """This rank's model-axis process group of ``mesh_cfg`` (None outside
    the mesh): one group per data row (each (pod, data) coordinate), its
    ``tp`` ranks. Collective, as ``_group_of`` says: every rank calls this
    for the same meshes in the same order."""
    if mesh_cfg.tp == 1 or not dist.is_initialized():
        return None
    return _group_of(mesh_cfg.ranks().reshape(-1, mesh_cfg.tp).tolist())


def data_group(mesh_cfg):
    """This rank's data-axis process group of ``mesh_cfg`` (None outside
    the mesh, or with one data row): the ranks of every data row (each
    (pod, data) coordinate) that share this rank's model index, one
    group per model index. The data-parallel rollout's exchanges run over
    it. Collective, as ``model_group``."""
    if mesh_cfg.pods * mesh_cfg.dp == 1 or not dist.is_initialized():
        return None
    return _group_of(mesh_cfg.ranks().reshape(-1, mesh_cfg.tp).T.tolist())


def update_group(mesh_cfg):
    """This rank's group for the update's sums over the data rows of
    ``mesh_cfg``: the ranks of ``data_group``'s, in groups of their own,
    because the async schedule's worker thread sums over them while the
    main thread's rollout may call ``data_group``'s (gloo collectives
    from two threads on one group can interleave). None outside the mesh
    or with one data row. Collective, as ``model_group``: make it on the
    main thread."""
    if mesh_cfg.pods * mesh_cfg.dp == 1 or not dist.is_initialized():
        return None
    return _group_of(mesh_cfg.ranks().reshape(-1, mesh_cfg.tp).T.tolist(),
                     "update")


class UpdateSplit(NamedTuple):
    """What a model's forward is told of a data-parallel update whose
    batch rows are split over ``group`` (``update_group``'s): ``index``,
    this rank's place in the group, which is also its block of the global
    batch's rows (the group's ranks are its data rows in (pod, data)
    order, as ``launch.mesh._batch_spec`` lays the rows), and ``rows``,
    the rows every rank holds, in that order. A microbatch slice of the
    global batch can give a rank fewer rows than another, or none."""
    group: object
    index: int
    rows: Tuple[int, ...]

    def first_row(self, index: Optional[int] = None) -> int:
        """The global row of rank ``index``'s first row (this rank's by
        default)."""
        return sum(self.rows[:self.index if index is None else index])


def update_split(group, rows: int) -> Optional[UpdateSplit]:
    """The ``UpdateSplit`` of a batch of which every rank of ``group``
    holds ``rows`` rows (the update's ``_batch_spec`` layouts split only
    where the rows divide); None without a group (one rank)."""
    if group is None:
        return None
    return UpdateSplit(group, dist.get_rank(group),
                       (rows,) * dist.get_world_size(group))


def exchange(sends, recvs, group) -> None:
    """One round of point-to-point transfers over ``group``, posted
    together: ``sends`` and ``recvs`` are ``(tensor, peer)`` pairs, the
    peer a rank's index in the group, each received tensor a contiguous
    buffer that is filled in place. Each pair of ranks must post its
    transfers to each other in the same order. Gloo moves host memory:
    under it a device tensor goes through a host copy."""
    if not sends and not recvs:
        return
    staged = lambda t: (t.device.type != "cpu"
                        and dist.get_backend(group) == "gloo")
    ops, copies = [], []
    for t, peer in sends:
        t = t.contiguous()
        ops.append(dist.P2POp(dist.isend, t.cpu() if staged(t) else t,
                              dist.get_global_rank(group, peer), group))
    for buf, peer in recvs:
        host = torch.empty(buf.shape, dtype=buf.dtype) if staged(buf) \
            else buf
        ops.append(dist.P2POp(dist.irecv, host,
                              dist.get_global_rank(group, peer), group))
        if host is not buf:
            copies.append((buf, host))
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    for buf, host in copies:
        buf.copy_(host)


class TPContext:
    """One rank's tensor-parallel view of ``plan`` over ``group`` (the
    plan's model-axis group; ``model_group`` by default)."""

    def __init__(self, plan, group=None):
        if plan.index is None:
            raise ValueError(f"rank {plan.rank} lies outside mesh "
                             f"{plan.mesh_config.name!r}: it has no tp "
                             f"context")
        self.plan = plan
        self.group = group if group is not None else model_group(
            plan.mesh_config)
        self.size = plan.tp
        self.index = plan.index
        self.n_heads = plan.heads_local
        self.n_kv_heads = plan.kv_local
        self.attn_split = plan.attn == "split"
        self.mlp_split = plan.mlp_split
        self.vocab_split = plan.vocab_split
        self.vocab_size = plan.vocab_size
        self.vocab_local = plan.vocab_local
        self.vocab_offset = plan.vocab_offset()
        # moe: the rank's experts (all of them, each on its d_ff_expert
        # slice, under experts="mlp"), from global expert expert_offset
        self.moe_split = plan.experts != "replicated"
        self.expert_mlp_split = plan.experts == "mlp"
        self.experts_local = plan.experts_local
        self.expert_offset = plan.expert_offset()
        # ssm: the rank's SSM heads and the B/C groups they read
        self.ssm_split = plan.ssm_split
        self.ssm_heads = plan.ssm_heads_local
        self.ssm_groups = plan.ssm_groups_local
        self.d_inner = plan.ssm_heads * plan.ssm_head_dim

    # -- collectives -------------------------------------------------------
    def all_reduce(self, x, op: str = "sum"):
        """All-reduce ``x`` over the model axis (``op`` "sum", "max" or
        "min"); bf16 and f16 sums in f32, rounded once. Returns a new
        tensor (or ``x`` itself at tp=1)."""
        if self.size == 1:
            return x
        low = x.dtype in (torch.bfloat16, torch.float16)
        y = x.float() if low else x.clone()
        y = y.contiguous()
        dist.all_reduce(y, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX,
                               "min": dist.ReduceOp.MIN}[op],
                        group=self.group)
        return y.to(x.dtype) if low else y

    def all_reduce_sum(self, x):
        return self.all_reduce(x, "sum")

    def gather_seq(self, x, dim: int = 1):
        """The whole sequence from every rank's contiguous slice ``x`` of
        it along ``dim`` (all slices one length, rank order): one
        all-gather over the model axis. Exact: it moves values, adds
        none."""
        if self.size == 1:
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim=dim)

    def row_parallel(self, x, w, split: bool):
        """``x @ w`` (the o-proj, ``w_down``, ``out_proj``), whose
        contraction dim is the rank's slice when ``split``: the rank's
        partial product in f32 (products of bf16 values are exact in f32,
        as in a bf16 matmul's f32 accumulation), summed over the ranks and
        rounded once to ``x``'s dtype, as the one-rank product is rounded
        once. The plain product when not split."""
        if not split:
            return x @ w
        return self.partial_sum(x.float() @ w.float(), x.dtype)

    def partial_sum(self, y, dtype):
        """The ranks' partial sums ``y`` (f32) summed and rounded once to
        ``dtype``."""
        return self.all_reduce_sum(y).to(dtype)

    def rms_norm(self, x, w, eps: float):
        """``layers.rms_norm`` of a row split over the ranks (the gated
        norm over the whole ``d_inner``): the f32 sum of squares of the
        rank's columns is all-reduced before the scale, so every rank
        normalises by the whole row; ``w`` is the rank's slice."""
        if not self.ssm_split:
            from repro_torch.models.layers import rms_norm
            return rms_norm(x, w, eps)
        xf = x.float()
        ss = self.all_reduce_sum(xf.square().sum(dim=-1, keepdim=True))
        out = xf * torch.rsqrt(ss / self.d_inner + eps)
        return (out * w.float()).to(x.dtype)

    # -- vocab-parallel embedding and head ----------------------------------
    def embed(self, emb, tokens):
        """Rows of the rank's vocab shard ``emb`` (Vl, D) for global token
        ids; ids outside the shard read zero, and the all-reduce adds the
        owner's row to the others' zeros."""
        if not self.vocab_split:
            return emb[tokens]
        local = tokens.long() - self.vocab_offset
        mine = (local >= 0) & (local < self.vocab_local)
        x = emb[local.clamp(0, self.vocab_local - 1)]
        return self.all_reduce_sum(torch.where(mine[..., None], x,
                                               torch.zeros_like(x)))

    def _owned(self, tok):
        local = tok.long() - self.vocab_offset
        mine = (local >= 0) & (local < self.vocab_local)
        return local.clamp(0, self.vocab_local - 1), mine

    def token_logprob(self, logits, tok):
        """(B, Vl) local logits + (B,) global ids -> (B,) f32 ``lg[tok] -
        logsumexp(lg)`` over the whole row: a MAX all-reduce of the row
        max, then one SUM all-reduce of the rescaled sums and of the
        token's logit from its owner (``rl.algo.token_logprobs``'
        arithmetic, whose max is the global one)."""
        lg = logits.float()
        if not self.vocab_split:
            from repro_torch.rl.algo import token_logprobs
            return token_logprobs(lg[:, None, :], tok[:, None])[:, 0]
        m = self.all_reduce(lg.amax(dim=-1), "max")
        local, mine = self._owned(tok)
        t = torch.where(mine, lg.gather(-1, local[:, None])[:, 0] - m, 0.0)
        s = torch.exp(lg - m[:, None]).sum(dim=-1)
        red = self.all_reduce_sum(torch.stack([s, t], dim=1))
        return red[:, 1] - torch.log(red[:, 0])

    def gather_row(self, x):
        """The whole (B, V) row on every rank, exactly: the shard in a
        zero-padded buffer, all-reduced (adding zeros is exact)."""
        if not self.vocab_split:
            return x
        full = x.new_zeros((x.shape[0], self.vocab_size))
        full[:, self.vocab_offset:self.vocab_offset + self.vocab_local] = x
        return self.all_reduce_sum(full)

    def shard_row(self, x):
        """This rank's columns of a (B, V) tensor (a noise draw)."""
        if not self.vocab_split or x is None:
            return x
        lo = self.vocab_offset
        return x[:, lo:lo + self.vocab_local].contiguous()

    def sample_combine(self, m, l, bs, bi, bl):
        """The fused sampler's per-rank partials -> ``(tokens, logprobs)``
        of the whole row (``fused_sample.ops.combine_partials`` over this
        group's all-reduces)."""
        from repro_torch.kernels.fused_sample.ops import combine_partials
        return combine_partials(m, l, bs, bi, bl, self.vocab_offset,
                                self.all_reduce)


def ssm_heads(cfg, tp: Optional[TPContext]):
    """The (SSM heads, B/C groups) a rank runs: the config's without
    tp."""
    if tp is None:
        return cfg.ssm.n_heads, cfg.ssm.n_groups
    return tp.ssm_heads, tp.ssm_groups


def heads(cfg, tp: Optional[TPContext]):
    """The (q heads, kv heads) a rank runs: the config's without tp."""
    if tp is None:
        return cfg.n_heads, cfg.n_kv_heads
    return tp.n_heads, tp.n_kv_heads
