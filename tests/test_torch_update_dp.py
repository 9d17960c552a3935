"""The update across ranks: the port's policy-gradient step data-parallel
over the update stage's mesh (``core/train_step.py``'s ``group``,
``EarlTrainer.update_mesh``/``place_state``, the async schedule's update
on every update rank), on the CPU over gloo ranks (one process a rank,
``test_torch_dispatcher.run_gloo``), at fp32:

- the update step alone over a gloo world of 2 (the batch's rows split
  over data) against JAX's jitted ``UpdateStage`` on the same params and
  batch, the batch on ``P("data")`` of host devices 2-3 (one subprocess
  with eight host devices), for the smoke qwen2 (B=4, T=96) and the smoke
  granite-moe at B=4, S=256 (two 512-token dispatch groups, one a rank):
  the loss and every metric within 1e-5 of JAX's and of the port's
  one-rank step (after the second step within 1e-5 of their size: the
  first step's sign flips below set the params apart by up to 2 lr, in
  the port's one-rank run as in its two-rank one), the summed gradients
  within 1e-5 of each leaf's largest |g|, and the params and both moments
  after two steps within 1e-5 elementwise of the port's one-rank run's,
  except where that run's |g| at a step is below 1e-5 of its leaf's
  largest: there AdamW's first step maps a gradient of rounding size to
  +-lr, and a sign that the summation order flips moves the element by up
  to 2 lr, which is allowed there. Against JAX's the same rule holds once
  each element's bound is widened by the port's own one-rank distance
  from JAX there (at the moe's second step a few elements of the port's
  one-rank run lie 1.1e-5 from JAX's outside the exemption: the step
  starts from params that the first step's flips set apart). The same
  rule holds the layouts whose moe dispatch groups straddle the ranks:
  the smoke granite-moe at B=6, S=256 (three 512-token groups, the middle
  one cut by the ranks' edge) with ``remat`` "none" and "full", against
  JAX's two-device step, and at B=4, S=128 on a world of 4 (one group
  over four ranks of 128 tokens) against JAX's four-device step; a
  batch of one row a rank (one group, half on each rank) against the
  port's one-rank step;
- ``make_lm_train_step(microbatch=3)`` at B=6, S=256 on two ranks, whose
  middle 2-row slice (and, for the moe, its one group) straddles them,
  against JAX's jitted step with the batch on ``P("data")`` of two
  devices and against the port's one-rank step, two steps each;
- the SPMD trainer against the port's one-rank trainer (records: returns,
  context and turn lengths and lags equal, loss and KL within 1e-5; the
  final params and moments under the rule above, the exemption read from
  the one-rank run's gradients), two steps each: sync and async lag 1 at
  ``rollout_trainer_split(n_devices=4)`` (the update at dp=2 on ranks
  2-3); an update mesh of dp=3 at B=4 (the rows do not divide:
  replicated) on a world of 3; a 1x2 update mesh (replicated over the
  model axis) on ranks 2-3 of a world of 4; the async split restarted
  from its checkpoint after an update fault at step 1 (the mesh's first
  rank saves, both update ranks restore); and hook ② moving the update
  from ``MeshConfig("u0", 1, 1)`` to ``device_offset=1`` at step 1 on a
  world of 2, sync and async (a switch that runs the update on the new
  rank's meta stand-ins fails with "unsupported device meta" in the flash
  forward, its peer timing out in the metrics broadcast); and the smoke
  granite-moe's trainer (6 episodes, context 256) with its update at dp=2
  on a world of 2, whose handed-off batch's middle group straddles the
  ranks (asserted from the split each rank's forward was given, and the
  ranks' rows, in their order in the update group, are the one-rank
  update's batch);
- ``UpdateSplit.index`` against the rows ``_batch_spec`` gives each rank
  of dp4, pods2 x dp2 and dp2 x tp2 meshes on a world of 4.

In every run each update rank ran every step's update on real params, the
update ranks' final params and moments are bitwise equal, and the ranks
outside the last update mesh hold meta tensors.
"""
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe
from repro_torch.models.registry import build_model
from repro_torch.models.tensor_parallel import UpdateSplit
from repro_torch.rl.envs import TicTacToe

from test_torch_dispatcher import REPO, run_gloo
from test_torch_tp import NOISE_SRC
from test_torch_tp_families import _jax_flat

torch.set_num_threads(1)

LR = 1e-3
STEP = dict(clip_eps=0.2, kl_coef=0.05, is_rho_max=2.0)
MOE = "granite-moe-3b-a800m"
# case -> (arch, B, T, remat, devices) of the update step: its batch, the
# config's remat (None: the smoke config's own) and the data ranks
UPDATES = {"qwen2-0.5b": ("qwen2-0.5b", 4, 96, None, 2),
           MOE: (MOE, 4, 256, None, 2),
           # 1,536 tokens in three 512-token groups: the middle one
           # straddles the two ranks' 768 tokens each
           "moe-straddle": (MOE, 6, 256, "none", 2),
           "moe-straddle-remat": (MOE, 6, 256, "full", 2),
           # one 512-token group over four ranks of 128 tokens
           "moe-dp4": (MOE, 4, 128, None, 4)}
# remat reruns each layer's forward in the backward and moves no value, in
# JAX as in the port: the remat case is held against JAX's run of the case
# without it
JAX_CASE = {"moe-straddle-remat": "moe-straddle"}
# the cases of JAX's two subprocesses, which run side by side: (updates,
# LM steps)
JAX_SPLIT = ((("qwen2-0.5b", MOE), ("qwen2-0.5b",)),
             (("moe-straddle", "moe-dp4"), (MOE,)))
ARCHS = ("qwen2-0.5b", MOE)
# the LM step whose 2-row microbatch slices straddle two ranks' 3 rows
LM_ROWS, LM_SEQ, LM_MICROBATCH = 6, 256, 3
METRICS = ("loss", "pg_loss", "kl", "clip_frac", "is_weight_mean",
           "is_trunc_frac")


def _batch(case):
    """A random ``ExperienceBatch`` as numpy arrays, from a seed."""
    arch, B, T = UPDATES[case][:3]
    V = get_smoke_config(arch).vocab_size
    rs = np.random.RandomState(1)
    gen = rs.rand(B, T) < 0.4
    lp = lambda: np.where(gen, -rs.rand(B, T) * 8 - 4, 0).astype(np.float32)
    rewards = rs.choice([-1.0, 0.0, 1.0], size=B).astype(np.float32)
    return dict(tokens=rs.randint(0, V, (B, T)).astype(np.int32),
                gen_mask=gen, loss_mask=gen, logprobs=lp(),
                ref_logprobs=lp(), rewards=rewards, returns=rewards,
                advantages=(rewards - rewards.mean()).astype(np.float32),
                context_len=np.full((B,), T, np.int32),
                truncated=np.zeros((B,), bool))


def _lm_batch(arch):
    """The straddling LM step's tokens and shifted labels, a few masked,
    from a seed."""
    rs = np.random.RandomState(2)
    V = get_smoke_config(arch).vocab_size
    tokens = rs.randint(0, V, (LM_ROWS, LM_SEQ)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((LM_ROWS, 1), -1)], 1)
    labels[:, :5] = -1
    labels[rs.rand(LM_ROWS, LM_SEQ) < 0.1] = -1
    return dict(tokens=tokens, labels=labels.astype(np.int32))


JAX_CODE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs.base import get_smoke_config
from repro.core.stages import UpdateStage
from repro.core.train_step import make_lm_train_step
from repro.models.registry import build_model
from repro.optim.adamw import adamw
from repro.rl.algo import policy_gradient_loss, token_logprobs
from repro.rl.experience import ExperienceBatch
out_path, tmp, updates, lm_archs, lr, step_kw, microbatch = sys.argv[1], \\
    sys.argv[2], *(eval(a) for a in sys.argv[3:8])
# the two-device programs on devices 2-3, the four-device one on 0-3
meshes = {n: Mesh(np.array(jax.devices()[4 - n:4]).reshape(n, 1),
                  ("data", "model")) for n in (2, 4)}
flat = lambda t: {".".join(k.key for k in path): np.asarray(v) for path, v
                  in jax.tree_util.tree_flatten_with_path(t)[0]}
out = {}
for case, (arch, _, _, _, n) in updates.items():
    model = build_model(get_smoke_config(arch))
    params = model.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    arrs = dict(np.load(f"{tmp}/{case}-batch.npz"))
    batch = ExperienceBatch(**{k: jax.device_put(v, NamedSharding(
        meshes[n], P("data"))) for k, v in arrs.items()})
    ck, kl, rho = step_kw["clip_eps"], step_kw["kl_coef"], \\
        step_kw["is_rho_max"]

    def loss_fn(p):                     # make_rl_train_step's
        logits, aux = model.forward(p, batch.tokens)
        lp = token_logprobs(logits[:, :-1], batch.tokens[:, 1:])
        loss, _ = policy_gradient_loss(
            lp, batch.advantages, batch.loss_mask[:, 1:],
            old_logprobs=batch.logprobs[:, 1:], clip_eps=ck,
            ref_logprobs=batch.ref_logprobs[:, 1:], kl_coef=kl,
            behavior_logprobs=batch.logprobs[:, 1:], is_rho_max=rho)
        return loss + aux.get("aux_loss", 0.0)

    grads = jax.jit(jax.grad(loss_fn))(params)
    opt = adamw(lr, weight_decay=0.0)
    stage = UpdateStage(model, opt, **step_kw)
    state = opt.init(params)
    for step in (1, 2):
        params, state, metrics = stage(params, state, batch)
        for k, v in metrics.items():
            out[f"{case}/m{step}/{k}"] = np.asarray(v)
    leaf = jax.tree.leaves(params)[0]
    out[f"{case}/devices"] = np.array(sorted(
        d.id for d in leaf.sharding.device_set))
    out[f"{case}/spec"] = np.array(repr(leaf.sharding.spec))
    for name, tree in (("grad", grads), ("params", params),
                       ("mu", state.mu), ("nu", state.nu)):
        for k, v in flat(tree).items():
            out[f"{case}/{name}/{k}"] = v
# the LM step with microbatch slices of the global batch on P("data")
for arch in lm_archs:
    model = build_model(get_smoke_config(arch))
    params = model.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    arrs = dict(np.load(f"{tmp}/{arch}-lm.npz"))
    tok, lab = (jax.device_put(arrs[k], NamedSharding(meshes[2], P("data")))
                for k in ("tokens", "labels"))
    opt = adamw(lr, weight_decay=0.0)
    step = jax.jit(make_lm_train_step(model, opt, microbatch=microbatch))
    state = opt.init(params)
    for i in (1, 2):
        params, state, metrics = step(params, state, tok, lab)
        for k, v in metrics.items():
            out[f"lm-{arch}/m{i}/{k}"] = np.asarray(v)
        for k, v in flat(state.mu).items():     # 0.1 g at the first step
            out[f"lm-{arch}/mu{i}/{k}"] = v
    for name, tree in (("params", params), ("mu", state.mu),
                       ("nu", state.nu)):
        for k, v in flat(tree).items():
            out[f"lm-{arch}/{name}/{k}"] = v
np.savez(out_path, **out)
"""

SRC = NOISE_SRC + """
import dataclasses
from repro_torch.models import moe as moe_family
from repro_torch.core.parallelism_selector import (ParallelismSelector,
                                                   ProfileEntry)
from repro_torch.core.resharding import MeshConfig
from repro_torch.optim.adamw import Optimizer, adamw

TRAIN = dict(batch_size=4, max_turns=2, max_turn_tokens=3, max_context=96,
             kl_coef=0.05, temperature=1.0, kv_dtype="fp32", device="cpu")


class Meshes(ParallelismSelector):
    # the rollout on one config and the update on another; hook ② moves
    # the update to ``then`` from step ``at``
    def __init__(self, rollout, update, then=None, at=1):
        super().__init__([rollout], lambda c, ctx: ProfileEntry(c, ctx, 1.0,
                                                                 True))
        self.profile()
        self._current["update"] = update
        self.then, self.at = then, at

    def maybe_switch(self, step=-1, stage="rollout"):
        if stage != "update" or self.then is None or step < self.at \\
                or self._current["update"] == self.then:
            return None
        old, self._current["update"] = self._current["update"], self.then
        return old, self.then


def recording_adamw(log):
    # the repo's AdamW, logging each update's gradients and whether its
    # params were real
    opt = adamw(LR, weight_decay=0.0)

    def update(grads, state, params):
        log.append(({k: v.detach().clone() for k, v in grads.items()},
                    all(not v.is_meta for v in params.values())))
        return opt.update(grads, state, params)
    return Optimizer(init=opt.init, update=update)


def recording_forward(model, seen):
    # log what each forward under autograd (the update's) was given: its
    # rows' tokens and the split (rows a rank, this rank's index)
    fwd = model.forward

    def forward(params, tokens, **kw):
        if torch.is_grad_enabled():
            split = kw.get("split")
            seen.append(dict(tokens=tokens.tolist(), index=(
                0 if split is None else split.index), rows=(
                None if split is None else list(split.rows))))
        return fwd(params, tokens, **kw)
    model.forward = forward
    return model


def trainer_run(params, selector, pipeline, given=0, dst=None, ckpt=None,
                arch="qwen2-0.5b", seen=None, **train):
    # two steps of the trainer on ``params`` (real on rank ``given`` alone
    # across ranks), the batch sent to ``dst``; with ``ckpt`` a checkpoint
    # a step there and an injected update fault at step 1 (a restart);
    # ``arch``'s smoke model, ``train`` over TRAIN, the update's forwards
    # logged to ``seen``; returns the records, the update log and the
    # final state
    from repro_torch.core.stages import EarlTrainer
    from repro_torch.utils.faults import FaultInjector
    log = []
    kw = {} if ckpt is None else dict(
        faults=FaultInjector.parse(["update@1"]), checkpoint_dir=ckpt,
        checkpoint_every=1, max_retries=1, retry_backoff_s=0.0)
    model = build_model(get_smoke_config(arch))
    if model.cfg.family == "moe":
        # f32 KV rings: the family's cache takes no kv_dtype
        model = dataclasses.replace(
            model, _init_cache=lambda cfg, b, s, dtype=None, *,
            device=None: moe_family.init_cache(cfg, b, s, torch.float32,
                                               device=device))
    if seen is not None:
        recording_forward(model, seen)
    tr = EarlTrainer(model=model, env=TicTacToe(), selector=selector,
                     optimizer=recording_adamw(log), noise=step_noise,
                     pipeline=pipeline, max_policy_lag=1,
                     **dict(TRAIN, **train), **kw)
    if RANK != given:
        params = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                  for k, v in params.items()}
    p, o, hist = tr.train(2, params=params,
                          opt_state=tr.optimizer.init(params),
                          ref_params=params, dst_shardings=dst)
    recs = [dict(loss=r.loss, kl=r.kl, ret=r.mean_return,
                 ctx=r.mean_context_len, turn=r.mean_turn_len,
                 lag=r.policy_lag, sw=r.selector_switch,
                 moved=(r.dispatch or {}).get("moved_bytes")) for r in hist]
    state = {}
    if not next(iter(p.values())).is_meta:
        for name, tree in (("params", p), ("mu", o.mu), ("nu", o.nu)):
            state.update({f"{name}/{k}": v.numpy() for k, v in tree.items()})
        for i, (g, _) in enumerate(log):
            state.update({f"grad{i}/{k}": v.numpy() for k, v in g.items()})
    return recs, [real for _, real in log], state
"""
RANK = 0                                # the one-rank runs' rank
exec(SRC)

GLOO_CODE = """
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.core.train_step import (make_lm_train_step,
                                         make_rl_train_step)
from repro_torch.launch.mesh import _batch_spec, rollout_trainer_split
from repro_torch.models.registry import build_model
from repro_torch.models.tensor_parallel import update_group, update_split
from repro_torch.rl.envs import TicTacToe
from repro_torch.rl.experience import ExperienceBatch
LR = ARG["lr"]
""" + SRC + """
tmp = ARG["tmp"]


def save(name, arrays):
    np.savez(f"{tmp}/{name}-r{RANK}.npz", **arrays)


def update_step(case):
    # two data-parallel steps on this rank's rows, and (rank 0) the
    # one-rank run's two steps on all of them
    arch, _, _, remat, _ = ARG["updates"][case]
    cfg = get_smoke_config(arch)
    model = build_model(cfg if remat is None
                        else dataclasses.replace(cfg, remat=remat))
    params = params_from_numpy(dict(np.load(f"{tmp}/{arch}.npz")))
    full = ExperienceBatch(**{k: torch.from_numpy(v) for k, v in
                              np.load(f"{tmp}/{case}-batch.npz").items()})
    half = full.batch // WORLD
    mine = ExperienceBatch(*(x[RANK * half:(RANK + 1) * half]
                             for x in full))
    group = update_group(MeshConfig("dp2", WORLD, 1))
    step = make_rl_train_step(model, adamw(LR, weight_decay=0.0),
                              attn_impl="flash", **ARG["step"])
    out = {}
    for name, batch, g in (("dp", mine, group), ("one", full, None)):
        if name == "one" and RANK:
            break
        p, o = params, adamw(LR, weight_decay=0.0).init(params)
        for i in (1, 2):
            (_, metrics), grads = step.grads_of(p, batch, group=g)
            out.update({f"{name}/grad{i}/{k}": v.numpy()
                        for k, v in grads.items()})
            p, o, m = step(p, o, batch, group=g)
            out.update({f"{name}/m{i}/{k}": float(v) for k, v in m.items()})
        for tree, t in (("params", p), ("mu", o.mu), ("nu", o.nu)):
            out.update({f"{name}/{tree}/{k}": v.numpy()
                        for k, v in t.items()})
    save(f"step-{case}", out)


def cut_step(arch):
    # one row a rank (the moe's two 256-token rows make one 512-token
    # group, half on each rank): the gradients summed over the ranks and
    # the metrics against the one-rank step on both rows
    model = build_model(get_smoke_config(arch))
    params = params_from_numpy(dict(np.load(f"{tmp}/{arch}.npz")))
    full = ExperienceBatch(**{k: torch.from_numpy(v) for k, v in
                              np.load(f"{tmp}/{arch}-batch.npz").items()})
    step = make_rl_train_step(model, adamw(LR, weight_decay=0.0),
                              attn_impl="flash", **ARG["step"])
    group = update_group(MeshConfig("dp2", WORLD, 1))
    (loss, m), g = step.grads_of(params, ExperienceBatch(
        *(x[RANK:RANK + 1] for x in full)), group=group)
    (loss1, m1), g1 = step.grads_of(params, ExperienceBatch(
        *(x[:2] for x in full)))
    return dict(loss=[float(loss), float(loss1)],
                metrics={k: [float(v), float(m1[k])] for k, v in m.items()},
                grad_err=max(float((g[k] - g1[k]).abs().max()
                                   / g1[k].abs().max()) for k in g1))


def lm_straddle(arch):
    # make_lm_train_step with microbatch slices that straddle the ranks,
    # two steps on this rank's rows and (rank 0) on all of them; the
    # gradients each step's optimizer was given (before AdamW's
    # global-norm clip) and its first moment after each step
    model = build_model(get_smoke_config(arch))
    params = params_from_numpy(dict(np.load(f"{tmp}/{arch}.npz")))
    arrs = np.load(f"{tmp}/{arch}-lm.npz")
    tokens, labels = (torch.from_numpy(arrs[k]) for k in ("tokens",
                                                          "labels"))
    h = tokens.shape[0] // WORLD
    group = update_group(MeshConfig("dp2", WORLD, 1))
    out = {}
    for name, rows, gr in (("dp", slice(h * RANK, h * RANK + h), group),
                           ("one", slice(None), None)):
        if name == "one" and RANK:
            break
        log = []
        opt = recording_adamw(log)
        step = make_lm_train_step(model, opt,
                                  microbatch=ARG["lm_microbatch"])
        p, o = params, opt.init(params)
        for i in (1, 2):
            p, o, m = step(p, o, tokens[rows], labels[rows], group=gr)
            out.update({f"{name}/m{i}/{k}": float(v) for k, v in m.items()})
            # the clipped gradients, 0.1 g at the first step
            out.update({f"{name}/mu{i}/{k}": v.numpy()
                        for k, v in o.mu.items()})
        for i, (g, _) in enumerate(log):
            out.update({f"{name}/grad{i + 1}/{k}": v.numpy()
                        for k, v in g.items()})
        for tree, t in (("params", p), ("mu", o.mu), ("nu", o.nu)):
            out.update({f"{name}/{tree}/{k}": v.numpy()
                        for k, v in t.items()})
    save(f"lm-straddle-{arch}", out)


def split_index():
    # each rank's block of a batch laid out by _batch_spec, against the
    # index of its UpdateSplit in the update group
    out = {}
    for mesh in (MeshConfig("dp4", 4, 1), MeshConfig("p2d2", 2, 1, pods=2),
                 MeshConfig("p2t2", 1, 2, pods=2), MeshConfig("d2t2", 2, 2)):
        x = torch.arange(16).reshape(8, 2)
        local = _batch_spec(mesh, tuple(x.shape)).local_shard(x, RANK)
        sp = update_split(update_group(mesh), local.shape[0])
        out[mesh.name] = dict(index=sp.index, rows=list(sp.rows),
                              first=int(local[0, 0]) // 2)
    return out


def lm_step(arch, microbatch):
    # make_lm_train_step on this rank's rows (group) and, on rank 0, on
    # all of them; labels shifted, a few masked
    model = build_model(get_smoke_config(arch))
    params = params_from_numpy(dict(np.load(f"{tmp}/{arch}.npz")))
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, model.cfg.vocab_size, (4, 256), generator=g)
    labels = torch.cat([tokens[:, 1:], torch.full((4, 1), -1)], dim=1)
    labels[:, :5] = -1
    group = update_group(MeshConfig("dp2", WORLD, 1))
    opt = adamw(LR, weight_decay=0.0)
    step = make_lm_train_step(model, opt, microbatch=microbatch)
    out = {}
    for name, rows, gr in (("dp", slice(2 * RANK, 2 * RANK + 2), group),
                           ("one", slice(None), None)):
        if name == "one" and RANK:
            break
        p, o, m = step(params, opt.init(params), tokens[rows], labels[rows],
                       group=gr)
        out.update({f"{name}/m/{k}": float(v) for k, v in m.items()})
        for tree, t in (("params", p), ("mu", o.mu), ("nu", o.nu)):
            out.update({f"{name}/{tree}/{k}": v.numpy()
                        for k, v in t.items()})
    save(f"lm-{arch}-{microbatch}", out)


def trainer(case, *a, arch="qwen2-0.5b", **kw):
    seen = []
    recs, real, state = trainer_run(dict(weights[arch]), *a, arch=arch,
                                    seen=seen, **kw)
    save(case, state)
    emit({case: {"records": recs, "real": real, "seen": seen}})


weights = {a: params_from_numpy(dict(np.load(f"{tmp}/{a}.npz")))
           for a in ARG["archs"]}
u0 = MeshConfig("u0", 1, 1)
for case, (_, _, _, _, n) in ARG["updates"].items():
    if n == WORLD:
        update_step(case)
if WORLD == 2:
    emit({"cut": [cut_step(a) for a in ARG["archs"]]})
    for a in ARG["archs"]:
        for mb in ARG["microbatch"]:
            lm_step(a, mb)
        lm_straddle(a)
    dp2 = MeshConfig("dp2", 2, 1)
    for pipeline in ("sync", "async"):
        trainer(f"switch-{pipeline}", Meshes(
            dp2, u0, MeshConfig("u1", 1, 1, device_offset=1)), pipeline)
    # no selector: the update runs on the mesh dst_shardings names
    trainer("dst-sync", None, "sync", dst=ExperienceBatch(
        *(_batch_spec(dp2, n) for n in (2, 2, 2, 2, 2, 1, 1, 1, 1, 1))))
    # the moe's update at dp=2, its batch's middle group straddling
    trainer("moe-straddle", Meshes(u0, dp2), "sync", arch=ARG["moe"],
            **ARG["moe_train"])
elif WORLD == 3:
    trainer("dp3", Meshes(u0, MeshConfig("dp3", 3, 1)), "sync")
else:
    r, t = rollout_trainer_split(n_devices=4)
    for pipeline in ("sync", "async"):
        trainer(f"split-{pipeline}", Meshes(r, t), pipeline,
                given=t.device_offset)
    trainer("1x2", Meshes(r, MeshConfig("1x2", 1, 2, device_offset=2)),
            "sync", given=2)
    # a restart: rank 2 saves, ranks 2-3 restore the state
    trainer("split-fault", Meshes(r, t), "async", given=t.device_offset,
            ckpt=f"{tmp}/ck-split")
    emit({"split_index": split_index()})
"""

# case -> (world, the last update mesh's ranks)
CASES = {"split-sync": (4, [2, 3]), "split-async": (4, [2, 3]),
         "dp3": (3, [0, 1, 2]), "1x2": (4, [2, 3]),
         "switch-sync": (2, [1]), "switch-async": (2, [1]),
         "dst-sync": (2, [0, 1]), "split-fault": (4, [2, 3]),
         "moe-straddle": (2, [0, 1])}
# the moe trainer's episodes and context: 6 rows of 256 tokens, three
# 512-token groups, of which the middle one straddles the update's ranks
MOE_TRAIN = dict(batch_size=6, max_context=256, kv_dtype="bf16")
MICROBATCH = (0, 2, 4)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's updates and LM steps on two and four host devices (two
    subprocesses, ``JAX_SPLIT``, in the background), the port's gloo
    worlds of 2, 3 and 4 ranks side by side, and the port's one-rank
    trainer runs, on the same fp32 weights, batches and draws."""
    tmp = tmp_path_factory.mktemp("update_dp")
    weights = {arch: _jax_flat(arch) for arch in ARCHS}
    for arch in ARCHS:
        np.savez(tmp / f"{arch}.npz", **weights[arch])
        np.savez(tmp / f"{arch}-lm.npz", **_lm_batch(arch))
    for case in UPDATES:
        np.savez(tmp / f"{case}-batch.npz", **_batch(case))
    jenv = dict(os.environ, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=8",
                PYTHONPATH=os.path.join(REPO, "src"))
    jax_procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_CODE),
         str(tmp / f"jax{i}.npz"), str(tmp),
         repr({c: UPDATES[c] for c in cases}), repr(list(lm)), repr(LR),
         repr(STEP), repr(LM_MICROBATCH)], env=jenv,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i, (cases, lm) in enumerate(JAX_SPLIT)]
    try:
        arg = dict(tmp=str(tmp), lr=LR, step=STEP, archs=list(ARCHS),
                   updates=UPDATES, microbatch=MICROBATCH,
                   lm_microbatch=LM_MICROBATCH, moe=MOE, moe_train=MOE_TRAIN)
        port, errors = {}, []

        def world(w):
            try:
                port[w] = run_gloo(GLOO_CODE, w, tmp, arg=arg,
                                   pg_timeout=120)
            except BaseException as e:        # raised below, in this thread
                errors.append(e)

        threads = [threading.Thread(target=world, args=(w,))
                   for w in (2, 3, 4)]
        for t in threads:
            t.start()
        params = params_from_numpy(weights["qwen2-0.5b"])
        one = {p: trainer_run(dict(params), None, p)
               for p in ("sync", "async")}
        one["fault"] = trainer_run(dict(params), None, "async",
                                   ckpt=str(tmp / "ck-one"))
        seen = []
        one["moe"] = trainer_run(params_from_numpy(weights[MOE]), None,
                                 "sync", arch=MOE, seen=seen,
                                 **MOE_TRAIN) + (seen,)
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        errs = [p.communicate(timeout=600)[1] for p in jax_procs]
    finally:
        for p in jax_procs:
            if p.poll() is None:
                p.kill()
    for p, err in zip(jax_procs, errs):
        assert p.returncode == 0, err[-4000:]
    np.savez(tmp / "jax.npz", **{k: v for i in range(len(JAX_SPLIT))
                                  for k, v in np.load(tmp / f"jax{i}.npz")
                                  .items()})
    out = {w: [{k: v for d in rank for k, v in d.items()} for rank in r]
           for w, r in port.items()}
    load = lambda name: dict(np.load(tmp / f"{name}.npz"))
    return out, one, load


def _exempt(grads, name):
    """Where any step's gradient is below 1e-5 of its leaf's largest."""
    out = None
    for g in grads:
        tiny = np.abs(g[name]) < 1e-5 * np.abs(g[name]).max()
        out = tiny if out is None else out | tiny
    return out


def _assert_state_close(got, want, grads, slack=None):
    """Params within 1e-5 elementwise but where ``_exempt`` (2 lr), the
    moments within 1e-5; each widened by ``slack``'s entry where given."""
    names = [k[len("params/"):] for k in want if k.startswith("params/")]
    assert names
    for k in names:
        for t in ("params", "mu", "nu"):
            tol = (np.where(_exempt(grads, k), 2 * LR, 1e-5)
                   if t == "params" else 1e-5)
            if slack is not None:
                tol = tol + slack[f"{t}/{k}"]
            err = np.abs(got[f"{t}/{k}"] - want[f"{t}/{k}"])
            assert (err <= tol).all(), (t, k, float(err.max()))


def _straddles(arch, rows, seq) -> bool:
    """Whether a dispatch group of ``arch``'s batch of ``rows`` rows a rank
    (each of ``seq`` tokens) straddles two ranks."""
    if get_smoke_config(arch).family != "moe":
        return False
    split = UpdateSplit(None, 0, tuple(rows))
    return bool(moe.edge_transfers(
        split, seq, moe._group_tokens(sum(rows) * seq, seq)))


def _check_update(runs, case):
    """The data-parallel update step of ``case`` (``UPDATES``) against
    JAX's jitted ``UpdateStage`` on the same devices' count and against
    the port's one-rank step, by the module docstring's rule."""
    port, _, load = runs
    arch, B, T, _, n = UPDATES[case]
    jc = JAX_CASE.get(case, case)
    jx = load("jax")
    # JAX ran the step on devices 2-3 (or 0-3), the params replicated there
    assert jx[f"{jc}/devices"].tolist() == list(range(4 - n, 4))
    assert str(jx[f"{jc}/spec"]) == "PartitionSpec()"
    assert _straddles(arch, [B // n] * n, T) == case.startswith("moe-")
    ranks = [load(f"step-{case}-r{r}") for r in range(n)]
    r0 = ranks[0]
    for r in ranks[1:]:                   # the ranks took the same step
        for k in r:
            np.testing.assert_array_equal(r0[k], r[k], err_msg=k)
    for i in (1, 2):
        names = {k.split("/")[-1] for k in jx if k.startswith(
            f"{jc}/m{i}/")}
        assert names >= set(METRICS), names
        assert ("aux_loss" in names) == (arch != "qwen2-0.5b")
        for k in names:
            got, want = float(r0[f"dp/m{i}/{k}"]), float(jx[f"{jc}/m{i}/{k}"])
            one = float(r0[f"one/m{i}/{k}"])
            # step 2 starts from params that AdamW's sign flips set apart
            # (by up to 2 lr): relative there
            tol = 1e-5 * (1.0 if i == 1 else max(1.0, abs(want)))
            assert abs(got - want) <= tol, (i, k, got, want)
            assert abs(got - one) <= 1e-5, (i, k, got, one)
    leaves = [k[len(f"{jc}/grad/"):] for k in jx
              if k.startswith(f"{jc}/grad/")]
    for k in leaves:
        want = jx[f"{jc}/grad/{k}"]
        err = np.abs(r0[f"dp/grad1/{k}"] - want).max()
        assert err <= 1e-5 * np.abs(want).max(), (k, float(err))
    grads = [{k: r0[f"one/grad{i}/{k}"] for k in leaves} for i in (1, 2)]
    state = lambda f: {f"{t}/{k}": f(t, k) for t in ("params", "mu", "nu")
                       for k in leaves}
    want = state(lambda t, k: jx[f"{jc}/{t}/{k}"])
    got = state(lambda t, k: r0[f"dp/{t}/{k}"])
    one = state(lambda t, k: r0[f"one/{t}/{k}"])
    # the split adds nothing to the port's own distance from JAX (its
    # one-rank step), and stays within the rule of the port's one-rank step
    _assert_state_close(got, want, grads,
                        slack={k: np.abs(one[k] - want[k]) for k in want})
    _assert_state_close(got, one, grads)


@pytest.mark.parametrize("arch", [c for c in UPDATES if UPDATES[c][4] == 2])
def test_update_step_matches_jax_two_device_update(runs, arch):
    """The smoke qwen2 and granite-moe at B=4 (whole groups a rank), and
    the granite-moe at B=6, S=256, whose middle 512-token group straddles
    the ranks, under remat "none" and "full" (the rerun moves the group's
    tokens again in the backward)."""
    _check_update(runs, arch)


def test_update_step_matches_jax_four_device_update(runs):
    """One 512-token group over four ranks of 128 tokens: each rank routes
    the whole group, its three peers' tokens moved in."""
    _check_update(runs, "moe-dp4")


def test_a_moe_group_straddling_two_ranks_is_refused(runs):
    """The layout this test once held refused now runs: one 256-token row
    a rank, the two rows one 512-token group of the moe, half on each
    rank (and the qwen2's rows), against the one-rank step on both rows:
    on each rank the loss and every metric within 1e-5, the summed
    gradients within 1e-5 of each leaf's largest |g|."""
    assert _straddles(MOE, [1, 1], 256)
    for rank in runs[0][2]:
        for arch, cut in zip(ARCHS, rank["cut"]):
            got, want = cut["loss"]
            assert abs(got - want) <= 1e-5, (arch, got, want)
            assert ("aux_loss" in cut["metrics"]) == (arch == MOE)
            for k, (got, want) in cut["metrics"].items():
                assert abs(got - want) <= 1e-5, (arch, k, got, want)
            assert cut["grad_err"] <= 1e-5, (arch, cut["grad_err"])


@pytest.mark.parametrize("case", list(CASES))
def test_spmd_trainer_matches_one_rank_trainer(runs, case):
    port, one, load = runs
    world, inside = CASES[case]
    ref = "moe" if case.startswith("moe") else next(
        (p for p in ("fault", "async") if p in case), "sync")
    ref_recs, _, ref_state = one[ref][:3]
    outs = [r[case] for r in port[world]]
    for o in outs:
        assert o["records"] == outs[0]["records"]
    # async lag 1; the restart at step 1 rolls out on the restored version
    lags = {"fault": [0, 0], "async": [0, 1]}
    assert [r["lag"] for r in ref_recs] == next(
        (v for k, v in lags.items() if k in case), [0, 0])
    for a, b in zip(outs[0]["records"], ref_recs):
        assert (a["moved"] is not None) == (case == "dst-sync"), a
        for k in ("ret", "ctx", "turn", "lag", "sw"):
            assert a[k] == b[k], (k, a, b)
        for k in ("loss", "kl"):
            assert abs(a[k] - b[k]) <= 1e-5, (k, a, b)
    states = [load(f"{case}-r{r}") for r in range(world)]
    for r in range(world):
        assert bool(states[r]) == (r in inside), r
    first = states[inside[0]]
    for r in inside[1:]:                  # the update ranks agree bitwise
        assert set(states[r]) == set(first)
        for k in first:
            np.testing.assert_array_equal(states[r][k], first[k], err_msg=k)
    grads = [{k[len("grad0/"):]: v for k, v in ref_state.items()
              if k.startswith(f"grad{i}/")} for i in (0, 1)]
    _assert_state_close(first, ref_state, grads)
    # every update ran on real params: each rank of the mesh of its step
    real = [o["real"] for o in outs]
    if case.startswith("switch"):
        assert real == [[True], [True]]     # rank 0 step 0, rank 1 step 1
    else:
        assert real == [[True, True] if r in inside else []
                        for r in range(world)]
    if case == "moe-straddle":
        # each step's update on 3 of the batch's 6 rows a rank, whose
        # middle group straddles the ranks; the ranks' rows in their
        # order in the update group are the one-rank update's batch
        ref_seen = one[ref][3]
        for step in (0, 1):
            seen = sorted((o["seen"][step] for o in outs),
                          key=lambda x: x["index"])
            assert [x["index"] for x in seen] == [0, 1]
            assert all(x["rows"] == [3, 3] for x in seen), seen
            T = len(ref_seen[step]["tokens"][0])
            assert T == MOE_TRAIN["max_context"]
            assert _straddles(MOE, [3, 3], T)
            assert seen[0]["tokens"] + seen[1]["tokens"] == \
                ref_seen[step]["tokens"]


@pytest.mark.parametrize("microbatch", MICROBATCH)
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_step_across_ranks_matches_one_rank(runs, arch, microbatch):
    """``make_lm_train_step`` over a world of 2 (2 of 4 rows a rank; with
    microbatches of the global batch, 1 or 2 of them a rank) against the
    one-rank step: the loss, ``lm_loss`` and ``n_tokens`` within 1e-5, the
    params and moments under the rule above."""
    _, _, load = runs
    r0, r1 = (load(f"lm-{arch}-{microbatch}-r{r}") for r in (0, 1))
    for k in r1:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    names = {k.split("/")[-1] for k in r0 if k.startswith("one/m/")}
    assert names == ({"lm_loss", "loss"} if microbatch else
                     {"lm_loss", "loss", "n_tokens"})
    for k in names:
        assert abs(float(r0[f"dp/m/{k}"]) - float(r0[f"one/m/{k}"])) <= 1e-5
    leaves = [k[len("one/params/"):] for k in r0
              if k.startswith("one/params/")]
    state = lambda who: {f"{t}/{k}": r0[f"{who}/{t}/{k}"]
                         for t in ("params", "mu", "nu") for k in leaves}
    # the first moment is 0.1 g: the exemption reads the gradient from it
    grads = [{k: r0[f"one/mu/{k}"] for k in leaves}]
    _assert_state_close(state("dp"), state("one"), grads)


def _lm_straddle(load, arch):
    r0, r1 = (load(f"lm-straddle-{arch}-r{r}") for r in (0, 1))
    for k in r1:                          # the ranks took the same steps
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    leaves = [k[len("one/params/"):] for k in r0
              if k.startswith("one/params/")]
    grads = [{k: r0[f"one/grad{i}/{k}"] for k in leaves} for i in (1, 2)]
    state = lambda who: {f"{t}/{k}": r0[f"{who}/{t}/{k}"]
                         for t in ("params", "mu", "nu") for k in leaves}
    return r0, leaves, grads, state


def test_lm_microbatch_slice_straddling_two_ranks_is_refused(runs):
    """The layout this test once held refused now runs:
    ``make_lm_train_step(microbatch=3)`` at B=6 on two ranks of 3 rows,
    whose middle 2-row slice straddles them (and, for the moe, the slice's
    one 512-token group), against the one-rank step, two steps: the ranks
    bitwise equal, ``lm_loss`` and ``loss`` within 1e-5, each step's
    gradients within 1e-5 of each leaf's largest |g| at the first step,
    the params and moments under the rule above."""
    _, _, load = runs
    mb = LM_ROWS // LM_MICROBATCH
    assert LM_MICROBATCH % 2 and (LM_ROWS // 2) % mb    # a slice straddles
    assert _straddles(MOE, [1, 1], mb // 2 * LM_SEQ)
    for arch in ARCHS:
        r0, leaves, grads, state = _lm_straddle(load, arch)
        for i in (1, 2):
            names = {k.split("/")[-1] for k in r0
                     if k.startswith(f"one/m{i}/")}
            assert names == {"lm_loss", "loss"}
            for k in names:
                got, one = float(r0[f"dp/m{i}/{k}"]), float(
                    r0[f"one/m{i}/{k}"])
                assert abs(got - one) <= 1e-5, (arch, i, k, got, one)
        for k in leaves:
            want = grads[0][k]
            err = np.abs(r0[f"dp/grad1/{k}"] - want).max()
            assert err <= 1e-5 * np.abs(want).max(), (arch, k, float(err))
        _assert_state_close(state("dp"), state("one"), grads)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_step_with_straddling_slices_matches_jax(runs, arch):
    """The straddling LM step (the test above) against JAX's jitted
    ``make_lm_train_step(microbatch=3)`` with the batch on ``P("data")``
    of two devices: each step's ``lm_loss`` and ``loss`` within 1e-5
    (relative at the second), the first step's gradients within 1e-5 of
    each leaf's largest |g| (read from both sides' first moment, 0.1 g
    after AdamW's global-norm clip),
    and the params and moments after two steps under the module
    docstring's rule, widened by the port's one-rank distance from
    JAX."""
    _, _, load = runs
    jx = load("jax")
    r0, leaves, grads, state = _lm_straddle(load, arch)
    for i in (1, 2):
        for k in ("lm_loss", "loss"):
            got, want = float(r0[f"dp/m{i}/{k}"]), float(
                jx[f"lm-{arch}/m{i}/{k}"])
            tol = 1e-5 * (1.0 if i == 1 else max(1.0, abs(want)))
            assert abs(got - want) <= tol, (i, k, got, want)
    for k in leaves:
        want = jx[f"lm-{arch}/mu1/{k}"]
        err = np.abs(r0[f"dp/mu1/{k}"] - want).max()
        assert err <= 1e-5 * np.abs(want).max(), (k, float(err))
    want = {f"{t}/{k}": jx[f"lm-{arch}/{t}/{k}"]
            for t in ("params", "mu", "nu") for k in leaves}
    one = state("one")
    _assert_state_close(state("dp"), want, grads,
                        slack={k: np.abs(one[k] - want[k]) for k in want})


def test_update_split_index_is_the_rank_block_of_rows(runs):
    """On a world of 4, for dp4, pods2 x dp2, pods2 x tp2 and dp2 x tp2
    meshes: each rank's ``UpdateSplit`` (its index in the update group)
    names the block of rows ``_batch_spec`` lays on it, in row order, so
    the moe groups and the microbatch slices read the global batch's
    rows in JAX's order."""
    for rank in runs[0][4]:
        for name, got in rank["split_index"].items():
            n = len(got["rows"])
            assert n == {"dp4": 4, "p2d2": 4, "p2t2": 2, "d2t2": 2}[name]
            assert got["rows"] == [8 // n] * n
            assert got["first"] == got["index"] * (8 // n), (name, got)


@pytest.mark.parametrize("rows,seq", [((3, 3), 256), ((1, 1, 1, 1), 128),
                                      ((1, 0, 3), 256), ((1, 1), 256),
                                      ((2, 2), 256), ((5, 7, 4), 96)])
def test_edge_transfers_move_only_the_straddling_groups_tokens(rows, seq):
    """``moe.edge_transfers`` against a token-by-token count: each rank
    receives exactly the other ranks' tokens of the dispatch groups it
    holds a token of, each from its owner, and nothing else; a rank that
    holds a whole group gets at most ``group_tokens - 1`` tokens a side.
    Layouts: the straddling update (3+3 rows of 256), one group over four
    ranks, a microbatch slice a rank holds no row of, one group half a
    rank, whole groups (nothing moves), and row-sized groups (96-token
    rows whose total does not divide into 512: nothing moves)."""
    Tg = moe._group_tokens(sum(rows) * seq, seq)
    owner = np.repeat(np.arange(len(rows)), np.array(rows) * seq)
    group = np.arange(owner.size) // Tg
    moves = moe.edge_transfers(UpdateSplit(None, 0, rows), seq, Tg)
    for dst in range(len(rows)):
        need = np.flatnonzero(np.isin(group, group[owner == dst])
                              & (owner != dst))
        got = [(src, lo, hi) for src, d, lo, hi in moves if d == dst]
        moved = np.concatenate([np.arange(lo, hi) for _, lo, hi in got]
                               or [np.zeros(0, int)])
        np.testing.assert_array_equal(np.sort(moved), need)
        assert all((owner[lo:hi] == src).all() for src, lo, hi in got)
        mine = np.flatnonzero(owner == dst)
        if mine.size and mine.size >= Tg:
            assert (need < mine[0]).sum() < Tg
            assert (need > mine[-1]).sum() < Tg
    assert bool(moves) == _straddles(MOE, rows, seq)


def test_no_module_of_the_port_cites_item_19():
    """A moe dispatch group and an LM microbatch slice run across the
    update's ranks: no module of the port refuses one citing ROADMAP item
    19, or says that a group or slice would straddle two ranks."""
    root = os.path.join(REPO, "src", "repro_torch")
    for path, _, files in os.walk(root):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                with open(os.path.join(path, f)) as fh:
                    text = fh.read()
                for phrase in ("item 19", "straddle two ranks"):
                    assert phrase not in text, (os.path.join(path, f),
                                                phrase)
