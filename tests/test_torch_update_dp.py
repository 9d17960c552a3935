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
  starts from params that the first step's flips set apart). A split that
  would cut a moe group is refused;
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
  forward, its peer timing out in the metrics broadcast).

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
from repro_torch.models.registry import build_model
from repro_torch.rl.envs import TicTacToe

from test_torch_dispatcher import REPO, run_gloo
from test_torch_tp import NOISE_SRC
from test_torch_tp_families import _jax_flat

torch.set_num_threads(1)

LR = 1e-3
STEP = dict(clip_eps=0.2, kl_coef=0.05, is_rho_max=2.0)
# arch -> (B, T) of the update step's batch
SHAPES = {"qwen2-0.5b": (4, 96), "granite-moe-3b-a800m": (4, 256)}
METRICS = ("loss", "pg_loss", "kl", "clip_frac", "is_weight_mean",
           "is_trunc_frac")


def _batch(arch):
    """A random ``ExperienceBatch`` as numpy arrays, from a seed."""
    B, T = SHAPES[arch]
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


JAX_CODE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs.base import get_smoke_config
from repro.core.stages import UpdateStage
from repro.models.registry import build_model
from repro.optim.adamw import adamw
from repro.rl.algo import policy_gradient_loss, token_logprobs
from repro.rl.experience import ExperienceBatch
out_path, tmp, archs, lr, step_kw = sys.argv[1], sys.argv[2], *(
    eval(a) for a in sys.argv[3:6])
mesh = Mesh(np.array(jax.devices()[2:4]).reshape(2, 1), ("data", "model"))
flat = lambda t: {".".join(k.key for k in path): np.asarray(v) for path, v
                  in jax.tree_util.tree_flatten_with_path(t)[0]}
out = {}
for arch in archs:
    model = build_model(get_smoke_config(arch))
    params = model.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    arrs = dict(np.load(f"{tmp}/{arch}-batch.npz"))
    batch = ExperienceBatch(**{k: jax.device_put(v, NamedSharding(
        mesh, P("data"))) for k, v in arrs.items()})
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
            out[f"{arch}/m{step}/{k}"] = np.asarray(v)
    leaf = jax.tree.leaves(params)[0]
    out[f"{arch}/devices"] = np.array(sorted(
        d.id for d in leaf.sharding.device_set))
    out[f"{arch}/spec"] = np.array(repr(leaf.sharding.spec))
    for name, tree in (("grad", grads), ("params", params),
                       ("mu", state.mu), ("nu", state.nu)):
        for k, v in flat(tree).items():
            out[f"{arch}/{name}/{k}"] = v
np.savez(out_path, **out)
"""

SRC = NOISE_SRC + """
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


def trainer_run(params, selector, pipeline, given=0, dst=None, ckpt=None):
    # two steps of the trainer on ``params`` (real on rank ``given`` alone
    # across ranks), the batch sent to ``dst``; with ``ckpt`` a checkpoint
    # a step there and an injected update fault at step 1 (a restart);
    # returns the records, the update log and the final state
    from repro_torch.core.stages import EarlTrainer
    from repro_torch.utils.faults import FaultInjector
    log = []
    kw = {} if ckpt is None else dict(
        faults=FaultInjector.parse(["update@1"]), checkpoint_dir=ckpt,
        checkpoint_every=1, max_retries=1, retry_backoff_s=0.0)
    tr = EarlTrainer(model=build_model(get_smoke_config("qwen2-0.5b")),
                     env=TicTacToe(), selector=selector,
                     optimizer=recording_adamw(log), noise=step_noise,
                     pipeline=pipeline, max_policy_lag=1, **TRAIN, **kw)
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
from repro_torch.models.tensor_parallel import update_group
from repro_torch.rl.envs import TicTacToe
from repro_torch.rl.experience import ExperienceBatch
LR = ARG["lr"]
""" + SRC + """
tmp = ARG["tmp"]


def save(name, arrays):
    np.savez(f"{tmp}/{name}-r{RANK}.npz", **arrays)


def update_step(arch):
    # two data-parallel steps on this rank's rows, and (rank 0) the
    # one-rank run's two steps on all of them
    model = build_model(get_smoke_config(arch))
    params = params_from_numpy(dict(np.load(f"{tmp}/{arch}.npz")))
    full = ExperienceBatch(**{k: torch.from_numpy(v) for k, v in
                              np.load(f"{tmp}/{arch}-batch.npz").items()})
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
    save(f"step-{arch}", out)
    # a batch whose rank share cuts a 512-token group: refused
    cut = ExperienceBatch(*(x[:1, :256] if x.dim() > 1 else x[:1]
                            for x in full))
    try:
        step.grads_of(params, cut, group=group)
        return "accepted"
    except ValueError as e:
        return str(e)


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
    if microbatch:
        return None
    # 3 slices of 6 rows over 2 ranks: one would straddle them
    step = make_lm_train_step(model, opt, microbatch=3)
    try:
        step(params, opt.init(params), tokens[:3], labels[:3], group=group)
        return "accepted"
    except ValueError as e:
        return str(e)


def trainer(case, *a, **kw):
    recs, real, state = trainer_run(dict(params), *a, **kw)
    save(case, state)
    emit({case: {"records": recs, "real": real}})


params = params_from_numpy(dict(np.load(f"{tmp}/qwen2-0.5b.npz")))
u0 = MeshConfig("u0", 1, 1)
if WORLD == 2:
    emit({"refused": [update_step(a) for a in ARG["archs"]]})
    emit({"lm_refused": [lm_step(a, mb) for a in ARG["archs"]
                         for mb in ARG["microbatch"]]})
    dp2 = MeshConfig("dp2", 2, 1)
    for pipeline in ("sync", "async"):
        trainer(f"switch-{pipeline}", Meshes(
            dp2, u0, MeshConfig("u1", 1, 1, device_offset=1)), pipeline)
    # no selector: the update runs on the mesh dst_shardings names
    trainer("dst-sync", None, "sync", dst=ExperienceBatch(
        *(_batch_spec(dp2, n) for n in (2, 2, 2, 2, 2, 1, 1, 1, 1, 1))))
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
"""

# case -> (world, the last update mesh's ranks)
CASES = {"split-sync": (4, [2, 3]), "split-async": (4, [2, 3]),
         "dp3": (3, [0, 1, 2]), "1x2": (4, [2, 3]),
         "switch-sync": (2, [1]), "switch-async": (2, [1]),
         "dst-sync": (2, [0, 1]), "split-fault": (4, [2, 3])}
MICROBATCH = (0, 2, 4)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's two-device update (a subprocess, in the background), the
    port's gloo worlds of 2, 3 and 4 ranks side by side, and the port's
    one-rank trainer runs, on the same fp32 weights, batches and draws."""
    tmp = tmp_path_factory.mktemp("update_dp")
    for arch in SHAPES:
        np.savez(tmp / f"{arch}.npz", **_jax_flat(arch))
        np.savez(tmp / f"{arch}-batch.npz", **_batch(arch))
    jenv = dict(os.environ, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=8",
                PYTHONPATH=os.path.join(REPO, "src"))
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_CODE),
         str(tmp / "jax.npz"), str(tmp), repr(list(SHAPES)), repr(LR),
         repr(STEP)], env=jenv, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        arg = dict(tmp=str(tmp), lr=LR, step=STEP, archs=list(SHAPES),
                   microbatch=MICROBATCH)
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
        params = params_from_numpy(_jax_flat("qwen2-0.5b"))
        one = {p: trainer_run(dict(params), None, p)
               for p in ("sync", "async")}
        one["fault"] = trainer_run(dict(params), None, "async",
                                   ckpt=str(tmp / "ck-one"))
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        _, err = jax_proc.communicate(timeout=600)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
    assert jax_proc.returncode == 0, err[-4000:]
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


@pytest.mark.parametrize("arch", list(SHAPES))
def test_update_step_matches_jax_two_device_update(runs, arch):
    port, _, load = runs
    jx = load("jax")
    # JAX ran the step on devices 2-3, the params replicated there
    assert jx[f"{arch}/devices"].tolist() == [2, 3]
    assert str(jx[f"{arch}/spec"]) == "PartitionSpec()"
    r0, r1 = load(f"step-{arch}-r0"), load(f"step-{arch}-r1")
    for k in r1:                          # the ranks took the same step
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    for i in (1, 2):
        names = {k.split("/")[-1] for k in jx if k.startswith(
            f"{arch}/m{i}/")}
        assert names >= set(METRICS), names
        assert ("aux_loss" in names) == (arch != "qwen2-0.5b")
        for k in names:
            got, want = float(r0[f"dp/m{i}/{k}"]), float(jx[f"{arch}/m{i}/{k}"])
            one = float(r0[f"one/m{i}/{k}"])
            # step 2 starts from params that AdamW's sign flips set apart
            # (by up to 2 lr): relative there
            tol = 1e-5 * (1.0 if i == 1 else max(1.0, abs(want)))
            assert abs(got - want) <= tol, (i, k, got, want)
            assert abs(got - one) <= 1e-5, (i, k, got, one)
    leaves = [k[len(f"{arch}/grad/"):] for k in jx
              if k.startswith(f"{arch}/grad/")]
    for k in leaves:
        want = jx[f"{arch}/grad/{k}"]
        err = np.abs(r0[f"dp/grad1/{k}"] - want).max()
        assert err <= 1e-5 * np.abs(want).max(), (k, float(err))
    grads = [{k: r0[f"one/grad{i}/{k}"] for k in leaves} for i in (1, 2)]
    state = lambda f: {f"{t}/{k}": f(t, k) for t in ("params", "mu", "nu")
                       for k in leaves}
    want = state(lambda t, k: jx[f"{arch}/{t}/{k}"])
    got = state(lambda t, k: r0[f"dp/{t}/{k}"])
    one = state(lambda t, k: r0[f"one/{t}/{k}"])
    # the split adds nothing to the port's own distance from JAX (its
    # one-rank step), and stays within the rule of the port's one-rank step
    _assert_state_close(got, want, grads,
                        slack={k: np.abs(one[k] - want[k]) for k in want})
    _assert_state_close(got, one, grads)


def test_a_moe_group_straddling_two_ranks_is_refused(runs):
    qwen, moe = runs[0][2][0]["refused"]
    assert qwen == "accepted"               # no dispatch groups
    assert "would straddle two ranks" in moe, moe


@pytest.mark.parametrize("case", list(CASES))
def test_spmd_trainer_matches_one_rank_trainer(runs, case):
    port, one, load = runs
    world, inside = CASES[case]
    ref_recs, _, ref_state = one[next(
        (p for p in ("fault", "async") if p in case), "sync")]
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


@pytest.mark.parametrize("microbatch", MICROBATCH)
@pytest.mark.parametrize("arch", list(SHAPES))
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


def test_lm_microbatch_slice_straddling_two_ranks_is_refused(runs):
    for rank in runs[0][2]:
        out = [m for m in rank["lm_refused"] if m is not None]
        assert len(out) == len(SHAPES)
        assert all("would straddle two ranks" in m for m in out), out
