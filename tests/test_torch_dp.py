"""The data-parallel rollout of the port (the engine at dp or pods above 1
and at dp x tp, ``models.tensor_parallel.data_group``, the SPMD trainer
across those meshes) on the CPU, over gloo ranks (one process a rank,
``test_torch_dispatcher.run_gloo``), against JAX's engine on the same
``MeshConfig`` (one subprocess with eight host devices, in the background)
and against the port's one-rank run:

- fp32 greedy trajectories at dp=2 on the paged layout with fused
  sampling and on the dense one with reference sampling, on tictactoe and
  bandit: tokens bitwise JAX's, with JAX's env draws injected (at dp=2
  JAX folds the env step's key per data shard, so the draws are the
  concatenation of its per-shard draws); log-probs, the folded
  reference's and the advantages within 1e-5 of the one-rank run fed the
  same draws; each rank holds its three of the six episodes;
- dp=4 (the batch replicated on every rank, as JAX's ``(None, None)``),
  dp=2 x tp=2, pods=2 with dp=1 (no fold; the batch over ``('pod',
  'data')``) and dp=3 at B=4 (the rows do not divide the slots: every row
  runs all of them unfolded, and the batch lies over ``data``): tokens
  bitwise JAX's;
- int8 pages at dp=2: tokens and counters bitwise the one-rank run's,
  log-probs within 2e-4;
- the moe, ssm and hybrid smoke families at dp=2 on their dense (f32)
  caches: tokens bitwise JAX's;
- the ``RolloutStats`` counters equal JAX's on every run;
- a two-rank ``EarlTrainer`` whose selector switches dp2 -> tp2 and one
  that switches tp2 -> dp2, their records within 1e-5 of the one-rank
  trainer's; the sync trainer on dp2 x tp2 (the params handoff sends
  each rank its row's shards) and each rank's model- and data-axis
  groups there; the plan at dp2 x tp2 (the tp2 shards on every row); the
  default four-rank async split (``rollout-2x1`` / ``trainer-2x1``, the
  update data-parallel on ranks 2-3) runs two steps against the one-rank
  async trainer;
- a pool below full provisioning at dp=2 against the one-rank run, the
  pool options passing the option check above one data row (they run in
  ``tests/test_torch_dp_options.py``), and the per-rank pools that
  ``cache_shardings`` places with their trash pages.
"""
import os
import subprocess
import sys
import textwrap
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models.registry import build_model as jax_build_model
from repro.rl.engine import common as jcommon
from repro.rl.envs import make_env as jax_make_env
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.core.resharding import MeshConfig, NamedLayout
from repro_torch.launch.mesh import cache_shardings
from repro_torch.models import transformer
from repro_torch.models.registry import build_model
from repro_torch.rl.engine import CompiledRolloutEngine
from repro_torch.rl.envs import TicTacToe

from test_torch_dispatcher import REPO, run_gloo
from test_torch_envs import env_draw
from test_torch_tp import NOISE_SRC
from test_torch_tp_families import F32_SRC, _jax_flat

torch.set_num_threads(1)

KW = dict(kv_dtype="fp32", max_turns=2, max_turn_tokens=3, max_context=96)
B, N = 4, 6
MACRO = KW["max_turns"] * -(-N // B) + 2          # the engine's budget
ENV_KW = {"tictactoe": {}, "bandit": {"prompt_len": 8}}
FAMILIES = {"granite-moe-3b-a800m": "fused", "mamba2-370m": "reference",
            "zamba2-1.2b": "fused"}
MESHES = {"dp2": dict(name="dp2", dp=2, tp=1),
          "dp4": dict(name="dp4", dp=4, tp=1),
          "d2t2": dict(name="d2t2", dp=2, tp=2),
          "pods2": dict(name="pods2", dp=1, tp=1, pods=2),
          "dp3": dict(name="dp3", dp=3, tp=1)}
# each run: (key, arch, env, layout, sampling, mesh); the fold of JAX's
# env draws (its data shards, 1 = unfolded) is the mesh's
RUNS = [(f"dp2-{env}-{layout}", "qwen2-0.5b", env, layout, sampling, "dp2")
        for env in ("tictactoe", "bandit")
        for layout, sampling in (("paged", "fused"), ("dense", "reference"))]
RUNS += [(f"{m}-tictactoe-paged", "qwen2-0.5b", "tictactoe", "paged",
          "fused", m) for m in ("dp4", "d2t2", "pods2", "dp3")]
RUNS += [(f"dp2-{arch}", arch, "tictactoe", "dense", sampling, "dp2")
         for arch, sampling in FAMILIES.items()]
FOLD = {"dp2": 2, "d2t2": 2, "dp4": 4, "pods2": 1, "dp3": 1}
STATS = ("episodes_started", "episodes_returned", "pages_in_use",
         "page_capacity", "kv_dropped_writes")

JAX_CODE = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import get_smoke_config
from repro.core.resharding import MeshConfig
from repro.models import hybrid, mamba, moe
from repro.models.registry import build_model
from repro.rl.engine import CompiledRolloutEngine
from repro.rl.envs import make_env
runs, meshes, env_kw, kw = (eval(a) for a in sys.argv[2:6])
ic = {"moe": moe.init_cache, "ssm": mamba.init_cache,
      "hybrid": hybrid.init_cache}
models, out = {}, {}
for key, arch, env, layout, sampling, mesh in runs:
    if arch not in models:
        model = build_model(get_smoke_config(arch))
        if model.cfg.family in ic:      # fp32 on f32 caches
            fam = ic[model.cfg.family]
            model = dataclasses.replace(
                model, _init_cache=lambda cfg, b, s, dtype=None, fam=fam:
                fam(cfg, b, s, jnp.float32))
        models[arch] = (model, model.init(jax.random.PRNGKey(0),
                                          dtype=jnp.float32))
    model, params = models[arch]
    eng = CompiledRolloutEngine(
        model, make_env(env, **env_kw[env]), attn_impl="xla",
        cache_layout=layout, sampling=sampling, temperature=0.0,
        mesh_config=MeshConfig(**meshes[mesh]),
        **(kw if model.cfg.family == "dense" else
           {k: v for k, v in kw.items() if k != "kv_dtype"}))
    exp, st = eng.run(params, jax.random.PRNGKey(1), 4, n_episodes=6)
    out[key + "/tokens"] = np.asarray(exp.tokens)
    out[key + "/stats"] = np.array([getattr(st, s) for s in eval(sys.argv[6])])
    spec = tuple(exp.tokens.sharding.spec)
    out[key + "/spec"] = np.array(repr(spec + (None,) * (2 - len(spec))))
np.savez(sys.argv[1], **out)
"""

SRC = NOISE_SRC + F32_SRC + """
def dp_tp_selector(first, world):
    # "dp2" and "tp2" on ``world`` ranks (one-device configs of the same
    # names on one); ``first`` wins the bucket below one token of context
    # (profiled at its edge), the other above, so the rollout switches at
    # step 1
    from repro_torch.core.parallelism_selector import (
        ContextBuckets, ParallelismSelector, ProfileEntry)
    a = MeshConfig("dp2", world, 1)
    b = MeshConfig("tp2", 1, world)
    sel = ParallelismSelector(
        [a, b], lambda c, ctx: ProfileEntry(
            c, ctx, 2.0 if (c.name == first) == (ctx <= 1) else 1.0, True),
        ContextBuckets((1,)))
    sel.profile()
    return sel


TRAIN = dict(batch_size=4, max_turns=2, max_turn_tokens=3, max_context=96,
             kl_coef=0.05, temperature=1.0, kv_dtype="fp32", device="cpu")


def records(hist):
    return [dict(loss=r.loss, kl=r.kl, ret=r.mean_return,
                 ctx=r.mean_context_len, turn=r.mean_turn_len,
                 sw=r.selector_switch, lag=r.policy_lag) for r in hist]


def dp_train_records(params, first, world):
    from repro_torch.core.stages import EarlTrainer
    from repro_torch.optim.adamw import adamw
    model = build_model(get_smoke_config("qwen2-0.5b"))
    tr = EarlTrainer(model=model, env=TicTacToe(),
                     selector=dp_tp_selector(first, world),
                     optimizer=adamw(1e-3, weight_decay=0.0),
                     noise=step_noise, **TRAIN)
    _, _, hist = tr.train(2, params=params,
                          opt_state=tr.optimizer.init(params),
                          ref_params=params)
    return records(hist)


def fixed_selector(cfg):
    # one candidate: the rollout stays on ``cfg``
    from repro_torch.core.parallelism_selector import (
        ParallelismSelector, ProfileEntry)
    sel = ParallelismSelector([cfg], lambda c, ctx: ProfileEntry(c, ctx, 1.0,
                                                                 True))
    sel.profile()
    return sel


def split_selector(rollout, update):
    # the rollout on one config and the update on another, never switched
    from repro_torch.core.parallelism_selector import (
        ParallelismSelector, ProfileEntry)

    class Split(ParallelismSelector):
        def maybe_switch(self, step=-1, stage="rollout"):
            return None

    sel = Split([rollout], lambda c, ctx: ProfileEntry(c, ctx, 1.0, True))
    sel.profile()
    sel._current["update"] = update
    return sel


def async_records(params, selector, pipeline="async"):
    from repro_torch.core.stages import EarlTrainer
    from repro_torch.optim.adamw import adamw
    tr = EarlTrainer(model=build_model(get_smoke_config("qwen2-0.5b")),
                     env=TicTacToe(), selector=selector,
                     optimizer=adamw(1e-3, weight_decay=0.0),
                     noise=step_noise, pipeline=pipeline, max_policy_lag=1,
                     **TRAIN)
    _, _, hist = tr.train(2, params=params,
                          opt_state=tr.optimizer.init(params),
                          ref_params=params)
    return records(hist)
"""
exec(SRC)

GLOO_CODE = """
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.core.resharding import MeshConfig
from repro_torch.launch.mesh import rollout_trainer_split
from repro_torch.models.registry import build_model
from repro_torch.rl.engine import CompiledRolloutEngine
from repro_torch.rl.envs import TicTacToe, make_env
""" + SRC + """
draws = dict(np.load(ARG["noise"]))
one = MeshConfig("one", 1, 1)


def jax_noise(env, fold):
    # JAX's draws of the global batch, the env step's folded per data
    # shard when ``fold`` > 1 (the engine asks for the global shape)
    def noise(kind, m, index, shape):
        assert shape[0] == ARG["B"], shape
        key = (f"{env}{fold}-env-{m}" if kind == "env"
               else f"{env}-reset-{m}")
        return torch.from_numpy(draws[key])
    return noise


def rollout(mesh, arch, env, layout, sampling, fold, **kw):
    model = (build_model(get_smoke_config(arch)) if arch == "qwen2-0.5b"
             else f32_model(arch))
    params = params_from_numpy(dict(np.load(ARG["params"][arch])))
    kw = dict(ARG["kw"], **kw)
    if model.cfg.family != "dense":
        kw.pop("kv_dtype")
    eng = CompiledRolloutEngine(
        model, make_env(env, **ARG["env_kw"][env]), device="cpu",
        mesh_config=mesh, cache_layout=layout, sampling=sampling,
        temperature=0.0, **kw)
    exp, st = eng.run(params, ARG["B"], ARG["N"], ref_params=params,
                      noise=jax_noise(env, fold))
    if st is None:
        return {"outside": exp.tokens.device.type}
    lay = eng.experience_shardings.tokens
    return dict(tokens=exp.tokens.tolist(), lp=exp.logprobs.tolist(),
                ref=exp.ref_logprobs.tolist(), adv=exp.advantages.tolist(),
                rewards=exp.rewards.tolist(),
                spec=repr(tuple(tuple(e) if isinstance(e, list) else e
                                for e in lay.spec)),
                stats=[getattr(st, s) for s in ARG["stats"]])


res = {}
for key, arch, env, layout, sampling, mesh in ARG["runs"]:
    cfg = MeshConfig(**ARG["meshes"][mesh])
    if cfg.n_devices > WORLD or (WORLD == 2) != (cfg.n_devices == 2):
        continue
    res[key] = rollout(cfg, arch, env, layout, sampling,
                       ARG["fold"][mesh])
    if mesh == "dp2" and arch == "qwen2-0.5b":
        # the one-rank run fed the same concatenated draws
        r = rollout(one, arch, env, layout, sampling, 2)
        if RANK == 0:
            res[key]["one"] = r
if WORLD == 2:
    dp2 = MeshConfig(**ARG["meshes"]["dp2"])
    for m in (dp2, one):
        r = rollout(m, "qwen2-0.5b", "tictactoe", "paged", "fused", 2,
                    kv_dtype="int8")
        res["int8-" + m.name] = r
    # a pool below full provisioning, on the global page count
    for m, key in ((dp2, "below_full"), (one, "below_full_one")):
        r = rollout(m, "qwen2-0.5b", "tictactoe", "paged", "fused", 2,
                    cache_pages=6)
        if "outside" not in r:
            res[key] = r
emit({"runs": res})
params = params_from_numpy(dict(np.load(ARG["params"]["qwen2-0.5b"])))
if WORLD == 2:
    emit({"train": {first: dp_train_records(dict(params), first, 2)
                    for first in ("dp2", "tp2")}})
else:
    from repro_torch.models.tensor_parallel import data_group, model_group
    d2t2 = MeshConfig(**ARG["meshes"]["d2t2"])
    emit({"groups": [dist.get_process_group_ranks(g(d2t2))
                     for g in (model_group, data_group)]})
    # the sync trainer on dp2 x tp2: each rank gets its row's shards
    emit({"d2t2_train": async_records(dict(params), fixed_selector(d2t2),
                                      "sync")})
    r, t = rollout_trainer_split(n_devices=4)
    p = (params if RANK == t.device_offset else
         {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
          for k, v in params.items()})
    emit({"split": [r.name, t.name,
                    async_records(p, split_selector(r, t))]})
"""


def _folded(key, fold, draw, batch):
    """JAX's env-step draw of the global batch under ``key``: the
    concatenation of each data shard's draw under ``fold_in(key, shard)``
    when ``fold`` > 1 (``compiled.py:1053-1054``)."""
    if fold == 1:
        return np.asarray(draw(key, batch))
    return np.concatenate([np.asarray(draw(jax.random.fold_in(key, r),
                                           batch // fold))
                           for r in range(fold)])


def _jax_draws(rng):
    """Every draw the port's runs ask for, by env, fold and macro-step."""
    base = jax.random.fold_in(rng, 1)
    out = {}
    for env, kw in ENV_KW.items():
        jenv = jax_make_env(env, **kw)
        step = lambda key, b, jenv=jenv: env_draw(jenv, "env", key, b)
        for m in range(MACRO):
            key = jcommon.env_rng(jcommon.turn_rng(base, m))
            for fold in (1, 2, 4):
                out[f"{env}{fold}-env-{m}"] = _folded(key, fold, step, B)
            if env == "bandit":
                rkey = jcommon.reset_rng(jcommon.turn_rng(base, m))
                out[f"{env}-reset-{m}"] = np.asarray(
                    env_draw(jenv, "reset", rkey, B))
        if env == "bandit":
            out[f"{env}-reset--1"] = np.asarray(env_draw(jenv, "reset", rng,
                                                         B))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's runs (one subprocess, in the background) and the port's gloo
    worlds of 2 and 4 ranks, side by side, on the same fp32 weights and
    env draws."""
    tmp = tmp_path_factory.mktemp("dp")
    params = {}
    for arch in ["qwen2-0.5b", *FAMILIES]:
        params[arch] = str(tmp / f"{arch}.npz")
        np.savez(params[arch], **_jax_flat(arch))
    np.savez(tmp / "noise.npz", **_jax_draws(jax.random.PRNGKey(1)))
    jenv = dict(os.environ, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=8",
                PYTHONPATH=os.path.join(REPO, "src"))
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_CODE),
         str(tmp / "jax.npz"), repr(RUNS), repr(MESHES), repr(ENV_KW),
         repr(KW), repr(STATS)], env=jenv, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        arg = dict(params=params, noise=str(tmp / "noise.npz"), kw=KW, B=B,
                   N=N, env_kw=ENV_KW, runs=RUNS, meshes=MESHES, fold=FOLD,
                   stats=STATS)
        port, errors = {}, []

        def world(w):
            try:
                port[w] = run_gloo(GLOO_CODE, w, tmp, arg=arg,
                                   pg_timeout=120)
            except BaseException as e:        # raised below, in this thread
                errors.append(e)

        threads = [threading.Thread(target=world, args=(w,)) for w in (2, 4)]
        for t in threads:
            t.start()
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
    return out, dict(np.load(tmp / "jax.npz"))


def _ranks(port, key):
    """Each rank's result of run ``key``, from the world that ran it."""
    w = 2 if MeshConfig(**MESHES[key.split("-")[0]]).n_devices == 2 else 4
    return [r["runs"][key] for r in port[w]]


def _held(ranks, mesh):
    """The batch rows each data row holds, rank by rank: for a batch split
    over the rows, their concatenation is the global batch."""
    cfg = MeshConfig(**MESHES[mesh])
    inside = [r for r in ranks if "outside" not in r]
    D = cfg.dp * cfg.pods
    rows = [inside[d * cfg.tp] for d in range(D)]
    for d, r in enumerate(inside):              # a row's tp ranks agree
        assert r["tokens"] == rows[d // cfg.tp]["tokens"]
    if len(rows[0]["tokens"]) == N:
        return rows[0]
    return {k: sum((r[k] for r in rows), []) for k in
            ("tokens", "lp", "ref", "adv", "rewards")}


@pytest.mark.parametrize("key", [r[0] for r in RUNS])
def test_tokens_stats_and_layout_match_jax(runs, key):
    port, jx = runs
    mesh = key.split("-")[0]
    ranks = _ranks(port, key)
    held = _held(ranks, mesh)
    np.testing.assert_array_equal(np.array(held["tokens"]),
                                  jx[key + "/tokens"])
    spec = str(jx[key + "/spec"])
    for r in ranks:
        if "outside" in r:
            assert r["outside"] == "meta"
            continue
        assert r["stats"] == jx[key + "/stats"].tolist(), (r["stats"], key)
        assert r["spec"] == spec, (r["spec"], spec)
        assert len(r["tokens"]) == (N if spec.startswith("(None")
                                    else N // 2 if mesh != "dp3" else 2)


def test_layouts_are_jax_batch_spec(runs):
    """``data`` at dp=2 and dp=3 (N=6), replicated at dp=4, and over
    ``('pod', 'data')`` at pods=2, as JAX's engine lays them out."""
    _, jx = runs
    want = {"dp2": "('data', None)", "dp4": "(None, None)",
            "d2t2": "('data', None)", "pods2": "(('pod', 'data'), None)",
            "dp3": "('data', None)"}
    for mesh, spec in want.items():
        key = next(r[0] for r in RUNS if r[5] == mesh)
        assert str(jx[key + "/spec"]) == spec, key


@pytest.mark.parametrize("env", ["tictactoe", "bandit"])
@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_dp2_against_one_rank_fed_the_same_draws(runs, env, layout):
    key = f"dp2-{env}-{layout}"
    held = _held(_ranks(runs[0], key), "dp2")
    one = runs[0][2][0]["runs"][key]["one"]
    assert held["tokens"] == one["tokens"]
    for k in ("lp", "ref", "adv", "rewards"):
        err = np.abs(np.array(held[k]) - np.array(one[k])).max()
        assert err <= 1e-5, (k, err)
    assert _ranks(runs[0], key)[0]["stats"] == one["stats"]


def test_unfolded_meshes_give_the_one_device_tokens(runs):
    """pods=2 (dp=1) and dp=3 at B=4 draw JAX's env noise unfolded, and
    give the one-device tokens (the one-rank run on the unfolded draws is
    JAX's one-device engine, held by tests/test_torch_engine.py)."""
    _, jx = runs
    assert (jx["pods2-tictactoe-paged/tokens"]
            == jx["dp3-tictactoe-paged/tokens"]).all()


def test_int8_pages_at_dp2_against_one_rank(runs):
    port = runs[0][2]
    one = port[0]["runs"]["int8-one"]
    held = _held([r["runs"]["int8-dp2"] for r in port], "dp2")
    assert held["tokens"] == one["tokens"]
    assert port[1]["runs"]["int8-dp2"]["stats"] == one["stats"]
    assert np.abs(np.array(held["lp"]) - np.array(one["lp"])).max() <= 2e-4


@pytest.mark.parametrize("first", ["dp2", "tp2"])
def test_trainer_switches_between_dp2_and_tp2(runs, first):
    """Two steps of the SPMD trainer whose selector switches dp2 -> tp2
    (or tp2 -> dp2) at step 1, sampled with injected noise, against the
    one-rank trainer whose selector switches between one-device configs
    of the same names."""
    two = [r["train"][first] for r in runs[0][2]]
    assert two[0] == two[1]
    params = params_from_numpy(_jax_flat("qwen2-0.5b"))
    one = dp_train_records(params, first, 1)
    sw = two[0][1]["sw"]
    assert sw["from"] == first and sw["to"] == ({"dp2", "tp2"} - {first}
                                                ).pop()
    assert [r["sw"] for r in two[0]] == [r["sw"] for r in one]
    for a, b in zip(two[0], one):
        for k in ("ret", "ctx", "turn", "lag"):
            assert a[k] == b[k], (k, a, b)
        for k in ("loss", "kl"):
            assert abs(a[k] - b[k]) <= 1e-5, (k, a, b)
    assert any(r["loss"] != 0.0 for r in one)


def test_default_four_rank_async_split_runs(runs):
    """``rollout_trainer_split(n_devices=4)``: the rollout at dp=2 on ranks
    0-1, the update at dp=2 on ranks 2-3 (``trainer-2x1``; the given
    params are real on rank 2 alone), two async steps whose records equal
    the one-rank async trainer's."""
    outs = [r["split"] for r in runs[0][4]]
    assert all(o[:2] == ["rollout-2x1", "trainer-2x1"] for o in outs)
    assert all(o[2] == outs[0][2] for o in outs)
    params = params_from_numpy(_jax_flat("qwen2-0.5b"))
    one = async_records(params, None)
    for a, b in zip(outs[0][2], one):
        for k in ("ret", "ctx", "turn", "lag"):
            assert a[k] == b[k], (k, a, b)
        for k in ("loss", "kl"):
            assert abs(a[k] - b[k]) <= 1e-5, (k, a, b)
    assert [r["lag"] for r in one] == [0, 1]


def test_dp2_tp2_groups_and_trainer(runs):
    """At dp2 x tp2 each data row is a model-axis group ({0, 1}, {2, 3})
    and each model index a data-axis group ({0, 2}, {1, 3}); the sync
    trainer on that mesh (each rank its row's shards through the params
    handoff) gives the one-rank trainer's records."""
    port = runs[0][4]
    for rank, out in enumerate(port):
        row, col = out["groups"]
        assert row == [rank // 2 * 2, rank // 2 * 2 + 1]
        assert col == [rank % 2, rank % 2 + 2]
        assert out["d2t2_train"] == port[0]["d2t2_train"]
    one = async_records(params_from_numpy(_jax_flat("qwen2-0.5b")), None,
                        "sync")
    for a, b in zip(port[0]["d2t2_train"], one):
        for k in ("ret", "ctx", "turn"):
            assert a[k] == b[k], (k, a, b)
        for k in ("loss", "kl"):
            assert abs(a[k] - b[k]) <= 1e-5, (k, a, b)


def test_tp_plan_at_dp2_tp2_replicates_row_shards(smoke):
    """Whole heads within a row, the same shards on every row: rank r of
    dp2 x tp2 holds what rank r % 2 of tp2 holds."""
    from repro_torch.core.resharding import shard_params, tp_plan
    params = {k: torch.randn(d.shape, generator=torch.Generator()
                             .manual_seed(i))
              for i, (k, d) in enumerate(smoke.defs.items())}
    d2t2, tp2 = MeshConfig(**MESHES["d2t2"]), MeshConfig("tp2", 1, 2)
    for rank in range(4):
        plan = tp_plan(smoke, d2t2, rank=rank)
        assert plan.index == rank % 2
        got = shard_params(params, plan)
        want = shard_params(params, tp_plan(smoke, tp2, rank=rank % 2))
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in got)


# ---------------------------------------------------------------------------
# In this process: what still raises, and the pools' layouts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    return build_model(get_smoke_config("qwen2-0.5b"))


@pytest.mark.parametrize("kw", [
    dict(share_prefix=True), dict(on_exhaust="preempt"),
    dict(pool_growth="double"),
    dict(speculation="self", sampling="reference")])
@pytest.mark.parametrize("mesh", ["dp2", "pods2"])
def test_options_still_cite_13_above_one_data_row(smoke, kw, mesh):
    """Above one data row the option check takes every pool option (they
    run in tests/test_torch_dp_options.py): in this world of one rank the
    engine stops at the world check, which names the mesh."""
    with pytest.raises(ValueError, match="ranks 0..1") as e:
        CompiledRolloutEngine(smoke, TicTacToe(), device="cpu",
                              mesh_config=MeshConfig(**MESHES[mesh]), **kw)
    assert f"mesh_config {mesh!r}" in str(e.value)


def test_pool_below_full_provisioning_cites_13(runs):
    """A pool below full provisioning runs at dp=2 on JAX's global page
    count: it drops the one-rank run's writes, and its tokens and counters
    are the one-rank run's."""
    port = runs[0][2]
    one = port[0]["runs"]["below_full_one"]
    held = _held([r["runs"]["below_full"] for r in port], "dp2")
    assert held["tokens"] == one["tokens"]
    for rank in port:
        assert rank["runs"]["below_full"]["stats"] == one["stats"]
    assert dict(zip(STATS, one["stats"]))["kv_dropped_writes"] > 0


def test_no_module_of_the_port_cites_item_13():
    """Every pool option runs across data rows: no module of the port
    refuses one citing ROADMAP item 13."""
    root = os.path.join(REPO, "src", "repro_torch")
    for path, _, files in os.walk(root):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                with open(os.path.join(path, f)) as fh:
                    assert "item 13" not in fh.read(), os.path.join(path, f)


def test_cache_shardings_places_each_rank_pool_with_its_trash_page(smoke):
    """The per-rank pools of a dp=2 run, laid end to end: the page axis
    (two rows' ``n_pages/2`` pages and a trash page each) splits over
    data, each rank's slice its own pool; block tables by row; refcounts
    replicated."""
    cfg = MeshConfig("dp2", 2, 1)
    pool = transformer.init_cache(smoke.cfg, B // 2, 96, layout="paged",
                                  page_size=16, device="meta")
    whole = pool._replace(
        kv=type(pool.kv)(*(torch.empty((x.shape[0], 2 * x.shape[1])
                                       + x.shape[2:], device="meta")
                           if x is not None else None for x in pool.kv)),
        block_table=torch.empty((B,) + pool.block_table.shape[1:],
                                device="meta"))
    lay = cache_shardings(whole, cfg, seq_len=96,
                          n_kv_heads=smoke.cfg.n_kv_heads)
    k = whole.kv.k
    per_rank = pool.kv.k.shape[1]                 # n_pages/2 + its trash
    assert per_rank == B // 2 * 6 + 1
    for rank in (0, 1):
        idx = lay.kv.k.devices_indices_map(k.shape)[rank]
        assert idx[1] == slice(rank * per_rank, (rank + 1) * per_rank)
    assert lay.block_table.spec[0] == "data"
    assert lay.refcount.spec == (None,)
    assert isinstance(lay.kv.k, NamedLayout)
