"""The data-parallel rollout's paged-pool options on the CPU, over gloo
ranks (one process a rank, ``test_torch_dispatcher.run_gloo``), against
JAX's engine on the same ``MeshConfig`` (subprocesses with eight host
devices, in the background) and against the port's one-rank run:

- speculation (``"self"`` and ``"draft"``), prefix sharing on the bandit
  (int8 pages), preemption on a pool under pressure, growth from a small
  pool and a ``cache_pages`` below full provisioning in ``"count"`` mode,
  each at dp=2 and at dp2 x tp2, preemption and the small pool also at
  pods=2, and preemption at dp=3 with B=4 (every row runs all four slots):
  fp32 greedy tokens and every ``RolloutStats`` counter bitwise JAX's,
  with JAX's draws injected (outside preempt mode the concatenation of its
  per-shard folded env draws, inside it the episode-keyed draws), and
  the one-rank run's, log-probs within 1e-5 of the one-rank run's (2e-4
  on int8 pages);
- each pressure run shows its pressure in both packages' counters
  (preemptions, growths, dropped writes, accepted draft tokens), and one
  preempted episode is re-admitted on another data row than the one that
  evicted it;
- each rank's own pool is ``min(global pool, the row's full
  provisioning)`` pages;
- the collectives a turn: one gather at full provisioning, two in
  preempt mode, one more per allocation below full provisioning outside
  preempt mode, one more all-reduce with growth; JAX's dp engines in
  preempt mode give its one-device run;
- two SPMD trainer steps under preemption and growth on a fixed dp2 mesh,
  and with the selector's switch dp2 -> tp2, against the one-rank trainer.

The runs share one global page count: the allocator's, the governor's,
admission's and growth's decisions are JAX's global ones, and each row's
pages stay on the row. Every world starts its process group with a 120 s
timeout, so a hang fails instead of eating the suite's limit.
"""
import os
import subprocess
import sys
import textwrap
import threading

import jax
import numpy as np
import pytest
import torch

from repro.models.paging import pool_pages_needed_shared
from repro.rl.engine import common as jcommon
from repro.rl.envs import make_env as jax_make_env
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.core.resharding import MeshConfig
from repro_torch.models.registry import build_model
from repro_torch.rl.envs import TicTacToe

from test_torch_dispatcher import REPO, run_gloo
from test_torch_dp import _folded
from test_torch_envs import env_draw
from test_torch_tp import NOISE_SRC, SELECTOR_SRC
from test_torch_tp_families import _jax_flat

torch.set_num_threads(1)

B, N = 4, 6
BASE = dict(max_turns=3, max_turn_tokens=4, max_context=96,
            cache_layout="paged", temperature=0.0)
# the non-preempt runs' macro-step budget (the engine's)
MACRO = BASE["max_turns"] * -(-N // B) + 2
ENV_KW = {"tictactoe": {}, "bandit": {"prompt_len": 8}}
# the option runs: TicTacToe's 12-token prompt, or the bandit's 9-token
# one (two shared 4-token pages). The preempt pool is the governor's
# minimum at B=4 (12 pages: it preempts and drains); growth starts from 4
# pages and drops writes until it has grown; "count" keeps 8 pages of the
# 48 the batch needs and drops writes all along
OPTS_SRC = """
def opts(model):
    spec = dict(spec_k=3, sampling="reference", kv_dtype="fp32", page_size=4)
    return {
        "spec": dict(spec, speculation="self", draft_layers=1),
        "draft": dict(spec, speculation="draft", draft_model=model),
        "share": dict(share_prefix=True, kv_dtype="int8", page_size=4,
                      sampling="fused"),
        "preempt": dict(on_exhaust="preempt", share_prefix=True,
                        kv_dtype="fp32", page_size=8, sampling="reference",
                        cache_pages=12),
        "growth": dict(pool_growth="double", pool_growth_max=40,
                       kv_dtype="fp32", page_size=8, sampling="reference",
                       cache_pages=4),
        "count": dict(kv_dtype="fp32", page_size=8, sampling="reference",
                      cache_pages=8),
    }


def env_of(name):
    return "bandit" if name == "share" else "tictactoe"
"""
exec(OPTS_SRC)
NAMES = ["spec", "draft", "share", "preempt", "growth", "count"]
MESHES = {"dp2": dict(name="dp2", dp=2, tp=1),
          "d2t2": dict(name="d2t2", dp=2, tp=2),
          "pods2": dict(name="pods2", dp=1, tp=1, pods=2),
          "dp3": dict(name="dp3", dp=3, tp=1),
          "one": dict(name="one", dp=1, tp=1)}
RUNS = ([(n, m) for m in ("dp2", "d2t2") for n in NAMES]
        + [("preempt", "pods2"), ("count", "pods2"), ("preempt", "dp3")])
# JAX folds the env step's draw per data shard when pods == 1 and dp
# divides B; preempt mode draws by episode, unfolded
FOLD = {"dp2": 2, "d2t2": 2, "pods2": 1, "dp3": 1}
COUNTERS = ("spec_proposed", "spec_accepted", "spec_rounds", "preemptions",
            "requeue_depth", "pool_grows", "shared_prefix_len",
            "kv_dropped_writes", "pages_in_use", "page_capacity",
            "episodes_started", "episodes_returned")
# JAX's runs in three subprocesses of about the same length; JAX's own
# one-device preempt run besides
JAX_SPLIT = [RUNS[:6], RUNS[6:12], RUNS[12:] + [("preempt", "one")]]

JAX_CODE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import get_smoke_config
from repro.core.resharding import MeshConfig
from repro.models.registry import build_model
from repro.rl.engine import CompiledRolloutEngine
from repro.rl.envs import make_env
""" + OPTS_SRC + """
model = build_model(get_smoke_config("qwen2-0.5b"))
params = model.init(jax.random.PRNGKey(0), dtype=jnp.float32)
runs, meshes, base, env_kw, counters = (eval(a) for a in sys.argv[2:7])
out = {}
for name, mesh in runs:
    eng = CompiledRolloutEngine(
        model, make_env(env_of(name), **env_kw[env_of(name)]),
        attn_impl="xla", mesh_config=MeshConfig(**meshes[mesh]), **base,
        **opts(model)[name])
    exp, st = eng.run(params, jax.random.PRNGKey(1), 4, n_episodes=6,
                      **({"draft_params": params} if name == "draft"
                         else {}))
    out[f"{name}-{mesh}-tokens"] = np.asarray(exp.tokens)
    out[f"{name}-{mesh}-counters"] = np.array([int(getattr(st, c))
                                               for c in counters])
np.savez(sys.argv[1], **out)
"""

TRAINER_SRC = """
# the governor's minimum pool (12 pages at B=4), grown once to 16: the
# second turn's four slots need 24, so the governor preempts
PRESSURE = dict(page_size=8, cache_pages=12, on_exhaust="preempt",
                pool_growth="double", pool_growth_max=16)


def dp_selector(world, switch):
    # "dp2" alone, or "dp2" and "tp2" with the switch at step 1, on
    # ``world`` ranks (one-device configs of the same names on one)
    from repro_torch.core.parallelism_selector import (
        ContextBuckets, ParallelismSelector, ProfileEntry)
    cfgs = [MeshConfig("dp2", world, 1)]
    if switch:
        cfgs.append(MeshConfig("tp2", 1, world))
    sel = ParallelismSelector(
        cfgs, lambda c, ctx: ProfileEntry(
            c, ctx, 2.0 if (c.name == "dp2") == (ctx <= 1) else 1.0, True),
        ContextBuckets((1,)))
    sel.profile()
    return sel


def trainer_records(params, world, switch):
    from repro_torch.core.stages import EarlTrainer
    from repro_torch.optim.adamw import adamw
    tr = EarlTrainer(model=build_model(get_smoke_config("qwen2-0.5b")),
                     env=TicTacToe(), selector=dp_selector(world, switch),
                     optimizer=adamw(1e-3, weight_decay=0.0), **TRAIN,
                     **PRESSURE)
    _, _, hist = tr.train(2, params=params,
                          opt_state=tr.optimizer.init(params),
                          ref_params=params)
    return [dict(loss=r.loss, kl=r.kl, ret=r.mean_return,
                 ctx=r.mean_context_len, turn=r.mean_turn_len,
                 sw=r.selector_switch, preempted=r.preemptions,
                 grown=r.pool_grows, capacity=r.page_capacity)
            for r in hist]
"""
exec(NOISE_SRC)
exec(SELECTOR_SRC)
exec(TRAINER_SRC)

GLOO_CODE = """
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.core.resharding import MeshConfig
from repro_torch.models.registry import build_model
from repro_torch.rl.engine import CompiledRolloutEngine
from repro_torch.rl.envs import TicTacToe, make_env
""" + NOISE_SRC + SELECTOR_SRC + OPTS_SRC + TRAINER_SRC + """
model = build_model(get_smoke_config("qwen2-0.5b"))
params = params_from_numpy(dict(np.load(ARG["params"])))
draws = np.load(ARG["draws"])
one = MeshConfig("one", 1, 1)


def jax_noise(env, fold):
    # JAX's draws of the global batch (the env step's folded per data
    # shard when ``fold`` > 1); preempt mode's by episode and env step
    def noise(kind, m, index, shape):
        if isinstance(m, torch.Tensor):
            assert kind == "env"
            return torch.from_numpy(np.concatenate(
                [draws[f"e{e}_t{t}"] for e, t in zip(m.tolist(),
                                                     index.tolist())]))
        assert shape[0] == ARG["B"], shape
        key = (f"{env}{fold}-env-{m}" if kind == "env"
               else f"{env}-reset-{m}")
        return torch.from_numpy(draws[key])
    return noise


# the turns and the data-row collectives of each run: every gather, and
# the all-reduces outside them (``DataRows``; the spec round flag's
# all-reduce is the engine's own)
from repro_torch.rl.engine import compiled as _compiled
CALLS = {"turns": 0, "gather": 0, "sum": 0}


def _counted(cls, name, key):
    orig = getattr(cls, name)

    def call(*a, **kw):
        CALLS[key] += 1
        return orig(*a, **kw)
    setattr(cls, name, call)


_counted(_compiled.CompiledRolloutEngine, "turn_step", "turns")
_counted(_compiled.DataRows, "gather", "gather")
_counted(_compiled.DataRows, "all_reduce_sum", "sum")


def track(eng):
    # each turn's evicted and admitted episode ids on this rank's row
    log = []
    govern, admit = eng._govern, eng._admit

    def governed(c):
        out = govern(c)
        log.append(c.episode[out[2]].tolist())
        return out

    def admitted(c, *a):
        out = admit(c, *a)
        log.append(out[1][out[0]].tolist())
        return out
    eng._govern, eng._admit = governed, admitted
    return log


def rollout(mesh, name, fold):
    env = env_of(name)
    eng = CompiledRolloutEngine(
        model, make_env(env, **ARG["env_kw"][env]), device="cpu",
        mesh_config=mesh, **ARG["base"], **opts(model)[name])
    log = track(eng) if name == "preempt" else None
    CALLS.update(turns=0, gather=0, sum=0)
    exp, st = eng.run(params, ARG["B"], ARG["N"], noise=jax_noise(env, fold),
                      **({"draft_params": params} if name == "draft"
                         else {}))
    if st is None:
        return None
    return dict(tokens=exp.tokens.tolist(), lp=exp.logprobs.tolist(),
                counters=[int(getattr(st, c)) for c in ARG["counters"]],
                pool=eng.rank_pool_pages, log=log,
                calls=[CALLS["turns"], CALLS["gather"],
                       CALLS["sum"] - CALLS["gather"]])


res = {}
for name, mesh in ARG["runs"]:
    cfg = MeshConfig(**ARG["meshes"][mesh])
    if cfg.n_devices == WORLD:
        res[f"{name}-{mesh}"] = rollout(cfg, name, ARG["fold"][mesh])
if WORLD == 2:
    # the one-rank runs fed the same draws, on rank 0
    for name in ARG["names"]:
        for fold in (1, 2) if name == "count" else (2,):
            r = rollout(one, name, fold)
            if r is not None:
                res[f"{name}-one{fold}"] = r
emit({"runs": res})
if WORLD == 2:
    emit({"train": {str(switch): trainer_records(dict(params), 2, switch)
                    for switch in (False, True)}})
"""


def _draws(rng):
    """Every draw the port's runs ask for: by env, fold and macro-step, and
    (preempt mode) by episode and env step."""
    base, brng = jax.random.fold_in(rng, 1), jax.random.fold_in(rng, 2)
    out = {}
    for env, kw in ENV_KW.items():
        jenv = jax_make_env(env, **kw)
        step = lambda key, b, jenv=jenv: env_draw(jenv, "env", key, b)
        for m in range(MACRO):
            key = jcommon.env_rng(jcommon.turn_rng(base, m))
            for fold in (1, 2):
                out[f"{env}{fold}-env-{m}"] = _folded(key, fold, step, B)
            if env == "bandit":
                rkey = jcommon.reset_rng(jcommon.turn_rng(base, m))
                out[f"{env}-reset-{m}"] = np.asarray(
                    env_draw(jenv, "reset", rkey, B))
        if env == "bandit":
            out[f"{env}-reset--1"] = np.asarray(env_draw(jenv, "reset", rng,
                                                         B))
    jenv = jax_make_env("tictactoe")
    for e in range(N + 1):
        for t in range(BASE["max_turns"] + 1):
            out[f"e{e}_t{t}"] = np.asarray(env_draw(
                jenv, "env", jcommon.episode_env_rng(brng, e, t), 1))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's runs (three subprocesses, in the background), the port's gloo
    worlds of 2, 3 and 4 ranks, and the one-rank trainers here."""
    tmp = tmp_path_factory.mktemp("dp_options")
    flat = _jax_flat("qwen2-0.5b")
    np.savez(tmp / "params.npz", **flat)
    np.savez(tmp / "draws.npz", **_draws(jax.random.PRNGKey(1)))
    jenv = dict(os.environ, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=8",
                PYTHONPATH=os.path.join(REPO, "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_CODE),
         str(tmp / f"jax{i}.npz"), repr(part), repr(MESHES), repr(BASE),
         repr(ENV_KW), repr(COUNTERS)], env=jenv, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for i, part in enumerate(JAX_SPLIT)]
    try:
        arg = dict(params=str(tmp / "params.npz"),
                   draws=str(tmp / "draws.npz"), base=BASE, B=B, N=N,
                   env_kw=ENV_KW, counters=list(COUNTERS), names=NAMES,
                   runs=RUNS, meshes=MESHES, fold=FOLD)
        port, errors = {}, []

        def world(w):
            try:
                port[w] = run_gloo(GLOO_CODE, w, tmp, arg=arg, timeout=240,
                                   pg_timeout=120)
            except BaseException as e:        # raised below, in this thread
                errors.append(e)

        threads = [threading.Thread(target=world, args=(w,))
                   for w in (2, 3, 4)]
        for t in threads:
            t.start()
        # the one-rank trainers, in this process, meanwhile
        full = params_from_numpy(flat)
        one = {switch: trainer_records(dict(full), 1, switch)
               for switch in (False, True)}
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        errs = [p.communicate(timeout=600)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-4000:]
    out = {w: [{k: v for d in rank for k, v in d.items()} for rank in r]
           for w, r in port.items()}
    jax_out = {}
    for i, part in enumerate(JAX_SPLIT):
        z = np.load(tmp / f"jax{i}.npz")
        for name, mesh in part:
            jax_out[(name, mesh)] = {k: z[f"{name}-{mesh}-{k}"]
                                     for k in ("tokens", "counters")}
    return out, jax_out, one


def _rows(port, name, mesh):
    """The first rank of each data row's result of the run (a row's tp
    ranks agree), and the batch they hold together."""
    cfg = MeshConfig(**MESHES[mesh])
    ranks = [r["runs"][f"{name}-{mesh}"] for r in port[cfg.n_devices]]
    rows = ranks[::cfg.tp]
    for d, r in enumerate(ranks):
        assert r["tokens"] == rows[d // cfg.tp]["tokens"]
        assert r["counters"] == rows[0]["counters"]
    if len(rows[0]["tokens"]) == N:
        return rows, rows[0]
    return rows, {k: sum((r[k] for r in rows), []) for k in ("tokens", "lp")}


# int8 pages: tp sums the o-proj's and the MLP's partial products in
# another order, and an int8 page rounds each K/V value to a step of its
# vector's absmax / 127, so a last-bit difference can move a stored value
# by a whole step (tests/test_torch_tp_options.py); every fp32 pool stays
# within 1e-6
LP_ATOL = {"share": 2e-4}
# each option's pressure, in its counters
MOVED = {"draft": "spec_accepted", "spec": "spec_rounds",
         "share": "shared_prefix_len", "preempt": "preemptions",
         "growth": "pool_grows", "count": "kv_dropped_writes"}


@pytest.mark.parametrize("name,mesh", RUNS, ids=[f"{n}-{m}" for n, m in RUNS])
def test_option_matches_jax_and_one_rank(runs, name, mesh):
    port, jax_out, _ = runs
    rows, held = _rows(port, name, mesh)
    j = jax_out[(name, mesh)]
    np.testing.assert_array_equal(np.array(held["tokens"]), j["tokens"])
    counters = dict(zip(COUNTERS, rows[0]["counters"]))
    assert rows[0]["counters"] == j["counters"].tolist(), counters
    # the one-rank run fed the same draws (preempt mode's are the same
    # under every fold)
    fold = FOLD[mesh] if name == "count" else 2
    one = port[2][0]["runs"][f"{name}-one{fold}"]
    assert held["tokens"] == one["tokens"]
    assert rows[0]["counters"] == one["counters"]
    np.testing.assert_allclose(np.array(held["lp"]), np.array(one["lp"]),
                               rtol=0, atol=LP_ATOL.get(name, 1e-5))
    assert counters[MOVED[name]] > 0, counters
    assert counters["episodes_returned"] == N
    # full provisioning and the governor drop nothing, in JAX too: no
    # allocation there adds a collective
    if name in ("spec", "draft", "share", "preempt"):
        assert counters["kv_dropped_writes"] == 0, counters
    if name == "growth":
        assert counters["kv_dropped_writes"] > 0, counters


@pytest.mark.parametrize("name,mesh", RUNS, ids=[f"{n}-{m}" for n, m in RUNS])
def test_each_row_pool_is_its_share(runs, name, mesh):
    """A row's own pool: the global pool, capped at what the row's slots
    can map (its own copy of the shared run included); the whole pool
    where the row runs every slot."""
    port, jax_out, _ = runs
    rows, _ = _rows(port, name, mesh)
    cfg = MeshConfig(**MESHES[mesh])
    D = cfg.dp * cfg.pods
    j = dict(zip(COUNTERS, jax_out[(name, mesh)]["counters"]))
    glob = j["page_capacity"]                 # grown, where it grew
    full = pool_pages_needed_shared(B // D, BASE["max_context"],
                                    j["shared_prefix_len"],
                                    opts(None)[name]["page_size"])
    want = glob if B % D else min(glob, full)
    for r in rows:
        assert r["pool"] == want, (r["pool"], glob, full)


def test_full_provisioning_pool_is_half_at_dp2(runs):
    """At full provisioning (the speculative runs) each of the two rows
    holds half of JAX's global pool, and the stats report the global
    pool."""
    port, jax_out, _ = runs
    for name in ("spec", "draft"):
        rows, _ = _rows(port, name, "dp2")
        glob = dict(zip(COUNTERS, jax_out[(name, "dp2")]["counters"]))[
            "page_capacity"]
        assert glob == B * -(-BASE["max_context"] // 4)
        assert all(2 * r["pool"] == glob for r in rows)


def test_jax_dp_preempt_is_its_one_device_run(runs):
    """JAX draws preempt mode's env noise by episode, unfolded: its dp
    engines give its one-device engine's tokens and counters."""
    _, jax_out, _ = runs
    one = jax_out[("preempt", "one")]
    for mesh in ("dp2", "d2t2", "pods2", "dp3"):
        j = jax_out[("preempt", mesh)]
        np.testing.assert_array_equal(j["tokens"], one["tokens"])
        assert j["counters"].tolist() == one["counters"].tolist(), mesh


@pytest.mark.parametrize("mesh", ["dp2", "d2t2"])
def test_collectives_a_turn(runs, mesh):
    """At full provisioning (speculation, sharing) a turn makes one gather
    across the rows, preempt mode two, and no decode step adds one; a pool
    below full provisioning outside preempt mode gathers at every
    allocation; growth adds one all-reduce a turn; the run's store
    exchange is the one other all-reduce."""
    port = runs[0]
    for name in NAMES:
        rows, _ = _rows(port, name, mesh)
        turns, gathers, sums = rows[0]["calls"]
        assert turns > 0
        if name in ("spec", "draft", "share"):
            assert (gathers, sums) == (turns, 1), (name, rows[0]["calls"])
        elif name == "preempt":
            assert (gathers, sums) == (2 * turns, 1), rows[0]["calls"]
        else:
            assert gathers > turns * BASE["max_turn_tokens"], rows[0]["calls"]
            assert sums == (turns + 1 if name == "growth" else 1), \
                (name, rows[0]["calls"])


@pytest.mark.parametrize("mesh", ["dp2", "d2t2", "pods2"])
def test_preempted_episode_readmitted_on_another_row(runs, mesh):
    """The governor and admission run on the global batch: an episode
    evicted on one data row is re-admitted on another."""
    rows, _ = _rows(runs[0], "preempt", mesh)
    logs = [r["log"] for r in rows]
    moved = set()
    for t in range(0, len(logs[0]), 2):
        for src, log in enumerate(logs):
            for e in log[t]:
                # the first admission of ``e`` after its eviction
                later = [(u, dst) for dst, lg in enumerate(logs)
                         for u in range(t + 1, len(lg), 2) if e in lg[u]]
                if later and min(later)[1] != src:
                    moved.add(e)
    assert moved, logs


@pytest.mark.parametrize("switch", [False, True], ids=["dp2", "dp2_to_tp2"])
def test_trainer_under_pressure_across_two_ranks(runs, switch):
    """Two SPMD trainer steps under preemption and growth, the rollout on
    dp2 (and on tp2 at step 1 after the selector's switch), sampled from
    the trainer's own generator: the records equal the one-rank trainer's
    (losses within 1e-5), on both ranks, and the pool shows its
    pressure."""
    port, _, one = runs
    two = [r["train"][str(switch)] for r in port[2]]
    assert two[0] == two[1]
    for a, b in zip(two[0], one[switch]):
        for k in ("ret", "ctx", "turn", "sw", "preempted", "grown",
                  "capacity"):
            assert a[k] == b[k], (k, a, b)
        for k in ("loss", "kl"):
            assert abs(a[k] - b[k]) <= 1e-5, (k, a, b)
    for r in two[0]:
        assert r["preempted"] > 0 and r["grown"] > 0, r
    if switch:
        assert two[0][1]["sw"]["from"] == "dp2"
        assert two[0][1]["sw"]["to"] == "tp2"
