"""The tensor-parallel rollout's paged-pool options and the SPMD trainer's
python backend and async pipeline, on the CPU over gloo ranks (one process
a rank, ``test_torch_dispatcher.run_gloo``):

- each of speculation (``"self"`` and ``"draft"``), int8 pages, prefix
  sharing, preemption and pool growth at tp=2 and tp=4 on the smoke qwen2
  (2 q heads and 1 kv head a rank at tp=2; 1 q head and the kv head it
  reads at tp=4): fp32 greedy tokens bitwise JAX's tp engine's on the same
  ``MeshConfig`` (subprocesses with eight host devices, JAX's opponent
  draws injected) and the port's one-rank run's, log-probs within 1e-5,
  and the counters (spec rounds, proposed and accepted; preemptions,
  growths, shared pages) equal, on every rank;
- ``bind_mesh`` re-shards a live engine with these options (tp=2 -> one
  rank -> tp=2) and rolls out the same tokens;
- the python backend, the async pipeline and an async ``update@2`` fault
  with checkpoints across two ranks (the rollout at tp=2 after the
  selector's switch, the update on both ranks of its tp=2 config,
  replicated): records equal to the one-rank run's (tokens the update saw
  and policy lags bitwise, losses within 1e-5) on both ranks.

Every world starts its process group with a 120 s timeout, so a hang
fails instead of eating the suite's limit.
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
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.core.resharding import MeshConfig
from repro_torch.models.registry import build_model
from repro_torch.rl.envs import TicTacToe

from test_torch_dispatcher import REPO, run_gloo
from test_torch_tp import NOISE_SRC, SELECTOR_SRC

torch.set_num_threads(1)

B, N = 4, 6
BASE = dict(max_turns=3, max_turn_tokens=4, max_context=96,
            cache_layout="paged", temperature=0.0)
# the option runs, on TicTacToe (its 12-token prompt is its shared
# prefix: two 4-token pages, one 8-token page). ``model`` is the package's
# own, the draft model of ``"draft"``. The preempt pool is the governor's
# minimum (12 pages: it preempts, and drains); growth starts from 4 pages
# and drops writes until it has grown, in both packages.
OPTS_SRC = """
def opts(model):
    spec = dict(spec_k=3, sampling="reference", kv_dtype="fp32", page_size=4)
    return {
        "spec": dict(spec, speculation="self", draft_layers=1),
        "draft": dict(spec, speculation="draft", draft_model=model),
        "int8": dict(kv_dtype="int8", page_size=8, sampling="fused"),
        "share": dict(share_prefix=True, kv_dtype="fp32", page_size=4,
                      sampling="fused"),
        "preempt": dict(on_exhaust="preempt", share_prefix=True,
                        kv_dtype="fp32", page_size=8, sampling="reference",
                        cache_pages=12),
        "growth": dict(pool_growth="double", pool_growth_max=40,
                       kv_dtype="fp32", page_size=8, sampling="reference",
                       cache_pages=4),
    }
"""
exec(OPTS_SRC)
NAMES = list(opts(None))
COUNTERS = ("spec_proposed", "spec_accepted", "spec_rounds", "preemptions",
            "requeue_depth", "pool_grows", "shared_prefix_len",
            "kv_dropped_writes", "pages_in_use", "page_capacity",
            "episodes_returned")
# JAX's runs in four subprocesses of about the same length
JAX_SPLIT = [(tp, names) for tp in (2, 4)
             for names in (["spec", "int8", "preempt"],
                           ["draft", "share", "growth"])]

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
tp, names = int(sys.argv[2]), sys.argv[3].split(",")
base, counters = eval(sys.argv[4]), eval(sys.argv[5])
out = {}
for name in names:
    eng = CompiledRolloutEngine(
        model, make_env("tictactoe"), attn_impl="xla",
        mesh_config=MeshConfig(f"tp{tp}", dp=1, tp=tp), **base,
        **opts(model)[name])
    exp, st = eng.run(params, jax.random.PRNGKey(1), 4, n_episodes=6,
                      **({"draft_params": params} if name == "draft"
                         else {}))
    out[f"{name}-tokens"] = np.asarray(exp.tokens)
    out[f"{name}-logprobs"] = np.asarray(exp.logprobs)
    out[f"{name}-counters"] = np.array([int(getattr(st, c))
                                        for c in counters])
np.savez(sys.argv[1], **out)
"""

GLOO_CODE = """
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.core.resharding import MeshConfig, tp_plan
from repro_torch.models.registry import build_model
from repro_torch.rl.engine import CompiledRolloutEngine
from repro_torch.rl.envs import TicTacToe
""" + NOISE_SRC + SELECTOR_SRC + OPTS_SRC + """
model = build_model(get_smoke_config("qwen2-0.5b"))
tree = dict(np.load(ARG["params"]))
draws = np.load(ARG["draws"])
one = MeshConfig("one", 1, 1)
tpm = MeshConfig(f"tp{WORLD}", 1, WORLD)
local = params_from_numpy(tree, plan=tp_plan(model, tpm))
full = params_from_numpy(tree)


def jax_noise(kind, m, index, shape):
    # greedy, and TicTacToe's reset takes no draw: only the opponent's
    assert kind == "env"
    if isinstance(m, torch.Tensor):          # preempt: keyed by episode
        return torch.from_numpy(np.concatenate(
            [draws[f"e{e}_t{t}"] for e, t in zip(m.tolist(),
                                                 index.tolist())]))
    return torch.from_numpy(draws[f"m{m}"])


def rollout(eng, params, name):
    extra = {"draft_params": full} if name == "draft" else {}
    exp, st = eng.run(params, 4, 6, noise=jax_noise, **extra)
    if st is None:
        return None
    return {"tokens": exp.tokens.tolist(), "logprobs": exp.logprobs.tolist(),
            "counters": [int(getattr(st, c)) for c in ARG["counters"]]}


def engine(mesh, name):
    return CompiledRolloutEngine(model, TicTacToe(), device="cpu",
                                 mesh_config=mesh, **ARG["base"],
                                 **opts(model)[name])


res = {}
for name in ARG["names"]:
    res[name] = {"tp": rollout(engine(tpm, name), local, name)}
    if RANK == 0:
        res[name]["one"] = rollout(engine(one, name), full, name)
emit({"options": res})

if WORLD == 2:
    # bind_mesh re-shards a live engine: tp=2, one rank, tp=2 again
    bound = {}
    for name in ("draft", "growth"):
        eng = engine(tpm, name)
        runs = [rollout(eng, full, name)]
        eng.bind_mesh(one)
        runs.append(rollout(eng, full, name))
        eng.bind_mesh(tpm)
        runs.append(rollout(eng, full, name))
        bound[name] = runs
    emit({"bound": bound})

    for case, kw in ARG["trainers"].items():
        if "checkpoint_every" in kw:
            from repro_torch.utils.faults import FaultInjector
            kw = dict(kw, faults=FaultInjector.parse(["update@2"]),
                      checkpoint_dir=ARG["ckpt"])
        emit({case: trainer_run(dict(full), 2, **kw)})
"""

TRAINER_SRC = """
def trainer_run(params, tp2, steps, **kw):
    from repro_torch.core.stages import EarlTrainer
    from repro_torch.optim.adamw import adamw
    model = build_model(get_smoke_config("qwen2-0.5b"))
    train = dict(TRAIN)
    if kw.get("rollout_backend") == "python":
        train.pop("kv_dtype")            # its dense cache is bf16
    tr = EarlTrainer(model=model, env=TicTacToe(), selector=tp_selector(tp2),
                     optimizer=adamw(1e-3, weight_decay=0.0),
                     noise=step_noise, **train, **kw)
    seen = []
    inner = tr.update_stage
    tr.update_stage = lambda p, o, e, **kw: (seen.append(e.tokens.tolist()),
                                             inner(p, o, e, **kw))[1]
    _, _, hist = tr.train(steps, params=params,
                          opt_state=tr.optimizer.init(params),
                          ref_params=params)
    return {"records": [dict(step=r.step, loss=r.loss, kl=r.kl,
                             ret=r.mean_return, ctx=r.mean_context_len,
                             turn=r.mean_turn_len, lag=r.policy_lag,
                             sw=r.selector_switch) for r in hist],
            "tokens": seen}
"""
exec(NOISE_SRC)
exec(SELECTOR_SRC)
exec(TRAINER_SRC)
GLOO_CODE = GLOO_CODE.replace("res = {}\n", TRAINER_SRC + "\nres = {}\n", 1)

TRAINERS = {
    "python": dict(steps=3, rollout_backend="python"),
    "async": dict(steps=3, pipeline="async", max_policy_lag=1),
    "async_fault": dict(steps=5, pipeline="async", max_policy_lag=1,
                        max_retries=1, retry_backoff_s=0.0,
                        checkpoint_every=1),
}


def _draws():
    """JAX's opponent draws for ``run(params, PRNGKey(1), 4, n_episodes=6)``
    in the port's noise layout: by macro-step, and (preempt) by episode
    and env step."""
    rng = jax.random.PRNGKey(1)
    base, brng = jax.random.fold_in(rng, 1), jax.random.fold_in(rng, 2)
    width = TicTacToe.step_noise_width
    out = {}
    max_macro = (BASE["max_turns"] + 2) * (N + B) + 8
    for m in range(max_macro):
        out[f"m{m}"] = np.asarray(jax.random.gumbel(
            jcommon.env_rng(jcommon.turn_rng(base, m)), (B, width),
            jnp.float32))
    for e in range(N + 1):
        for t in range(BASE["max_turns"] + 1):
            out[f"e{e}_t{t}"] = np.asarray(jax.random.gumbel(
                jcommon.episode_env_rng(brng, e, t), (1, width),
                jnp.float32))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's tp runs (four subprocesses, in the background), the port's
    gloo worlds of 2 and 4 ranks, and the one-rank trainers here."""
    tmp = tmp_path_factory.mktemp("tp_options")
    jmodel = jax_build_model(jax_smoke_config("qwen2-0.5b"))
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    flat = {".".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(jparams)[0]}
    np.savez(tmp / "params.npz", **flat)
    np.savez(tmp / "draws.npz", **_draws())
    jenv = dict(os.environ, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=8",
                PYTHONPATH=os.path.join(REPO, "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_CODE),
         str(tmp / f"jax{i}.npz"), str(tp), ",".join(names), repr(BASE),
         repr(COUNTERS)], env=jenv, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for i, (tp, names) in enumerate(JAX_SPLIT)]
    try:
        arg = dict(params=str(tmp / "params.npz"),
                   draws=str(tmp / "draws.npz"), base=BASE,
                   counters=list(COUNTERS), names=NAMES,
                   trainers=TRAINERS, ckpt=str(tmp / "ck"))
        port, errors = {}, []

        def world(w):
            try:
                port[w] = run_gloo(GLOO_CODE, w, tmp, arg=arg, timeout=240,
                                   pg_timeout=120)
            except BaseException as e:        # raised below, in this thread
                errors.append(e)

        threads = [threading.Thread(target=world, args=(w,)) for w in (2, 4)]
        for t in threads:
            t.start()
        # the one-rank trainers, in this process, meanwhile
        full = params_from_numpy(flat)
        one = {}
        for case, kw in TRAINERS.items():
            if "checkpoint_every" in kw:
                from repro_torch.utils.faults import FaultInjector
                kw = dict(kw, faults=FaultInjector.parse(["update@2"]),
                          checkpoint_dir=str(tmp / "ck_one"))
            one[case] = trainer_run(dict(full), 1, **kw)
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
    for i, (tp, names) in enumerate(JAX_SPLIT):
        z = np.load(tmp / f"jax{i}.npz")
        for name in names:
            jax_out[(tp, name)] = {k: z[f"{name}-{k}"] for k in
                                   ("tokens", "logprobs", "counters")}
    return out, jax_out, one


# int8 pages: tp sums the o-proj's and the MLP's partial products in
# another order (last-bit differences in the residual stream), and an int8
# page rounds each K/V value to a step of its vector's absmax / 127, so a
# last-bit difference can move a stored value by a whole step. JAX's own
# tp=2 and tp=4 engines lie 2.4e-5 from the one-rank run on these inputs,
# the port's tp=2 8.6e-5; every fp32 pool stays within 1e-6.
LP_ATOL = {"int8": 2e-4}


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", NAMES)
def test_option_tp_matches_jax_and_one_rank(runs, tp, name):
    port, jax_out, _ = runs
    r0 = port[tp][0]["options"][name]
    for rank in port[tp]:                   # replicated on every rank
        assert rank["options"][name]["tp"] == r0["tp"]
    mine, one, j = r0["tp"], r0["one"], jax_out[(tp, name)]
    np.testing.assert_array_equal(np.array(mine["tokens"]), j["tokens"])
    assert mine["tokens"] == one["tokens"]
    for ref in (np.array(one["logprobs"]), j["logprobs"]):
        np.testing.assert_allclose(np.array(mine["logprobs"]), ref,
                                   rtol=0, atol=LP_ATOL.get(name, 1e-5))
    counters = dict(zip(COUNTERS, mine["counters"]))
    assert mine["counters"] == one["counters"] == j["counters"].tolist(), \
        counters
    # each option's own counters move
    moved = {"spec": "spec_rounds", "draft": "spec_accepted",
             "share": "shared_prefix_len", "preempt": "preemptions",
             "growth": "pool_grows"}.get(name)
    if moved is not None:
        assert counters[moved] > 0, counters
    assert counters["episodes_returned"] == N


@pytest.mark.parametrize("name", ["draft", "growth"])
def test_bind_mesh_reshards_a_live_engine(runs, name):
    for rank, out in enumerate(runs[0][2]):
        tp_a, alone, tp_b = out["bound"][name]
        assert tp_a == tp_b
        # rank 1 lies outside the one-rank mesh
        if rank == 1:
            assert alone is None
            continue
        for k in ("tokens", "counters"):
            assert alone[k] == tp_a[k], k
        np.testing.assert_allclose(np.array(alone["logprobs"]),
                                   np.array(tp_a["logprobs"]), rtol=0,
                                   atol=1e-5)


def _assert_records_equal(two, one):
    assert [r["step"] for r in two] == [r["step"] for r in one]
    for a, b in zip(two, one):
        for k in ("ret", "ctx", "turn", "lag", "sw"):
            assert a[k] == b[k], (k, a, b)
        for k in ("loss", "kl"):
            assert abs(a[k] - b[k]) <= 1e-5, (k, a, b)


@pytest.mark.parametrize("case", list(TRAINERS))
def test_trainer_across_two_ranks_matches_one_rank(runs, case):
    """Both ranks keep the one-rank run's records. Hook ② moves the
    update to the selector's tp=2 config from step 0 (the EMA it reads
    already holds step 0's rollout), where it runs on both ranks,
    replicated over the model axis as GSPMD runs JAX's: each saw the
    one-rank run's batches. The selector switches the rollout to tp=2 at
    step 1: the python engine stays unbound and rolls out on rank 0, and
    the switch row is recorded."""
    port, _, one = runs
    r0 = port[2][0][case]
    for rank in port[2]:
        _assert_records_equal(rank[case]["records"], one[case]["records"])
    assert r0["tokens"] == one[case]["tokens"]
    assert port[2][1][case]["tokens"] == r0["tokens"]
    recs = r0["records"]
    assert recs[1]["sw"]["from"] == "tp1" and recs[1]["sw"]["to"] == "tp2"
    lags = [r["lag"] for r in recs]
    if case == "async":
        assert lags == [0, 1, 1]
    elif case == "async_fault":
        # the restart at step 2 resumes on the restored version
        assert [r["step"] for r in recs] == [0, 1, 2, 3, 4]
        assert lags == [0, 1, 0, 1, 1]
    else:
        assert lags == [0, 0, 0]
