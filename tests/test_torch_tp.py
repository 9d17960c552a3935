"""The tensor-parallel rollout of the port (``models/tensor_parallel.py``,
``core.resharding.tp_plan``/``shard_params``, the engine at tp above 1,
the SPMD trainer) on the CPU, over gloo ranks (one process a rank,
``test_torch_dispatcher.run_gloo``), against JAX's engine on the same
``MeshConfig`` (a subprocess with eight host devices) and against the
port's one-rank run:

- fp32 greedy trajectories at tp=2 and tp=4, on the paged and the dense
  layout with fused and reference sampling: tokens bitwise JAX's and the
  one-rank run's, with JAX's opponent draws injected; log-probs and the
  folded reference's within 1e-5;
- one decode step's logits (the vocab shards gathered) against the
  one-rank step within 1e-5 of their scale;
- a sampled fp32 tp=2 run with injected noise, token for token against
  the one-rank run;
- the tp plan (full-width qwen2-0.5b at tp=2 agrees with
  ``param_shardings``; at tp=4 it replicates attention where
  ``param_shardings`` splits heads in half; the smoke config at tp=4 gives
  each rank one q head and the kv head it reads) and each rank's leaf
  shapes;
- the fused sampler's partial states combined across simulated ranks
  against ``fused_sample_ref`` on the whole row, ties across ranks
  included;
- a two-rank ``EarlTrainer`` whose selector switches tp=1 -> tp=2 at step
  1, its records against the one-rank trainer's within 1e-5;
- the paged-pool options at tp above 1 pass the option check (they run
  in ``tests/test_torch_tp_options.py``), the trainer builds the python
  backend and the async pipeline across ranks, no module of the port
  cites ROADMAP item 14, and dp x tp still cites 13 for the pool options
  that wait on its second part.
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
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.resharding import (MeshConfig, param_shardings,
                                         shard_params, tp_plan)
from repro_torch.kernels.fused_sample import ops as fs_ops
from repro_torch.launch.mesh import rollout_trainer_split
from repro_torch.models import layers as L
from repro_torch.models.registry import build_model
from repro_torch.rl.engine import CompiledRolloutEngine
from repro_torch.rl.envs import TicTacToe

from test_torch_dispatcher import REPO, run_gloo

torch.set_num_threads(1)

KW = dict(kv_dtype="fp32", max_turns=2, max_turn_tokens=3, max_context=96)
B, N = 4, 6
MACRO = KW["max_turns"] * -(-N // B) + 2          # the engine's budget
COMBOS = [("paged", "fused"), ("dense", "reference"), ("paged", "reference"),
          ("dense", "fused")]
# the JAX engine runs two combos at each tp, so each degree covers both
# layouts and both samplers
JAX_RUNS = {2: COMBOS[:2], 4: COMBOS[2:]}

# deterministic draws keyed by (step, kind, macro-step, index), the same
# on every rank and in this process
NOISE_SRC = """
def step_noise(step):
    from repro_torch.rl.engine import common

    def noise(kind, m, index, shape):
        g = torch.Generator().manual_seed(
            (step * 1000 + m * 10 + index) * 3 + ("sample", "env",
                                                  "reset").index(kind))
        u = torch.rand(shape, generator=g).clamp_min(1e-30)
        return common.gumbel_from_uniform(u) if kind == "sample" else \\
            TicTacToe().noise_from_uniform(kind, u)
    return noise
"""
exec(NOISE_SRC)

SELECTOR_SRC = """
def tp_selector(tp2):
    from repro_torch.core.parallelism_selector import (
        ContextBuckets, ParallelismSelector, ProfileEntry)
    a = MeshConfig("tp1", 1, 1)
    b = MeshConfig("tp2", 1, tp2)
    sel = ParallelismSelector(
        [a, b], lambda c, ctx: ProfileEntry(
            c, ctx, 2.0 if (c.name == "tp2") == (ctx > 1) else 1.0, True),
        ContextBuckets((1,)))
    sel.profile()
    return sel


TRAIN = dict(batch_size=4, max_turns=2, max_turn_tokens=3, max_context=96,
             kl_coef=0.05, temperature=1.0, kv_dtype="fp32", device="cpu")


def train_records(params, tp2):
    from repro_torch.core.stages import EarlTrainer
    from repro_torch.optim.adamw import adamw
    model = build_model(get_smoke_config("qwen2-0.5b"))
    tr = EarlTrainer(model=model, env=TicTacToe(), selector=tp_selector(tp2),
                     optimizer=adamw(1e-3, weight_decay=0.0),
                     noise=step_noise, **TRAIN)
    opt = tr.optimizer.init(params)
    ref = params
    out = []
    for step in range(3):
        params, opt, rec = tr.run_step(step, params, opt, ref)
        out.append(dict(loss=rec.loss, kl=rec.kl, ret=rec.mean_return,
                        ctx=rec.mean_context_len, turn=rec.mean_turn_len,
                        sw=rec.selector_switch))
    return out
"""
exec(SELECTOR_SRC)

JAX_CODE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import get_smoke_config
from repro.core.resharding import MeshConfig
from repro.models.registry import build_model
from repro.rl.engine import CompiledRolloutEngine
from repro.rl.envs import make_env
model = build_model(get_smoke_config("qwen2-0.5b"))
params = model.init(jax.random.PRNGKey(0), dtype=jnp.float32)
out, runs = {}, eval(sys.argv[2])
for tp, combos in runs.items():
    for layout, sampling in combos:
        eng = CompiledRolloutEngine(
            model, make_env("tictactoe"), attn_impl="xla",
            cache_layout=layout, sampling=sampling, temperature=0.0,
            mesh_config=MeshConfig(f"tp{tp}", dp=1, tp=tp),
            **eval(sys.argv[3]))
        exp, _ = eng.run(params, jax.random.PRNGKey(1), 4, n_episodes=6)
        out[f"{tp}-{layout}-{sampling}"] = np.asarray(exp.tokens)
np.savez(sys.argv[1], **out)
"""

GLOO_CODE = """
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.core.resharding import MeshConfig, tp_plan
from repro_torch.launch.mesh import rollout_trainer_split
from repro_torch.models import transformer
from repro_torch.models.registry import build_model
from repro_torch.models.tensor_parallel import TPContext
from repro_torch.rl.engine import CompiledRolloutEngine
from repro_torch.rl.envs import TicTacToe
""" + NOISE_SRC + SELECTOR_SRC + """
model = build_model(get_smoke_config("qwen2-0.5b"))
tree = dict(np.load(ARG["params"]))
env_draws = np.load(ARG["env"])
one = MeshConfig("one", 1, 1)
tpm = MeshConfig(f"tp{WORLD}", 1, WORLD)
plan = tp_plan(model, tpm)
local = params_from_numpy(tree, plan=plan)
full = params_from_numpy(tree)
emit({"shapes": {k: list(v.shape) for k, v in local.items()}})


def jax_env_noise(kind, m, index, shape):
    assert kind == "env"
    return torch.from_numpy(env_draws[str(m)])


def rollout(mesh, params, noise_fn=jax_env_noise, **kw):
    eng = CompiledRolloutEngine(model, TicTacToe(), device="cpu",
                                mesh_config=mesh, **ARG["kw"], **kw)
    exp, stats = eng.run(params, 4, 6, ref_params=params, noise=noise_fn)
    return eng, exp


res = {}
for layout, sampling in ARG["combos"]:
    kw = dict(cache_layout=layout, sampling=sampling, temperature=0.0)
    eng, e_tp = rollout(tpm, local, **kw)
    key = f"{layout}-{sampling}"
    lay = eng.experience_shardings.tokens
    res[key] = {"tokens": e_tp.tokens.tolist(),
                "layout": [lay.mesh_config.name, list(lay.spec)]}
    if RANK == 0:
        _, e1 = rollout(one, full, **kw)
        res[key].update(
            one=e1.tokens.tolist(),
            lp=float((e1.logprobs - e_tp.logprobs).abs().max()),
            ref=float((e1.ref_logprobs - e_tp.ref_logprobs).abs().max()))
    else:
        # a rank outside the one-rank mesh takes no part
        eng = CompiledRolloutEngine(model, TicTacToe(), device="cpu",
                                    mesh_config=one, **ARG["kw"])
        exp, stats = eng.run(full, 4, 6)
        assert not eng.in_mesh and stats is None
        assert exp.tokens.device.type == "meta"
emit({"greedy": res})

# one decode step's logits against the one-rank step
ctx = TPContext(plan)
tok = torch.tensor([[1, 5, 9, 40, 2], [3, 3, 200, 511, 7]])
out = {}
for layout in ("paged", "dense"):
    c = transformer.init_cache(model.cfg, 2, 16, layout=layout,
                               kv_dtype="fp32", page_size=4, tp=ctx)
    c1 = transformer.init_cache(model.cfg, 2, 16, layout=layout,
                                kv_dtype="fp32", page_size=4)
    with torch.no_grad():
        _, c = transformer.prefill(model.cfg, local, tok, c, tp=ctx)
        lg, _ = transformer.decode_step(model.cfg, local, tok[:, 0], c,
                                        tp=ctx)
        _, c1 = transformer.prefill(model.cfg, full, tok, c1)
        lg1, _ = transformer.decode_step(model.cfg, full, tok[:, 0], c1)
    g = ctx.gather_row(lg)
    out[layout] = [float((g - lg1).abs().max()), float(lg1.abs().max()),
                   list(lg.shape)]
emit({"logits": out})

if WORLD == 2:
    kw = dict(cache_layout="paged", sampling="fused", temperature=1.0,
              noise_fn=step_noise(7))
    _, e_tp = rollout(tpm, local, **dict(kw))
    if RANK == 0:
        _, e1 = rollout(one, full, **dict(kw))
        emit({"sampled": [bool(torch.equal(e1.tokens, e_tp.tokens)),
                          float((e1.logprobs - e_tp.logprobs).abs().max())]})
    emit({"train": train_records(dict(full), 2)})
else:
    r, t = rollout_trainer_split(n_devices=4, rollout_tp=2)
    eng = CompiledRolloutEngine(model, TicTacToe(), device="cpu",
                                mesh_config=r, temperature=0.0, **ARG["kw"])
    exp, _ = eng.run(full, 4, 6, noise=jax_env_noise)
    emit({"split": [r.name, eng.in_mesh, exp.tokens.device.type,
                    eng.tp.n_heads if eng.tp else None]})
"""


@pytest.fixture(scope="module")
def smoke():
    return build_model(get_smoke_config("qwen2-0.5b"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's tp runs (a subprocess, in the background) and the port's gloo
    runs at 2 and 4 ranks, on the same fp32 weights and opponent draws."""
    tmp = tmp_path_factory.mktemp("tp")
    jmodel = jax_build_model(jax_smoke_config("qwen2-0.5b"))
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    flat = {".".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(jparams)[0]}
    np.savez(tmp / "params.npz", **flat)
    base = jax.random.fold_in(jax.random.PRNGKey(1), 1)
    env = {str(m): np.asarray(jax.random.gumbel(
        jcommon.env_rng(jcommon.turn_rng(base, m)),
        (B, TicTacToe.step_noise_width), jnp.float32)) for m in range(MACRO)}
    np.savez(tmp / "env.npz", **env)
    jenv = dict(os.environ, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=8",
                PYTHONPATH=os.path.join(REPO, "src"))
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_CODE),
         str(tmp / "jax.npz"), repr(JAX_RUNS), repr(KW)], env=jenv,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        arg = dict(params=str(tmp / "params.npz"), env=str(tmp / "env.npz"),
                   kw=KW, combos=COMBOS)
        # the two worlds run side by side, beside JAX
        port, errors = {}, []

        def world(w):
            try:
                port[w] = run_gloo(GLOO_CODE, w, tmp, arg=arg)
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


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("layout,sampling", COMBOS)
def test_greedy_tp_matches_jax_and_one_rank(runs, tp, layout, sampling):
    port, jax_tokens = runs
    key = f"{layout}-{sampling}"
    r0 = port[tp][0]["greedy"][key]
    for rank in port[tp]:                       # replicated on every rank
        assert rank["greedy"][key]["tokens"] == r0["tokens"]
        # the batch on the tp mesh: rows over data (of size 1), so
        # replicated over model
        assert rank["greedy"][key]["layout"] == [f"tp{tp}", ["data", None]]
    np.testing.assert_array_equal(np.array(r0["tokens"]),
                                  np.array(r0["one"]))
    jkey = f"{tp}-{key}"
    if (layout, sampling) in JAX_RUNS[tp]:
        np.testing.assert_array_equal(np.array(r0["tokens"]),
                                      jax_tokens[jkey])
    assert r0["lp"] <= 1e-5 and r0["ref"] <= 1e-5, r0


@pytest.mark.parametrize("tp", [2, 4])
def test_decode_logits_against_one_rank(runs, tp):
    V = get_smoke_config("qwen2-0.5b").vocab_size
    for layout, (err, scale, shape) in runs[0][tp][0]["logits"].items():
        assert shape == [2, V // tp], layout
        assert err <= 1e-5 * scale, (layout, err, scale)


def test_sampled_tp2_matches_one_rank(runs):
    same, lp_err = runs[0][2][0]["sampled"]
    assert same and lp_err <= 1e-5


def test_trainer_switches_tp1_to_tp2(runs):
    """Every rank's records equal the one-rank trainer's (whose selector
    switches between one-device configs of the same names), the switch at
    step 1 in JAX's record format."""
    from repro_torch.bridge import params_from_numpy
    for rank in runs[0][2]:
        assert rank["train"] == runs[0][2][0]["train"]
    two = runs[0][2][0]["train"]
    jmodel = jax_build_model(jax_smoke_config("qwen2-0.5b"))
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    one = train_records(params_from_numpy(jax.tree.map(np.asarray, jparams)),
                        1)
    assert [r["sw"] for r in two] == [r["sw"] for r in one]
    assert two[1]["sw"]["from"] == "tp1" and two[1]["sw"]["to"] == "tp2"
    assert set(two[1]["sw"]) == {"from", "to", "ema_context"}
    for a, b in zip(two, one):
        for k in ("ret", "ctx", "turn"):
            assert a[k] == b[k], (k, a, b)
        for k in ("loss", "kl"):
            assert abs(a[k] - b[k]) <= 1e-5, (k, a, b)


def test_rollout_trainer_split_config_runs(runs):
    """``rollout_trainer_split(rollout_tp=2)`` on four ranks gives a
    rollout config the engine accepts: ranks 0-1 roll out at tp=2, ranks
    2-3 take no part."""
    for rank, out in enumerate(runs[0][4]):
        name, inside, device, heads = out["split"]
        assert name == "rollout-1x2"
        assert inside == (rank < 2)
        assert device == ("cpu" if rank < 2 else "meta")
        assert heads == (2 if rank < 2 else None)


def test_leaf_shapes_on_every_rank(runs, smoke):
    for tp in (2, 4):
        for rank, out in enumerate(runs[0][tp]):
            plan = tp_plan(smoke, MeshConfig(f"tp{tp}", 1, tp), rank=rank)
            want = {k: list(v.shape) for k, v in shard_params(
                {k: torch.zeros(d.shape) for k, d in smoke.defs.items()},
                plan).items()}
            assert out["shapes"] == want


# ---------------------------------------------------------------------------
# The plan, in this process
# ---------------------------------------------------------------------------

def test_plan_full_width_tp2_agrees_with_param_shardings():
    model = build_model(get_config("qwen2-0.5b"))
    mesh = MeshConfig("tp2", 1, 2)
    plan = tp_plan(model, mesh, rank=0)
    ps = param_shardings(model, mesh)
    assert {k: v.spec for k, v in plan.layouts.items()} == \
        {k: v.spec for k, v in ps.items()}
    assert (plan.heads_local, plan.kv_local, plan.d_ff_local,
            plan.vocab_local) == (7, 1, 2432, 75968)
    assert plan.fallbacks == []


def test_plan_full_width_tp4_departs_from_param_shardings():
    """``param_shardings`` cuts qwen2's 14 heads of 64 into 3.5 a rank
    (896 columns by 4) and its two kv heads in half, with no fallback
    recorded; the plan replicates attention and says why."""
    model = build_model(get_config("qwen2-0.5b"))
    mesh = MeshConfig("tp4", 1, 4)
    fb = []
    ps = param_shardings(model, mesh, fallbacks=fb)
    assert fb == []
    assert ps["layers.attn.wq"].spec[-1] == "model"
    assert ps["layers.attn.wk"].spec[-1] == "model"
    plan = tp_plan(model, mesh, rank=3)
    assert (plan.attn, plan.kv) == ("replicated", "replicated")
    assert plan.layouts["layers.attn.wq"].spec[-1] is None
    assert plan.layouts["layers.mlp.w_up"].spec[-1] == "model"
    assert plan.layouts["embedding"].spec[0] == "model"
    assert plan.fallbacks == [("attention", "14 q heads do not divide 4 "
                                            "ways: replicated, its queries "
                                            "split by sequence from 16384 "
                                            "tokens")]
    assert (plan.heads_local, plan.kv_local) == (14, 2)


def test_smoke_plan_tp4_one_q_head_and_the_kv_head_it_reads(smoke):
    cfg = smoke.cfg
    gen = torch.Generator().manual_seed(0)
    params = smoke.init(gen, dtype=torch.float32)
    hd = cfg.head_dim_
    for rank in range(4):
        plan = tp_plan(smoke, MeshConfig("tp4", 1, 4), rank=rank)
        assert (plan.attn, plan.kv) == ("split", "grouped")
        assert (plan.heads_local, plan.kv_local) == (1, 1)
        loc = shard_params(params, plan)
        kvh = rank * cfg.n_kv_heads // 4          # q head rank reads it
        assert kvh == rank // (cfg.n_heads // cfg.n_kv_heads)
        assert torch.equal(loc["layers.attn.wk"],
                           params["layers.attn.wk"][..., kvh * hd:
                                                    (kvh + 1) * hd])
        assert torch.equal(loc["layers.attn.bv"],
                           params["layers.attn.bv"][..., kvh * hd:
                                                    (kvh + 1) * hd])
        assert torch.equal(loc["layers.attn.wq"],
                           params["layers.attn.wq"][..., rank * hd:
                                                    (rank + 1) * hd])
        # the vocab shard is square: (128, 128)
        assert loc["embedding"].shape == (128, 128)


def test_unembed_takes_tied_from_the_caller():
    """A square vocab shard: shape cannot say whether it is the tied
    table; the explicit flag can."""
    g = torch.Generator().manual_seed(0)
    emb = torch.randn(8, 8, generator=g)
    x = torch.randn(2, 1, 8, generator=g)
    torch.testing.assert_close(L.unembed(emb, x, tied=True), x @ emb.T)
    torch.testing.assert_close(L.unembed(emb, x, tied=False), x @ emb)


# ---------------------------------------------------------------------------
# The partial-sample combine, ranks simulated by threads
# ---------------------------------------------------------------------------

def _combine_on_threads(lg, noise, R):
    """Each of ``R`` threads takes one vocab shard's partial state and
    runs ``combine_partials`` with an all-reduce over the threads."""
    V = lg.shape[1]
    Vl = V // R
    barrier = threading.Barrier(R)
    slots = [None] * R
    ops = {"max": lambda ts: torch.stack(ts).amax(0),
           "min": lambda ts: torch.stack(ts).amin(0),
           "sum": lambda ts: sum(ts[1:], ts[0])}
    out = [None] * R

    def reduce_for(r):
        def reduce(t, op):
            slots[r] = t
            barrier.wait()
            res = ops[op](list(slots))
            barrier.wait()
            return res
        return reduce

    def work(r):
        sl = slice(r * Vl, (r + 1) * Vl)
        part = fs_ops.fused_sample_partial(lg[:, sl].contiguous(),
                                           noise[:, sl].contiguous())
        out[r] = fs_ops.combine_partials(*part, r * Vl, reduce_for(r))

    threads = [threading.Thread(target=work, args=(r,)) for r in range(R)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


@pytest.mark.parametrize("R", [2, 4])
@pytest.mark.parametrize("case", ["greedy", "gumbel", "tie_across_ranks"])
def test_partial_combine_matches_fused_sample_ref(R, case):
    g = torch.Generator().manual_seed(R)
    lg = torch.randn(6, 64, generator=g) * 3
    noise = (torch.zeros_like(lg) if case != "gumbel" else
             -torch.log(-torch.log(torch.rand(6, 64, generator=g))))
    if case == "tie_across_ranks":
        # equal best scores in the last shard and in the first: the
        # earliest index wins whatever the shard order
        lg[:, 63] = lg[:, 2] = 50.0
        lg[1, 40] = lg[1, 20] = 60.0
    tok, lp = fs_ops.fused_sample_ref(lg, noise)
    for t, p in _combine_on_threads(lg, noise, R):
        assert torch.equal(t, tok)
        torch.testing.assert_close(p, lp, rtol=0, atol=1e-5)
    if case == "tie_across_ranks":
        assert tok[0] == 2 and tok[1] == 20


# ---------------------------------------------------------------------------
# What the checks take, and what still raises
# ---------------------------------------------------------------------------

TP2 = MeshConfig("tp2", dp=1, tp=2)


@pytest.mark.parametrize("arch,kw", [
    ("qwen2-0.5b", dict(speculation="self", sampling="reference")),
    ("qwen2-0.5b", dict(kv_dtype="int8")),
    ("qwen2-0.5b", dict(share_prefix=True)),
    ("qwen2-0.5b", dict(on_exhaust="preempt")),
    ("qwen2-0.5b", dict(pool_growth="double")),
    # across ranks the trainer takes the python backend and the async
    # pipeline
    ("mamba2-370m", dict(rollout_backend="python")),
    ("granite-moe-3b-a800m", dict(pipeline="async", max_policy_lag=1)),
])
def test_options_pass_the_checks_at_tp_above_one(arch, kw, monkeypatch):
    """The engine's option check takes the paged-pool options at tp=2:
    the engine stops at the world check (this process is a world of one);
    the trainer across ranks builds the python backend (never bound, it
    rolls out on the first rank of the params' mesh: rank 0 before the
    first step) and the async pipeline (bound to the update mesh, rank 0
    without a selector, with the params handoff)."""
    model = build_model(get_smoke_config(arch))
    if "rollout_backend" in kw or "pipeline" in kw:
        from repro_torch.core import stages
        # the trainer across ranks, in a process of its own: the group of
        # several ranks is stood in for
        monkeypatch.setattr(stages, "_spmd", lambda: True)
        tr = stages.EarlTrainer(model=model, env=TicTacToe(), device="cpu",
                                **kw)
        st = tr.rollout_stage
        if "rollout_backend" in kw:
            assert st.place is None and st.home() == 0
            assert not hasattr(tr.rollout, "bind_mesh")
        else:
            assert st.place is not None and st.home is None
            assert tr.rollout.mesh_config.device_offset == 0
        return
    with pytest.raises(ValueError, match="ranks 0..1"):
        CompiledRolloutEngine(model, TicTacToe(), device="cpu",
                              mesh_config=TP2, **kw)


def test_no_module_of_the_port_cites_item_14():
    root = os.path.join(REPO, "src", "repro_torch")
    for path, _, files in os.walk(root):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                with open(os.path.join(path, f)) as fh:
                    assert "item 14" not in fh.read(), os.path.join(path, f)


@pytest.mark.parametrize("kw", [
    dict(share_prefix=True), dict(on_exhaust="preempt"),
    dict(pool_growth="double"),
    dict(speculation="self", sampling="reference")])
def test_dp_above_one_still_cites_13(smoke, kw):
    """dp x tp runs with every pool option (tests/test_torch_dp.py,
    tests/test_torch_dp_options.py): the option check takes each one, and
    in this world of one rank the engine stops at the world check, which
    names the mesh."""
    with pytest.raises(ValueError, match="ranks 0..3") as e:
        CompiledRolloutEngine(smoke, TicTacToe(), device="cpu",
                              mesh_config=MeshConfig("d2t2", dp=2, tp=2),
                              **kw)
    assert "mesh_config 'd2t2'" in str(e.value)


def test_tp_mesh_beyond_the_world_raises(smoke):
    """Without a process group of two ranks a tp=2 mesh does not fit."""
    with pytest.raises(ValueError, match="ranks 0..1"):
        CompiledRolloutEngine(smoke, TicTacToe(), device="cpu",
                              mesh_config=TP2)


def test_rollout_trainer_split_rollout_tp2():
    r, t = rollout_trainer_split(n_devices=4, rollout_tp=2)
    assert (r.dp, r.tp, r.device_offset) == (1, 2, 0)
    assert (t.dp, t.tp, t.device_offset) == (2, 1, 2)
