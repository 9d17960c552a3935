"""The tensor-parallel rollout of the moe, ssm and hybrid families on the
CPU (``core.resharding.tp_plan`` for granite-moe-3b-a800m, mamba2-370m and
zamba2-1.2b, the models at ``tp=``, the engine and the SPMD trainer),
over gloo ranks (one process a rank, ``test_torch_dispatcher.run_gloo``),
against JAX's engine on the same ``MeshConfig`` (one subprocess a family,
eight host devices) and against the port's one-rank run. Both sides run
fp32 params on f32 caches (the families' ``init_cache`` swapped, as
``tests/test_torch_moe.py`` does):

- fp32 greedy trajectories at tp=2 and tp=4 on the dense layout with
  fused and reference sampling: tokens bitwise JAX's and the one-rank
  run's, with JAX's opponent draws injected; log-probs and the folded
  reference's within 1e-5;
- one decode step's logits after a prefill (the vocab shards gathered)
  against the one-rank step within 1e-5 of their scale, and at bf16
  within one bf16 rounding of it;
- the units against the one-rank functions on the same inputs:
  ``mamba_mixer_decode`` (the gated norm's all-reduce), ``moe_mlp_dense``
  and ``moe_mlp`` under both dispatches with the capacity dropping
  tokens (the same drops on every rank);
- the plans: each rank's leaf shapes, granite's expert leaves at full
  width against ``param_shardings`` and its odd vocab's fallback, grok's
  experts falling back to ``d_ff_expert``, mamba2's departure from
  ``param_shardings`` (whole heads; ``in_proj`` and the conv carried
  whole and cut) with the bytes carried to each rank, zamba2's counts;
- a two-rank ``EarlTrainer`` on the moe smoke config whose selector
  switches tp=1 -> tp=2 at step 1, its records against the one-rank
  trainer's within 1e-5;
- two-rank worlds in the same processes, after a four-rank one was
  destroyed, run a tp=2 decode step (``model_group``'s cache belongs to
  the world that made it).
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
                                         shard_bytes, shard_params, tp_plan)
from repro_torch.models.registry import build_model
from repro_torch.rl.envs import TicTacToe

from test_torch_dispatcher import REPO, run_gloo
from test_torch_tp import NOISE_SRC, SELECTOR_SRC

torch.set_num_threads(1)

ARCHS = ["granite-moe-3b-a800m", "mamba2-370m", "zamba2-1.2b"]
SAMPLERS = ["fused", "reference"]
KW = dict(max_turns=2, max_turn_tokens=3, max_context=96)
B, N = 4, 6
MACRO = KW["max_turns"] * -(-N // B) + 2          # the engine's budget

# each family's model on f32 caches (the families' caches take no
# kv_dtype; JAX's compiled engine cannot run fp32 mamba2 on bf16 ones)
F32_SRC = """
def f32_model(arch):
    import dataclasses
    from repro_torch.models import hybrid, mamba, moe
    ic = {"moe": moe.init_cache, "ssm": mamba.init_cache,
          "hybrid": hybrid.init_cache}
    model = build_model(get_smoke_config(arch))
    fam = ic[model.cfg.family]
    return dataclasses.replace(
        model, _init_cache=lambda cfg, b, s, dtype=None, *, device=None,
        tp=None: fam(cfg, b, s, torch.float32, device=device, tp=tp))


MOE_TRAIN = dict(batch_size=4, max_turns=2, max_turn_tokens=3,
                 max_context=96, kl_coef=0.05, temperature=1.0,
                 device="cpu")


def moe_train_records(params, tp2):
    from repro_torch.core.stages import EarlTrainer
    from repro_torch.optim.adamw import adamw
    tr = EarlTrainer(model=f32_model("granite-moe-3b-a800m"),
                     env=TicTacToe(), selector=tp_selector(tp2),
                     optimizer=adamw(1e-3, weight_decay=0.0),
                     noise=step_noise, **MOE_TRAIN)
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

JAX_CODE = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import get_smoke_config
from repro.core.resharding import MeshConfig
from repro.models import hybrid, mamba, moe
from repro.models.registry import build_model
from repro.rl.engine import CompiledRolloutEngine
from repro.rl.envs import make_env
arch = sys.argv[2]
ic = {"moe": moe.init_cache, "ssm": mamba.init_cache,
      "hybrid": hybrid.init_cache}
model = build_model(get_smoke_config(arch))
fam = ic[model.cfg.family]
model = dataclasses.replace(model, _init_cache=lambda cfg, b, s, dtype=None:
                            fam(cfg, b, s, jnp.float32))
params = model.init(jax.random.PRNGKey(0), dtype=jnp.float32)
out = {}
for tp in (2, 4):
    for sampling in eval(sys.argv[3]):
        eng = CompiledRolloutEngine(
            model, make_env("tictactoe"), attn_impl="xla",
            cache_layout="dense", sampling=sampling, temperature=0.0,
            mesh_config=MeshConfig(f"tp{tp}", dp=1, tp=tp),
            **eval(sys.argv[4]))
        exp, _ = eng.run(params, jax.random.PRNGKey(1), 4, n_episodes=6)
        out[f"{tp}-{sampling}"] = np.asarray(exp.tokens)
np.savez(sys.argv[1], **out)
"""

GLOO_CODE = """
import dataclasses
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.core.resharding import MeshConfig, shard_params, tp_plan
from repro_torch.models import mamba, moe
from repro_torch.models.registry import build_model
from repro_torch.models.tensor_parallel import TPContext, model_group
from repro_torch.models.transformer import layer_params
from repro_torch.rl.engine import CompiledRolloutEngine
from repro_torch.rl.envs import TicTacToe
""" + NOISE_SRC + SELECTOR_SRC + F32_SRC + """
env_draws = np.load(ARG["env"])
tpm = MeshConfig(f"tp{WORLD}", 1, WORLD)


def jax_env_noise(kind, m, index, shape):
    assert kind == "env"
    return torch.from_numpy(env_draws[str(m)])


def err(a, b):
    return float((a - b).abs().max())


def decode_logits(model, local, full, ctx):
    # a prefill and one decode step, the shards gathered, against one rank
    tok = torch.tensor([[1, 5, 9, 40, 2], [3, 3, 200, 511, 7]])
    c = model.init_cache(2, 16, device="cpu", tp=ctx)
    c1 = model.init_cache(2, 16, device="cpu")
    with torch.no_grad():
        _, c = model.prefill(local, tok, c, tp=ctx)
        lg, _ = model.decode_step(local, tok[:, 0], c, tp=ctx)
        _, c1 = model.prefill(full, tok, c1)
        lg1, _ = model.decode_step(full, tok[:, 0], c1)
    return [err(ctx.gather_row(lg), lg1), float(lg1.abs().max()),
            list(lg.shape)]


trees = {}
for arch in ARG["archs"]:
    model = f32_model(arch)
    trees[arch] = tree = dict(np.load(ARG["params"][arch]))
    plan = tp_plan(model, tpm)
    local = params_from_numpy(tree, plan=plan)
    full = params_from_numpy(tree)
    res = {"shapes": {k: list(v.shape) for k, v in local.items()},
           "fallbacks": [list(f) for f in plan.fallbacks]}
    for sampling in ARG["samplers"]:
        kw = dict(cache_layout="dense", sampling=sampling, temperature=0.0,
                  device="cpu", **ARG["kw"])
        eng = CompiledRolloutEngine(model, TicTacToe(), mesh_config=tpm,
                                    **kw)
        e_tp, st = eng.run(local, 4, 6, ref_params=local,
                           noise=jax_env_noise)
        r = {"tokens": e_tp.tokens.tolist(), "returned":
             st.episodes_returned}
        if RANK == 0:
            e1, _ = CompiledRolloutEngine(model, TicTacToe(), **kw).run(
                full, 4, 6, ref_params=full, noise=jax_env_noise)
            r.update(one=e1.tokens.tolist(),
                     lp=err(e1.logprobs, e_tp.logprobs),
                     ref=err(e1.ref_logprobs, e_tp.ref_logprobs))
        res[sampling] = r
    res["logits"] = decode_logits(model, local, full, eng.tp)
    # bf16 params and caches: each partial sum is summed in f32 and
    # rounded once, as the one-rank product is
    to16 = lambda t: {k: v.bfloat16() for k, v in t.items()}
    res["logits_bf16"] = decode_logits(
        build_model(get_smoke_config(arch)), to16(local), to16(full),
        eng.tp)
    emit({arch: res})

# the units, on layer 0 of each family's params
g = torch.Generator().manual_seed(7)
model = f32_model("mamba2-370m")
cfg, ctx = model.cfg, TPContext(tp_plan(model, tpm))
full = params_from_numpy(trees["mamba2-370m"])
pl = layer_params(shard_params(full, ctx.plan), 0)["mixer"]
pf = layer_params(full, 0)["mixer"]
s = cfg.ssm
conv_ch = s.n_heads * s.head_dim + 2 * s.n_groups * s.state_size
x = torch.randn(3, 1, cfg.d_model, generator=g)
conv = torch.randn(3, s.conv_width - 1, conv_ch, generator=g)
ssm = torch.randn(3, s.n_heads, s.head_dim, s.state_size, generator=g)
cols = ctx.plan.ssm_columns(proj=False)
h0 = RANK * ctx.ssm_heads
with torch.no_grad():
    out, c_tp, s_tp = mamba.mamba_mixer_decode(
        cfg, pl, x, conv[..., cols], ssm[:, h0:h0 + ctx.ssm_heads], ctx)
    out1, c1, s1 = mamba.mamba_mixer_decode(cfg, pf, x, conv, ssm)
emit({"mamba_decode": [err(out, out1), float(out1.abs().max()),
                       err(c_tp, c1[..., cols]), float(c1.abs().max()),
                       err(s_tp, s1[:, h0:h0 + ctx.ssm_heads]),
                       float(s1.abs().max())]})

model = f32_model("granite-moe-3b-a800m")
full = params_from_numpy(trees["granite-moe-3b-a800m"])
ctx = TPContext(tp_plan(model, tpm))
pl = layer_params(shard_params(full, ctx.plan), 0)["moe"]
pf = layer_params(full, 0)["moe"]
x = torch.randn(2, 8, model.cfg.d_model, generator=g)
units = {}
with torch.no_grad():
    a, _ = moe.moe_mlp_dense(model.cfg, pl, x[:, :1], ctx)
    b, _ = moe.moe_mlp_dense(model.cfg, pf, x[:, :1])
    units["dense"] = [err(a, b), float(b.abs().max())]
    for dispatch in ("onehot", "scatter"):
        cfg = dataclasses.replace(
            model.cfg, moe_dispatch=dispatch, moe=dataclasses.replace(
                model.cfg.moe, capacity_factor=0.5))
        a, _ = moe.moe_mlp(cfg, pl, x, ctx)
        b, _ = moe.moe_mlp(cfg, pf, x)
        in_cap = moe._route(cfg, pl, x)[3]
        in_cap1 = moe._route(cfg, pf, x)[3]
        units[dispatch] = [err(a, b), float(b.abs().max()),
                           bool(torch.equal(in_cap, in_cap1)),
                           int((~in_cap).sum()), in_cap.flatten().tolist()]
emit({"moe_units": units})

if WORLD == 2:
    emit({"train": moe_train_records(
        params_from_numpy(trees["granite-moe-3b-a800m"]), 2)})
else:
    # second worlds in the same processes, after the first is destroyed:
    # ranks 2 and 3 lie outside the first world's tp=2 group of ranks 0
    # and 1, and become ranks 0 and 1 of a world of their own, where
    # model_group must not hand out what the first world gave them
    model_group(MeshConfig("tp2", 1, 2))
    dist.barrier()
    dist.destroy_process_group()
    dist.init_process_group("gloo", store=dist.FileStore(
        f"{sys.argv[3]}_pair{RANK // 2}", 2), rank=RANK % 2, world_size=2)
    model = f32_model("mamba2-370m")
    plan = tp_plan(model, MeshConfig("tp2", 1, 2))
    emit({"second_world": decode_logits(
        model, params_from_numpy(trees["mamba2-370m"], plan=plan),
        params_from_numpy(trees["mamba2-370m"]), TPContext(plan))})
"""


def _jax_flat(arch):
    jmodel = jax_build_model(jax_smoke_config(arch))
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    return {".".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(jparams)[0]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's tp runs (one subprocess a family, in the background) and the
    port's gloo runs at 2 and 4 ranks, on the same fp32 weights and
    opponent draws."""
    tmp = tmp_path_factory.mktemp("tpf")
    params = {}
    for arch in ARCHS:
        params[arch] = str(tmp / f"{arch}.npz")
        np.savez(params[arch], **_jax_flat(arch))
    base = jax.random.fold_in(jax.random.PRNGKey(1), 1)
    env = {str(m): np.asarray(jax.random.gumbel(
        jcommon.env_rng(jcommon.turn_rng(base, m)),
        (B, TicTacToe.step_noise_width), jnp.float32)) for m in range(MACRO)}
    np.savez(tmp / "env.npz", **env)
    jenv = dict(os.environ, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=8",
                PYTHONPATH=os.path.join(REPO, "src"))
    jax_procs = {arch: subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_CODE),
         str(tmp / f"jax-{arch}.npz"), arch, repr(SAMPLERS), repr(KW)],
        env=jenv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for arch in ARCHS}
    try:
        arg = dict(params=params, env=str(tmp / "env.npz"), kw=KW,
                   archs=ARCHS, samplers=SAMPLERS)
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
        jax_tokens = {}
        for arch, proc in jax_procs.items():
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-4000:]
            jax_tokens[arch] = dict(np.load(tmp / f"jax-{arch}.npz"))
    finally:
        for proc in jax_procs.values():
            if proc.poll() is None:
                proc.kill()
    out = {w: [{k: v for d in rank for k, v in d.items()} for rank in r]
           for w, r in port.items()}
    return out, jax_tokens


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("sampling", SAMPLERS)
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tp_matches_jax_and_one_rank(runs, arch, tp, sampling):
    port, jax_tokens = runs
    r0 = port[tp][0][arch][sampling]
    for rank in port[tp]:                       # replicated on every rank
        assert rank[arch][sampling]["tokens"] == r0["tokens"]
        assert rank[arch][sampling]["returned"] == N
    np.testing.assert_array_equal(np.array(r0["tokens"]),
                                  np.array(r0["one"]))
    np.testing.assert_array_equal(np.array(r0["tokens"]),
                                  jax_tokens[arch][f"{tp}-{sampling}"])
    assert r0["lp"] <= 1e-5 and r0["ref"] <= 1e-5, r0


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_logits_against_one_rank(runs, arch, tp):
    V = get_smoke_config(arch).vocab_size
    err, scale, shape = runs[0][tp][0][arch]["logits"]
    assert shape == [2, V // tp]
    assert err <= 1e-5 * scale, (err, scale)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_decode_logits_against_one_rank(runs, arch, tp):
    """At bf16 the tp step rounds each partial sum once, after the f32
    all-reduce, as the one-rank product rounds once: the gathered logits
    stay within one bf16 rounding of the scale of the one-rank step's."""
    err, scale, shape = runs[0][tp][0][arch]["logits_bf16"]
    assert err <= 2.0 ** -8 * scale, (err, scale)


@pytest.mark.parametrize("tp", [2, 4])
def test_mamba_mixer_decode_units(runs, tp):
    """The mixer on each rank's heads: the output (the gated norm's sum of
    squares and ``out_proj`` all-reduced) and the rank's slices of the
    conv window and the SSM state, against the one-rank mixer."""
    for rank in runs[0][tp]:
        out_err, scale, conv_err, conv_scale, ssm_err, ssm_scale = \
            rank["mamba_decode"]
        assert out_err <= 1e-5 * scale, (out_err, scale)
        assert conv_err <= 1e-5 * conv_scale, (conv_err, conv_scale)
        assert ssm_err <= 1e-5 * ssm_scale, (ssm_err, ssm_scale)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("unit", ["dense", "onehot", "scatter"])
def test_moe_units_and_identical_drops(runs, tp, unit):
    """``moe_mlp_dense`` and ``moe_mlp`` (capacity factor 0.5: tokens are
    dropped) on each rank's experts against the one-rank layer: every
    rank routes the whole group and drops the same tokens."""
    ranks = runs[0][tp]
    for rank in ranks:
        u = rank["moe_units"][unit]
        assert u[0] <= 1e-5 * u[1], u[:2]
        if unit != "dense":
            assert u[2] and u[3] > 0
            assert u[4] == ranks[0]["moe_units"][unit][4]


def test_trainer_switches_tp1_to_tp2(runs):
    """Both ranks' records equal the one-rank trainer's (whose selector
    switches between one-device configs of the same names), the switch at
    step 1 in JAX's record format."""
    from repro_torch.bridge import params_from_numpy
    ns = {"build_model": build_model, "get_smoke_config": get_smoke_config,
          "MeshConfig": MeshConfig, "TicTacToe": TicTacToe, "torch": torch}
    exec(NOISE_SRC + SELECTOR_SRC + F32_SRC, ns)
    two = runs[0][2][0]["train"]
    for rank in runs[0][2]:
        assert rank["train"] == two
    one = ns["moe_train_records"](params_from_numpy(
        _jax_flat("granite-moe-3b-a800m")), 1)
    assert [r["sw"] for r in two] == [r["sw"] for r in one]
    assert two[1]["sw"]["from"] == "tp1" and two[1]["sw"]["to"] == "tp2"
    for a, b in zip(two, one):
        for k in ("ret", "ctx", "turn"):
            assert a[k] == b[k], (k, a, b)
        for k in ("loss", "kl"):
            assert abs(a[k] - b[k]) <= 1e-5, (k, a, b)


def test_second_world_in_the_same_process(runs):
    """After ``destroy_process_group`` the four ranks form two new
    two-rank worlds, and each runs a tp=2 prefill and decode step:
    ``model_group`` made the new worlds' groups instead of handing out the
    destroyed world's (to ranks 2 and 3, its non-member placeholder)."""
    V = get_smoke_config("mamba2-370m").vocab_size
    for rank in runs[0][4]:
        err, scale, shape = rank["second_world"]
        assert shape == [2, V // 2]
        assert err <= 1e-5 * scale


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_shapes_and_fallbacks_on_every_rank(runs, arch, tp):
    model = build_model(get_smoke_config(arch))
    zeros = {k: torch.zeros(d.shape) for k, d in model.defs.items()}
    for rank, out in enumerate(runs[0][tp]):
        plan = tp_plan(model, MeshConfig(f"tp{tp}", 1, tp), rank=rank)
        want = {k: list(v.shape) for k, v in
                shard_params(zeros, plan).items()}
        assert out[arch]["shapes"] == want
        # the smoke configs divide every way at 2 and 4 ranks
        assert out[arch]["fallbacks"] == []


# ---------------------------------------------------------------------------
# The plans, in this process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,tp,want", [
    # one q head, a grouped kv head and one expert a rank
    ("granite-moe-3b-a800m", 4, dict(heads_local=1, kv_local=1,
                                     experts_local=1, kv="grouped")),
    ("granite-moe-3b-a800m", 2, dict(heads_local=2, kv_local=1,
                                     experts_local=2, kv="split")),
    ("mamba2-370m", 4, dict(ssm_heads_local=2, ssm_groups_local=1,
                            attn="replicated", mlp_split=False)),
    ("zamba2-1.2b", 4, dict(heads_local=1, kv_local=1, ssm_heads_local=2,
                            d_ff_local=64)),
])
def test_smoke_plan_counts(arch, tp, want):
    plan = tp_plan(build_model(get_smoke_config(arch)),
                   MeshConfig(f"tp{tp}", 1, tp), rank=tp - 1)
    assert {k: getattr(plan, k) for k in want} == want


def test_plan_granite_full_width_tp2():
    """The expert leaves agree with ``param_shardings`` leaf for leaf (20
    whole experts a rank); the router departs (replicated, so every rank
    routes every token); 49,155 vocab rows do not divide 2 ways."""
    model = build_model(get_config("granite-moe-3b-a800m"))
    mesh = MeshConfig("tp2", 1, 2)
    plan = tp_plan(model, mesh, rank=1)
    ps = param_shardings(model, mesh)
    experts = [k for k in model.defs if k.startswith("layers.moe.w_")]
    assert len(experts) == 3
    for k in experts:
        assert plan.layouts[k].spec == ps[k].spec, k
    assert plan.layouts["layers.moe.w_gate"].spec == (None, "model", None,
                                                      None)
    assert ps["layers.moe.router"].spec[-1] == "model"
    assert plan.layouts["layers.moe.router"].spec == (None, None, None)
    assert (plan.experts, plan.experts_local, plan.expert_offset()) == (
        "split", 20, 20)
    assert (plan.attn, plan.kv, plan.heads_local, plan.kv_local) == (
        "split", "split", 12, 4)
    assert not plan.vocab_split and plan.vocab_local == 49155
    assert plan.layouts["embedding"].spec == (None, None)
    assert plan.fallbacks == [("vocab", "49155 rows do not divide 2 ways")]


def test_plan_grok_experts_fall_back_to_d_ff_expert():
    """grok-1's 8 experts do not divide 16 ways (JAX's rule says so too):
    every rank keeps all 8 on a 1/16 slice of ``d_ff_expert``, as
    ``param_shardings`` lays them out."""
    model = build_model(get_config("grok-1-314b"))
    mesh = MeshConfig("tp16", 1, 16)
    plan = tp_plan(model, mesh, rank=3)
    ps = param_shardings(model, mesh)
    for k in ("layers.moe.w_gate", "layers.moe.w_up", "layers.moe.w_down"):
        assert plan.layouts[k].spec == ps[k].spec, k
    assert (plan.experts, plan.experts_local, plan.d_ff_expert_local) == (
        "mlp", 8, 2048)
    assert ("experts", "8 experts do not divide 16 ways: each expert's "
                       "d_ff_expert 32768 splits instead") in plan.fallbacks


def test_plan_mamba2_full_width_tp2_departs_from_param_shardings():
    """``param_shardings`` cuts the flat 4,384-wide ``in_proj`` in two
    halves of 2,192 (across ``z | xBC | dt``) and replicates the per-head
    leaves; the plan puts 16 whole heads on each rank, carries ``in_proj``
    and the conv whole and keeps the rank's 2,320 and 1,280 columns."""
    model = build_model(get_config("mamba2-370m"))
    mesh = MeshConfig("tp2", 1, 2)
    ps = param_shardings(model, mesh)
    assert ps["layers.mixer.in_proj"].spec[-1] == "model"
    assert ps["layers.mixer.in_proj"].devices_indices_map(
        model.defs["layers.mixer.in_proj"].shape)[1][-1] == slice(2192, 4384)
    assert ps["layers.mixer.A_log"].spec[-1] is None
    plan = tp_plan(model, mesh, rank=1)
    assert (plan.ssm_split, plan.ssm_heads_local, plan.ssm_groups_local) \
        == (True, 16, 1)
    for k in ("in_proj", "conv_w", "conv_b"):
        assert set(plan.layouts[f"layers.mixer.{k}"].spec) == {None}, k
    for k in ("A_log", "D", "dt_bias", "norm_w"):
        assert plan.layouts[f"layers.mixer.{k}"].spec == (None, "model"), k
    assert plan.layouts["layers.mixer.out_proj"].spec == (None, "model",
                                                          None)
    assert len(plan.ssm_columns()) == 2320
    assert len(plan.ssm_columns(proj=False)) == 1280
    assert plan.fallbacks == []
    # bf16 bytes a rank receives (the dispatcher's move) and keeps (after
    # the cut): in_proj, conv_w and conv_b travel whole
    shapes = {k: torch.empty(d.shape, dtype=torch.bfloat16, device="meta")
              for k, d in model.defs.items()}
    L, D = 48, 1024
    kept_want = 2 * (L * (D * 2320 + 4 * 1280 + 1280 + 3 * 16 + 1024
                          + 1024 * D + D) + 25140 * D + D)
    for rank in (0, 1):
        carried, kept = shard_bytes(shapes, tp_plan(model, mesh, rank=rank))
        assert kept == kept_want
        assert carried - kept == 2 * L * (D * (4384 - 2320)
                                          + 5 * (2304 - 1280))


def test_ssm_columns_are_the_heads_slices():
    """A rank's ``in_proj`` columns are its heads' ``z``, ``x`` and
    ``dt`` and every ``B``/``C`` column (one group), in that order."""
    model = build_model(get_smoke_config("mamba2-370m"))
    s = model.cfg.ssm
    P, N, H = s.head_dim, s.state_size, s.n_heads
    di = H * P
    w = torch.arange(di * 2 + 2 * N + H, dtype=torch.float32)[None, :]
    for rank in range(4):
        plan = tp_plan(model, MeshConfig("tp4", 1, 4), rank=rank)
        h0, hl = rank * 2, 2
        want = torch.cat([w[:, h0 * P:(h0 + hl) * P],
                          w[:, di + h0 * P:di + (h0 + hl) * P],
                          w[:, 2 * di:2 * di + 2 * N],
                          w[:, 2 * di + 2 * N + h0:2 * di + 2 * N + h0 + hl]],
                         dim=1)
        got = w.index_select(-1, plan.ssm_columns())
        assert torch.equal(got, want)


def test_plan_zamba2_full_width_tp2():
    model = build_model(get_config("zamba2-1.2b"))
    plan = tp_plan(model, MeshConfig("tp2", 1, 2), rank=0)
    assert (plan.heads_local, plan.kv_local, plan.d_ff_local,
            plan.ssm_heads_local, plan.vocab_local) == (16, 16, 4096, 32,
                                                        16000)
    assert plan.layouts["shared_attn.attn.wq"].spec == (None, "model")
    assert plan.layouts["shared_attn.mlp.w_down"].spec == ("model", None)
    assert set(plan.layouts["layers.mixer.in_proj"].spec) == {None}
    assert plan.fallbacks == []
