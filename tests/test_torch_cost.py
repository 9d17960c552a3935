"""The port's cost counter (``repro_torch/utils/cost.py``) against JAX's
HLO cost model (``repro/utils/hlo.py``) and against hand counts.

Tolerances: matmul FLOPs exact (0), and equal to JAX's ``full_cost`` of
the compiled HLO for the smoke qwen2-0.5b's prefill and serve steps; the
LM train step within 0.1% of JAX's (JAX's compiled step counts 524,288
more, 0.04%). Collective
kinds, counts and bytes exact against what rank 0 issues in a real
2-rank gloo run of the same step. Peak and argument bytes exact against a
hand count (each storage rounded up to 512 bytes). Each kernel's fake
branch: exact shapes and dtypes, no launch, counters unmoved, its reported
bytes and FLOPs exactly its ``work``, and its bound at the main path's
shape within 1% of PERF.md's table (whose figures carry 3 significant
digits). The fake-world cases run in subprocesses: a process holds one
default process group.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.core import train_step as jts
from repro.models.registry import build_model as jax_build_model
from repro.optim.adamw import adamw as jax_adamw
from repro.utils import hlo as jhlo
from repro_torch.configs import get_smoke_config
from repro_torch.core.train_step import (make_lm_train_step,
                                         make_prefill_step, make_serve_step)
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.fused_sample import ops as fs_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.spec_verify import ops as sv_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch.mesh import full_opt_state
from repro_torch.models.param import abstract_params
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import adamw
from repro_torch.utils.cost import (CostMode, collective_bytes, count_op,
                                    full_cost)
from repro_torch.utils.roofline import kernel_bound_ms
from test_torch_dispatcher import run_gloo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FAKE_PRELUDE = """
import json
import torch
torch.set_num_threads(1)


def emit(obj):
    print("RESULT " + json.dumps(obj), flush=True)
"""


def run_fake(code: str, timeout: int = 300) -> list:
    """Run ``code`` in a process of its own (a fake world is the process's
    one default group); returns what it ``emit``ted."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-c",
                        FAKE_PRELUDE + textwrap.dedent(code)],
                       capture_output=True, text=True, env=env,
                       timeout=timeout)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    return [json.loads(line[7:]) for line in p.stdout.splitlines()
            if line.startswith("RESULT ")]


# ---------------------------------------------------------------------------
# FLOPs, bytes, peak
# ---------------------------------------------------------------------------

def test_matmul_flops_exact():
    c = full_cost(lambda a, b: a @ b, torch.zeros(128, 256),
                  torch.zeros(256, 512))
    assert c.flops == 2 * 128 * 256 * 512
    assert count_op(c, "mm") == 1
    # each input read once, the output written once
    assert c.bytes_accessed == 4 * (128 * 256 + 256 * 512 + 128 * 512)
    j = jax.jit(lambda a, b: a @ b).lower(
        jax.ShapeDtypeStruct((128, 256), jnp.float32),
        jax.ShapeDtypeStruct((256, 512), jnp.float32)).compile()
    assert jhlo.full_cost(j.as_text()).flops == c.flops


def test_einsum_decomposes_to_counted_matmuls():
    """An einsum and a batched matmul count as the bmm they run."""
    q, k = torch.zeros(2, 16, 4, 32), torch.zeros(2, 24, 4, 32)
    c = full_cost(lambda q, k: torch.einsum("bqhd,bkhd->bhqk", q, k), q, k)
    assert c.flops == 2 * 2 * 4 * 16 * 24 * 32


def test_loop_flops_scale_with_iterations():
    """The counterpart of JAX's trip-count test: an eager loop runs every
    iteration, so n matmuls count n times."""
    def make(n):
        def fn(x, ws):
            for i in range(n):
                x = x @ ws[i]
            return x
        return fn
    x, ws = torch.zeros(64, 64), torch.zeros(16, 64, 64)
    f4 = full_cost(make(4), x, ws).flops
    assert full_cost(make(16), x, ws).flops == 4 * f4 == 16 * 2 * 64 ** 3


def test_peak_bytes_hand_count():
    """params, two f32 moments, a batch and a 60-byte tensor (rounded up to
    one 512-byte block); one matmul, its relu and a scaled copy, the first
    product freed before the copy is made: the peak holds the arguments
    and two products."""
    def fn(params, mu, nu, x, tiny):
        t = x @ params["w"]
        u = t.relu()
        del t
        return u * 2.0

    w = torch.zeros(256, 512)
    args = ({"w": w}, {"w": torch.zeros_like(w)}, {"w": torch.zeros_like(w)},
            torch.zeros(64, 256), torch.zeros(3, 5))
    c = full_cost(fn, *args)
    arg_bytes = 3 * 256 * 512 * 4 + 64 * 256 * 4 + 512
    assert c.argument_bytes == arg_bytes
    assert c.peak_bytes == arg_bytes + 2 * 64 * 512 * 4


def test_views_share_their_storage():
    """A view adds no bytes to the peak and moves none; a tensor outlives
    its name while a view of it lives."""
    def fn(x):
        y = x * 2.0
        v = y.view(-1)
        del y
        return v + 1.0
    c = full_cost(fn, torch.zeros(128, 128))
    n = 128 * 128 * 4
    assert c.peak_bytes == 3 * n
    assert c.bytes_accessed == 4 * n


def _jax_smoke_flops(kind: str) -> float:
    model = jax_build_model(jax_smoke_config("qwen2-0.5b"))
    params = model.abstract()
    toks = jax.ShapeDtypeStruct((4, 128), jnp.int32)
    cache = jax.eval_shape(lambda: model.init_cache(4, 128))
    if kind == "prefill":
        fn, args = jts.make_prefill_step(model), (params, toks, cache)
    elif kind == "serve":
        fn = jts.make_serve_step(model)
        args = (params, jax.ShapeDtypeStruct((4,), jnp.int32), cache)
    else:
        opt = jax_adamw(3e-4)
        fn = jts.make_lm_train_step(model, opt)
        args = (params, jax.eval_shape(opt.init, params), toks, toks)
    return jhlo.full_cost(jax.jit(fn).lower(*args).compile().as_text()).flops


def _torch_smoke_flops(kind: str) -> float:
    model = build_model(get_smoke_config("qwen2-0.5b"))
    with FakeTensorMode():
        params = abstract_params(model.defs, device="cpu")
        toks = torch.empty((4, 128), dtype=torch.int32)
        cache = model.init_cache(4, 128, device="cpu")
        if kind == "prefill":
            fn, args = make_prefill_step(model), (params, toks, cache)
        elif kind == "serve":
            fn, args = make_serve_step(model), (params, toks[:, 0], cache)
        else:
            fn = make_lm_train_step(model, adamw(3e-4))
            args = (params, full_opt_state(params), toks, toks)
        return full_cost(fn, *args).flops


@pytest.mark.parametrize("kind,rel", [("prefill", 0.0), ("serve", 0.0),
                                      ("lm_step", 1e-3)])
def test_smoke_stage_flops_equal_jax(kind, rel):
    """The smoke qwen2-0.5b (B=4, S=128, bf16) on its plain route: the
    traced FLOPs against JAX's ``full_cost`` of the compiled HLO."""
    mine, theirs = _torch_smoke_flops(kind), _jax_smoke_flops(kind)
    assert abs(mine - theirs) <= rel * theirs, (mine, theirs)


# ---------------------------------------------------------------------------
# Collectives on a fake world, against a real gloo run
# ---------------------------------------------------------------------------

# the dp=2 LM step (rank 0's 2 of 4 rows of 64 tokens, the update group)
# and the tp=2 prefill (rank 0's shards, 4 rows of 16 tokens) of the smoke
# qwen2-0.5b in fp32; ``CountOn`` is the counter: on fakes under
# full_cost, on real tensors as a dispatch mode of its own
PROGRAMS = """
import torch.distributed as dist
from repro_torch.configs import get_smoke_config
from repro_torch.core.resharding import MeshConfig, shard_params, tp_plan
from repro_torch.core.train_step import (make_lm_train_step,
                                         make_prefill_step)
from repro_torch.models.registry import build_model
from repro_torch.models.tensor_parallel import TPContext, update_group
from repro_torch.optim.adamw import adamw

model = build_model(get_smoke_config("qwen2-0.5b"))


def programs(params, make):
    dp2, tp2 = MeshConfig("dp2", 2, 1), MeshConfig("tp2", 1, 2)
    group = update_group(dp2)
    opt = adamw(3e-4)
    toks = make((2, 64), torch.int64)
    lm = make_lm_train_step(model, opt)
    yield "dp2_lm_step", (lambda *a: lm(*a, group=group)), (
        params, opt.init(params), toks, toks)
    plan = tp_plan(model, tp2, rank=dist.get_rank())
    tp = TPContext(plan)
    local = dict(shard_params(params, plan))
    cache = model.init_cache(4, 16, dtype=torch.float32, tp=tp)
    yield "tp2_prefill", make_prefill_step(model, tp=tp), (
        local, make((4, 16), torch.int64), cache)


def counts(c):
    return {"bytes": c.collective_by_kind, "count": c.collective_counts,
            "total": c.collective_bytes, "n": c.collective_count}
"""


@pytest.fixture(scope="module")
def fake_collectives():
    (out,) = run_fake(PROGRAMS + """
from repro_torch.models.param import abstract_params
from repro_torch.utils.cost import fake_mode, full_cost, start_fake_world
start_fake_world(2)
res = {}
with fake_mode():
    params = abstract_params(model.defs, dtype=torch.float32, device="cpu")
    make = lambda shape, dt: torch.empty(shape, dtype=dt)
    for name, fn, args in programs(params, make):
        res[name] = counts(full_cost(fn, *args))
# a bare all-reduce and all-gather of 1,024 f32 on a world of 8
start_fake_world(8)
with fake_mode():
    x = torch.empty(1024)
    res["all_reduce"] = counts(full_cost(lambda x: dist.all_reduce(x), x))
    res["all_gather"] = counts(full_cost(
        lambda x: dist.all_gather([torch.empty_like(x) for _ in range(8)],
                                  x), x))
emit(res)
""")
    return out


@pytest.fixture(scope="module")
def gloo_collectives(tmp_path_factory):
    per_rank = run_gloo(PROGRAMS + """
from repro_torch.utils.cost import CostMode
g = torch.Generator().manual_seed(0)
params = model.init(g, dtype=torch.float32)
make = lambda shape, dt: torch.randint(0, model.cfg.vocab_size, shape,
                                       generator=g, dtype=dt)
res = {}
for name, fn, args in programs(params, make):
    mode = CostMode()
    with mode:
        fn(*args)
    res[name] = counts(mode.cost)
emit(res)
""", 2, tmp_path_factory.mktemp("gloo"), timeout=300, pg_timeout=120)
    return per_rank[0][0]


@pytest.mark.parametrize("program", ["dp2_lm_step", "tp2_prefill"])
def test_traced_collectives_equal_a_gloo_run(program, fake_collectives,
                                             gloo_collectives):
    fake, real = fake_collectives[program], gloo_collectives[program]
    assert real["n"] > 0
    assert fake == real


def test_all_reduce_and_all_gather_bytes_exact(fake_collectives):
    """1,024 f32 all-reduced on a fake world of 8: 4,096 bytes, one
    collective; gathered from 8 ranks: the result's 32,768 bytes."""
    ar, ag = fake_collectives["all_reduce"], fake_collectives["all_gather"]
    assert ar == {"bytes": {"all-reduce": 4096}, "count": {"all-reduce": 1},
                  "total": 4096, "n": 1}
    assert ag["bytes"] == {"all-gather": 8 * 4096} and ag["n"] == 1


def test_collective_stats_summarise_a_trace(fake_collectives):
    from repro_torch.utils.cost import FullCost
    c = FullCost(collective_by_kind={"all-reduce": 3 * 2 ** 20},
                 collective_counts={"all-reduce": 2})
    st = collective_bytes(c)
    assert (st.total_bytes, st.total_count) == (3 * 2 ** 20, 2)
    assert st.summary() == "all-reduce: 2x 3.0 MiB"
    assert fake_collectives["dp2_lm_step"]["count"]["all-reduce"] >= 2


# ---------------------------------------------------------------------------
# The kernels' fake branches
# ---------------------------------------------------------------------------

BF16, F32, I32 = torch.bfloat16, torch.float32, torch.int32


def _e(shape, dt=BF16):
    return torch.empty(shape, dtype=dt)


# per kernel: the wrapper call on fakes at the main path's shape (PERF.md
# §6: B=32, qwen2-0.5b's 14/2 heads of 64, 16-token pages, NP=16, V=151,936,
# the update's S=256, mamba2's ssm_score shape), the outputs' shapes and
# dtypes, its ``work`` at the fake's default counts, and at the counts the
# main-path case had on the card (chip_smoke.py's kernel lines: 3,419 live
# paged positions, 4,674 valid decode keys, 4,826 live verify positions and
# 267,568 verify pairs), and PERF.md's bound (ms) for that case
KERNELS = {
    "paged_attention": (
        lambda: pa_ops.paged_decode_attention(
            _e((32, 14, 64)), _e((513, 16, 2, 64)), _e((513, 16, 2, 64)),
            _e((32, 16), I32), _e((32,), I32)),
        [((32, 14, 64), BF16)],
        lambda: pa_ops.work(32, 14, 2, 64, 16, 16, 2, 2, False),
        lambda: pa_ops.work(32, 14, 2, 64, 16, 16, 2, 2, False, 3419),
        0.000557),
    "fused_sample": (
        lambda: fs_ops.fused_sample(_e((32, 151936), F32),
                                    _e((32, 151936), F32)),
        [((32,), I32), ((32,), F32)],
        lambda: fs_ops.work(32, 151936), lambda: fs_ops.work(32, 151936),
        0.0116),
    "fused_sample_partial": (
        lambda: fs_ops.fused_sample_partial(_e((32, 75968), F32),
                                            _e((32, 75968), F32)),
        [((32,), F32)] * 3 + [((32,), I32), ((32,), F32)],
        lambda: fs_ops.work(32, 75968, partial=True),
        lambda: fs_ops.work(32, 75968, partial=True), 0.00581),
    "flash_fwd": (
        lambda: fa_ops.flash_attention_fwd(_e((32, 256, 14, 64)),
                                           _e((32, 256, 2, 64)),
                                           _e((32, 256, 2, 64))),
        [((32, 256, 14, 64), BF16), ((32, 14, 256), F32)],
        lambda: fa_ops.work("fwd", 32, 256, 256, 14, 2, 64, 2),
        lambda: fa_ops.work("fwd", 32, 256, 256, 14, 2, 64, 2), 0.0102),
    "flash_dq": (
        lambda: fa_ops.flash_attention_dq(
            _e((32, 256, 14, 64)), _e((32, 256, 2, 64)),
            _e((32, 256, 2, 64)), _e((32, 256, 14, 64)),
            _e((32, 14, 256), F32), _e((32, 14, 256), F32)),
        [((32, 256, 14, 64), BF16)],
        lambda: fa_ops.work("dq", 32, 256, 256, 14, 2, 64, 2),
        lambda: fa_ops.work("dq", 32, 256, 256, 14, 2, 64, 2), 0.0147),
    "flash_dkv": (
        lambda: fa_ops.flash_attention_dkv(
            _e((32, 256, 14, 64)), _e((32, 256, 2, 64)),
            _e((32, 256, 2, 64)), _e((32, 256, 14, 64)),
            _e((32, 14, 256), F32), _e((32, 14, 256), F32)),
        [((32, 256, 2, 64), BF16)] * 2,
        lambda: fa_ops.work("dkv", 32, 256, 256, 14, 2, 64, 2),
        lambda: fa_ops.work("dkv", 32, 256, 256, 14, 2, 64, 2), 0.0115),
    "decode_attention": (
        lambda: da_ops.decode_attention(
            _e((32, 14, 64)), _e((32, 256, 2, 64)), _e((32, 256, 2, 64)),
            _e((32, 256), torch.bool)),
        [((32, 14, 64), BF16)],
        lambda: da_ops.work(32, 14, 2, 64, 256, 2, 2),
        lambda: da_ops.work(32, 14, 2, 64, 256, 2, 2, 4674), 0.000751),
    "spec_verify": (
        lambda: sv_ops.spec_verify_attention(
            _e((32, 4, 14, 64)), _e((513, 16, 2, 64)), _e((513, 16, 2, 64)),
            _e((32, 16), I32), _e((32,), I32)),
        [((32, 4, 14, 64), BF16)],
        lambda: sv_ops.work(32, 4, 14, 2, 64, 16, 16, 2, 2, False),
        lambda: sv_ops.work(32, 4, 14, 2, 64, 16, 16, 2, 2, False, 4826,
                            267568), 0.000875),
    "ssd_scan": (
        lambda: ssd_ops.ssd_scan(
            _e((32, 512, 32, 64)), _e((32, 512, 32), F32), _e((32,), F32),
            _e((32, 512, 1, 128)), _e((32, 512, 1, 128)), 256),
        [((32, 512, 32, 64), BF16), ((32, 32, 64, 128), F32)],
        lambda: ssd_ops.work(32, 512, 32, 1, 64, 128, 256, 2),
        lambda: ssd_ops.work(32, 512, 32, 1, 64, 128, 256, 2), 0.0532),
}


def _counters():
    return (pa_ops.launches, fs_ops.launches, fs_ops.partial_launches,
            dict(fa_ops.launches), da_ops.launches, sv_ops.launches,
            ssd_ops.launches)


@pytest.mark.parametrize("name", list(KERNELS))
def test_kernel_fake_branch(name):
    call, outs, work_default, work_main, table_ms = KERNELS[name]
    before = _counters()
    with FakeTensorMode():
        holder = {}
        c = full_cost(lambda: holder.setdefault("out", call()))
    got = holder["out"]
    got = list(got) if isinstance(got, tuple) else [got]
    assert [(tuple(t.shape), t.dtype) for t in got] == outs
    assert _counters() == before, "a fake call moved a launch counter"
    assert c.kernels == {name: 1}
    nbytes, flops = work_default()
    assert (c.bytes_accessed, c.flops) == (nbytes, flops)
    ms, by = kernel_bound_ms(*work_main(), f32=name.startswith("fused"))
    assert by == "bytes"
    assert abs(ms / table_ms - 1.0) <= 0.01, (ms, table_ms)


# per kernel: a call the card path refuses for its shapes or dtypes (not
# its pointers), and the error it raises
REFUSED = {
    "paged_attention": (lambda: pa_ops.paged_decode_attention(
        _e((32, 14, 48)), _e((513, 16, 2, 48)), _e((513, 16, 2, 48)),
        _e((32, 16), I32), _e((32,), I32)), ValueError),   # hd % 32
    "fused_sample": (lambda: fs_ops.fused_sample(
        _e((32, 1024)), _e((32, 1024))), TypeError),       # bf16 logits
    "fused_sample_partial": (lambda: fs_ops.fused_sample_partial(
        _e((32, 1024), F32), _e((32, 512), F32)), ValueError),
    "flash_fwd": (lambda: fa_ops.flash_attention_fwd(
        _e((2, 64, 4, 48)), _e((2, 64, 2, 48)), _e((2, 64, 2, 48))),
        ValueError),                                       # head_dim 48
    "flash_fwd_causal": (lambda: fa_ops.flash_attention_fwd(
        _e((2, 64, 4, 64)), _e((2, 32, 2, 64)), _e((2, 32, 2, 64))),
        ValueError),                                       # S > Sk
    "flash_dq": (lambda: fa_ops.flash_attention_dq(
        _e((2, 64, 4, 64)), _e((2, 64, 2, 64)), _e((2, 64, 2, 64)),
        _e((2, 64, 4, 64)), _e((2, 4, 64)), _e((2, 4, 64), F32)),
        ValueError),                                       # bf16 L
    "flash_dkv": (lambda: fa_ops.flash_attention_dkv(
        _e((2, 64, 4, 64)), _e((2, 64, 2, 64)), _e((2, 64, 2, 64)),
        _e((2, 64, 4, 64), F32), _e((2, 4, 64), F32),
        _e((2, 4, 64), F32)), TypeError),                  # f32 dO
    "decode_attention": (lambda: da_ops.decode_attention(
        _e((32, 14, 64)), _e((32, 256, 2, 64)), _e((32, 256, 2, 64)),
        _e((32, 256), I32)), ValueError),                  # int mask
    "spec_verify": (lambda: sv_ops.spec_verify_attention(
        _e((32, 32, 14, 64)), _e((513, 16, 2, 64)), _e((513, 16, 2, 64)),
        _e((32, 16), I32), _e((32,), I32)), ValueError),   # K*group 224
    "ssd_scan": (lambda: ssd_ops.ssd_scan(
        _e((2, 512, 4, 48)), _e((2, 512, 4), F32), _e((4,), F32),
        _e((2, 512, 1, 128)), _e((2, 512, 1, 128)), 256),
        ValueError),                                       # head_dim 48
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_kernel_fake_branch_refuses_what_the_card_refuses(name):
    """A fake call runs the card path's shape and dtype checks before it
    reports a launch, so a trace refuses what the card would."""
    call, error = REFUSED[name]
    before = _counters()
    with FakeTensorMode():
        mode = CostMode()
        with mode, pytest.raises(error):
            call()
    assert mode.cost.kernels == {}
    assert _counters() == before


def test_cpu_tensors_still_take_the_plain_version():
    """A real CPU tensor goes to ref.py: the same values, no launch and
    nothing reported as a kernel."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 32, generator=g)
    k, v = (torch.randn(2, 8, 2, 32, generator=g) for _ in range(2))
    valid = torch.rand(2, 8, generator=g) < 0.7
    mode = CostMode()
    with mode:
        out = da_ops.decode_attention(q, k, v, valid)
    assert mode.cost.kernels == {} and da_ops.launches == 0
    assert torch.equal(out, decode_attention_ref(q, k, v, valid))


def test_fake_flash_backward_reports_both_kernels():
    """The flash autograd.Function's backward on fakes reports its dq and
    dk/dv kernels, beside the forward, and D = rowsum(dO O) as the einsum
    it is."""
    def step(q, k, v):
        q = q.detach().requires_grad_(True)
        out = fa_ops.flash_attention(q, k, v, True, 0)
        return torch.autograd.grad(out.float().sum(), [q])

    with FakeTensorMode():
        q, k = _e((2, 32, 4, 64)), _e((2, 32, 2, 64))
        c = full_cost(step, q, k, k)
    assert c.kernels == {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}
    attn = sum(fa_ops.work(kn, 2, 32, 32, 4, 2, 64, 2)[1]
               for kn in ("fwd", "dq", "dkv"))
    assert c.flops == attn + 2 * 2 * 32 * 4 * 64
