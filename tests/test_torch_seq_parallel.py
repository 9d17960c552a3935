"""Sequence-parallel attention in the port (``models/layers.seq_parallel``,
JAX's ``models/layers._maybe_seq_parallel``) and the flash forward's query
offset, against JAX.

- The flash forward's plain version (``ref.attention_fwd_ref``) and the
  wrapper's CPU route at ``q_offset`` equal the matching rows of the whole
  sequence's evaluation, and the same rows of JAX's
  ``kernels/flash_attention/ref.py``, within 1e-6 of the output scale at
  fp32, with and without a window, at offsets that are and are not a
  multiple of the kernel's 64-row q tile. ``valid_pairs`` counts the
  mask's pairs at an offset exactly, and ``work`` reads K/V over the
  mask's live keys only; the wrapper refuses an offset where
  autograd would record the call, and (on fakes, as on the card) past the
  last key.
- The gate: JAX's own ``_maybe_seq_parallel`` (its ambient mesh stubbed)
  decides the table's JAX cases, and the port's ``seq_parallel`` agrees;
  the port's uneven-kv fallback also splits (JAX shards those heads).
- A gloo world of 3 ranks on the smoke qwen2-0.5b, granite-moe-3b-a800m
  and zamba2-1.2b (4 q heads on 3 ranks: every plan replicates
  attention), with ``SEQ_PARALLEL_MIN_S`` lowered in the ranks to S=96:
  the dense prefill, the paged prefill (qwen2) and ``forward(tp=)``
  (qwen2), on the "xla" and "flash" routes, match the same world with the
  split off, in cache and logits, within 1e-6 of the scale; every rank's
  results are one. They come out bitwise equal: on this CPU the split's
  fewer query rows round no row differently. At fp32 they lie within
  1e-5 of the scale of JAX's one-device ``prefill`` (dense and paged) on
  bridged weights, with equal greedy tokens. The ranks gather one
  sequence slice per attention layer.
- The cost counter sees the split: a traced split prefill (a fake world of
  3, its last rank) reports each flash forward at ``ops.work`` at the
  rank's offset, and the dry run's qwen2-0.5b prefill_32k on (16, 16)
  traces rank 15, whose 24 forwards do the last 2,048 of 32,768 rows'
  pairs, 31/256 of the whole causal count.
"""
import dataclasses
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.kernels.flash_attention.ref import attention_ref as jax_attention
from repro.models import hybrid as jhybrid
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models.registry import build_model as jax_build_model
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.resharding import MeshConfig, tp_plan
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (allowed_mask,
                                                     attention_fwd_ref)
from repro_torch.models import layers
from repro_torch.models.tensor_parallel import TPContext
from test_torch_cost import run_fake
from test_torch_dispatcher import run_gloo

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# The flash forward at a query offset
# ---------------------------------------------------------------------------

# two rows of 144 queries over 144 keys, 8/2 heads of 32
S_FULL = 144


@pytest.fixture(scope="module")
def qkv():
    rs = np.random.RandomState(3)
    q = rs.standard_normal((2, S_FULL, 8, 32)).astype(np.float32)
    k, v = (rs.standard_normal((2, S_FULL, 2, 32)).astype(np.float32)
            for _ in range(2))
    return q, k, v


# (offset, rows): a rank's contiguous share, one past a 64-row q tile and
# two that are not tile multiples
@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("offset,rows", [(0, 48), (48, 48), (96, 48),
                                         (64, 80), (13, 29), (101, 43)])
def test_offset_rows_equal_the_whole_sequence(qkv, window, offset, rows):
    q, k, v = (torch.from_numpy(x) for x in qkv)
    full, L = attention_fwd_ref(q, k, v, True, window)
    jfull = np.asarray(jax_attention(*(jnp.asarray(x) for x in qkv),
                                     causal=True, window=window))
    part = q[:, offset:offset + rows].contiguous()
    want = full[:, offset:offset + rows]
    out, Lp = attention_fwd_ref(part, k, v, True, window, offset)
    wrapped, Lw = fa_ops.flash_attention_fwd(part, k, v, True, window,
                                             q_offset=offset)
    with torch.no_grad():
        applied = fa_ops.flash_attention(part, k, v, True, window,
                                         q_offset=offset)
    s = float(full.abs().max())
    for got in (out, wrapped, applied):
        assert float((got - want).abs().max()) <= 1e-6 * s
        assert float(np.abs(got.numpy() - jfull[:, offset:offset + rows])
                     .max()) <= 1e-6 * s
    for got in (Lp, Lw):
        assert float((got - L[:, :, offset:offset + rows]).abs().max()) \
            <= 1e-6 * float(L.abs().max())


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 7),
                                           (True, 200), (False, 0),
                                           (False, 9)])
@pytest.mark.parametrize("S,Sk,offset", [(16, 64, 0), (16, 64, 48),
                                         (33, 100, 5), (40, 96, 56),
                                         (1, 64, 63)])
def test_valid_pairs_count_the_mask_at_an_offset(causal, window, S, Sk,
                                                 offset):
    """The pairs are the mask's; the bytes read K and V only over the keys
    some row attends (the mask's live columns: at (16, 64, 0) causal, 16
    of 64), and dk/dv are written over all Sk."""
    mask = allowed_mask(S, Sk, causal, window, q_offset=offset)
    n, keys = int(mask.sum()), int(mask.any(dim=0).sum())
    assert fa_ops.valid_pairs(S, Sk, causal, window, offset) == n
    assert fa_ops.key_span(S, Sk, causal, window, offset) == keys
    qb, kvr, kvb, lb = (2 * S * 6 * 64 * 2, 2 * keys * 2 * 64 * 2,
                        2 * Sk * 2 * 64 * 2, 2 * 6 * S * 4)
    args = ("fwd", 2, S, Sk, 6, 2, 64, 2, causal, window, offset)
    assert fa_ops.work(*args) == (2 * qb + 2 * kvr + lb,
                                  4 * 64 * 2 * 6 * n)
    assert fa_ops.work("dq", *args[1:])[0] == 3 * qb + 2 * kvr + 2 * lb
    assert fa_ops.work("dkv", *args[1:])[0] == (2 * qb + 2 * kvr
                                                + 2 * kvb + 2 * lb)


def test_offset_refused_where_autograd_records(qkv):
    """The backward kernels take no offset: a call that autograd would
    record raises and names the item that adds it; under no_grad, or
    with inputs that take no gradient, it runs."""
    q, k, v = (torch.from_numpy(x) for x in qkv)
    part = q[:, 48:96].clone().requires_grad_(True)
    with pytest.raises(ValueError, match="item 20, second part"):
        fa_ops.flash_attention(part, k, v, True, 0, q_offset=48)
    with torch.no_grad():
        fa_ops.flash_attention(part, k, v, True, 0, q_offset=48)
    fa_ops.flash_attention(part.detach(), k, v, True, 0, q_offset=48)
    fa_ops.flash_attention(q.requires_grad_(True), k, v).sum().backward()


@pytest.mark.parametrize("offset", [-1, 97])
def test_offset_past_the_last_key_refused_on_fakes(offset):
    """The fake branch refuses what the card refuses: 48 rows from 97
    would reach key 144 of 144 keys, and an offset below 0."""
    with FakeTensorMode():
        q = torch.empty((2, 48, 8, 64), dtype=torch.bfloat16)
        k = torch.empty((2, S_FULL, 2, 64), dtype=torch.bfloat16)
        fa_ops.flash_attention_fwd(q, k, k, True, 0, q_offset=96)
        with pytest.raises(ValueError, match="q_offset"):
            fa_ops.flash_attention_fwd(q, k, k, True, 0, q_offset=offset)


# ---------------------------------------------------------------------------
# The gate against JAX's
# ---------------------------------------------------------------------------

def _tp(cfg, tp: int, rank: int = 0) -> TPContext:
    """Rank ``rank``'s tp context of ``cfg`` on a 1 x ``tp`` mesh, with a
    stand-in group: the gate reads only the plan."""
    return TPContext(tp_plan(cfg, MeshConfig(f"tp{tp}", 1, tp), rank=rank),
                     group=object())


class _Mesh:
    axis_names = ("data", "model")

    def __init__(self, tp):
        self.shape = {"data": 1, "model": tp}


def _jax_splits(monkeypatch, n_heads: int, tp: int, S: int) -> bool:
    """JAX's ``_maybe_seq_parallel`` on a (1, tp) mesh: whether it
    constrains q's sequence to the model axis."""
    monkeypatch.setattr(jlayers, "_ambient_mesh", lambda: _Mesh(tp))
    monkeypatch.setattr(jlayers, "constrain", lambda q, *axes: "split")
    return isinstance(jlayers._maybe_seq_parallel(np.zeros((1, S, 1, 1)),
                                                  n_heads), str)


# qwen2-0.5b's 14 q heads: (tp, S)
@pytest.mark.parametrize("tp,S,splits", [
    (4, 16384, True),        # the heads do not divide: split
    (2, 16384, False),       # 14 heads divide 2 ways: heads split instead
    (4, 16383, False),       # below JAX's threshold
    (4, 16386, False),       # tp does not divide S
    (4, 32768, True),
    (1, 32768, False)])
def test_gate_table_matches_jax(monkeypatch, tp, S, splits):
    cfg = get_config("qwen2-0.5b")
    assert _jax_splits(monkeypatch, cfg.n_heads, tp, S) == splits
    assert layers.seq_parallel(_tp(cfg, tp), S) == splits
    assert layers.SEQ_PARALLEL_MIN_S == 16384


def test_gate_splits_the_uneven_kv_fallback(monkeypatch):
    """12 q heads and 3 kv heads on 4 ranks: the q heads divide (JAX
    shards them and does not split), but a rank's 3 q heads would read
    two kv heads unevenly, so the port's plan replicates attention and
    its queries split by sequence; its fallback says so."""
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), n_heads=12,
                              n_kv_heads=3, head_dim=64)
    tp = _tp(cfg, 4, rank=3)
    assert not tp.attn_split
    assert not _jax_splits(monkeypatch, 12, 4, 16384)
    assert layers.seq_parallel(tp, 16384)
    assert not layers.seq_parallel(None, 16384)
    assert tp.plan.fallbacks[0] == (
        "attention", "3 q heads a rank read 3 kv heads unevenly: "
                     "replicated, its queries split by sequence from 16384 "
                     "tokens")


# ---------------------------------------------------------------------------
# A gloo world of 3 on the smoke configs, against the split off and JAX
# ---------------------------------------------------------------------------

B, S, S_MAX = 2, 96, 128
ARCHS = ("qwen2-0.5b", "granite-moe-3b-a800m", "zamba2-1.2b")

GLOO_CODE = """
import torch
from repro_torch.configs import get_smoke_config
from repro_torch.core.resharding import MeshConfig, shard_params, tp_plan
from repro_torch.models import layers, transformer
from repro_torch.models.registry import build_model
from repro_torch.models.tensor_parallel import TPContext

work = ARG["dir"]
tok = torch.load(f"{work}/tokens.pt")
gathers = [0]
gather_seq = TPContext.gather_seq


def counted(self, x, dim=1):
    gathers[0] += 1
    return gather_seq(self, x, dim)


TPContext.gather_seq = counted
mesh = MeshConfig("tp3", 1, 3)
out = {}
for arch in ARG["archs"]:
    model = build_model(get_smoke_config(arch))
    cfg = model.cfg
    plan = tp_plan(model, mesh)
    tp = TPContext(plan)
    local = dict(shard_params(torch.load(f"{work}/{arch}.pt"), plan))
    f32 = (dict(kv_dtype="fp32") if cfg.family == "dense"
           else dict(dtype=torch.float32))
    for split in (False, True):
        layers.SEQ_PARALLEL_MIN_S = ARG["S"] if split else 16384
        for impl in ("xla", "flash"):
            runs = {"dense": lambda: model.init_cache(
                ARG["B"], ARG["S_MAX"], tp=tp, **f32)}
            if cfg.family == "dense":
                runs["paged"] = lambda: model.init_cache(
                    ARG["B"], ARG["S_MAX"], layout="paged", tp=tp, **f32)
            for layout, make in runs.items():
                gathers[0] = 0
                with torch.no_grad():
                    lg, c = model.prefill(local, tok, make(), attn_impl=impl,
                                          tp=tp)
                kv = c.attn_kv if cfg.family == "hybrid" else c.kv
                res = dict(logits=lg, k=kv.k, v=kv.v, gathers=gathers[0])
                if cfg.family == "hybrid":
                    res["ssm"] = c.mamba.ssm
                if layout == "paged":
                    res["table"] = c.block_table
                out[f"{arch}|{layout}|{impl}|{split}"] = res
            if cfg.family == "dense":
                gathers[0] = 0
                with torch.no_grad():
                    fw = transformer.forward(cfg, local, tok, attn_impl=impl,
                                             tp=tp)
                out[f"{arch}|forward|{impl}|{split}"] = dict(
                    logits=fw, gathers=gathers[0])
torch.save(out, f"{work}/rank{RANK}.pt")
emit({"rank": RANK, "index": tp.index})
"""


def _jax_parts(arch):
    """The smoke ``arch``'s fp32 JAX model, params and its prefill
    function on dense (and, for the dense family, paged) f32 caches."""
    jcfg = jax_smoke_config(arch)
    jmodel = jax_build_model(jcfg)
    jp = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    if jcfg.family == "moe":
        caches = {"dense": lambda: jmoe.init_cache(jcfg, B, S_MAX,
                                                   jnp.float32)}
    elif jcfg.family == "hybrid":
        caches = {"dense": lambda: jhybrid.init_cache(jcfg, B, S_MAX,
                                                      jnp.float32)}
    else:
        caches = {layout: (lambda layout=layout: jmodel.init_cache(
            B, S_MAX, layout=layout, kv_dtype="fp32"))
            for layout in ("dense", "paged")}
    return jcfg, jmodel, jp, caches


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Each rank's results, and JAX's one-device prefills, computed while
    the gloo ranks run."""
    work = tmp_path_factory.mktemp("seqpar")
    rs = np.random.RandomState(7)
    tok = rs.randint(0, 512, (B, S)).astype(np.int32)
    torch.save(torch.from_numpy(tok).long(), work / "tokens.pt")
    parts = {a: _jax_parts(a) for a in ARCHS}
    for arch, (_, _, jp, _) in parts.items():
        torch.save(params_from_numpy(jax.tree.map(np.asarray, jp)),
                   work / f"{arch}.pt")
    box = {}

    def gloo():
        try:
            box["ranks"] = run_gloo(GLOO_CODE, 3, work, arg=dict(
                dir=str(work), archs=list(ARCHS), B=B, S=S, S_MAX=S_MAX),
                timeout=300, pg_timeout=120)
        except BaseException as e:            # re-raised below
            box["error"] = e

    th = threading.Thread(target=gloo)
    th.start()
    jax_out = {}
    for arch, (jcfg, jmodel, jp, caches) in parts.items():
        for layout, make in caches.items():
            lg, c = jmodel.prefill(jp, jnp.asarray(tok), make())
            kv = c.attn_kv if jcfg.family == "hybrid" else c.kv
            jax_out[f"{arch}|{layout}"] = dict(
                logits=np.asarray(lg, np.float32),
                k=np.asarray(kv.k, np.float32), v=np.asarray(kv.v,
                                                             np.float32),
                table=(np.asarray(c.block_table) if layout == "paged"
                       else None))
    th.join()
    if "error" in box:
        raise box["error"]
    assert [r[0]["index"] for r in box["ranks"]] == [0, 1, 2]
    ranks = [torch.load(work / f"rank{r}.pt") for r in range(3)]
    return ranks, jax_out


RUNS = ([f"qwen2-0.5b|{lay}|{impl}" for lay in ("dense", "paged", "forward")
         for impl in ("xla", "flash")]
        + [f"{a}|dense|{impl}" for a in ARCHS[1:]
           for impl in ("xla", "flash")])


def _tensors(res):
    return {k: v for k, v in res.items() if isinstance(v, torch.Tensor)}


@pytest.mark.parametrize("run", RUNS)
def test_split_matches_the_replicated_run(world, run):
    """Every cache leaf and the logits of the split run within 1e-6 of
    their scale of the same world's replicated run, every rank alike;
    observed bitwise, which the test holds."""
    ranks, _ = world
    on, off = (ranks[0][f"{run}|{flag}"] for flag in (True, False))
    # one gather a layer (qwen2, granite-moe: 2) or a site (zamba2: 2)
    assert on["gathers"] == 2 and off["gathers"] == 0
    for name, t in _tensors(off).items():
        s = float(t.abs().max())
        assert float((on[name] - t).abs().max()) <= 1e-6 * s, name
        assert torch.equal(on[name], t), name
    for other in ranks[1:]:
        for name, t in _tensors(on).items():
            assert torch.equal(other[f"{run}|True"][name], t), name


def _paged_rows(k, table):
    """(layers, B, npp * ps, KV, hd): each row's pages through its block
    table."""
    k = np.asarray(k)
    table = np.asarray(table)
    rows = k[:, table.clip(0)]              # (L, B, npp, ps, KV, hd)
    return rows.reshape(rows.shape[0], rows.shape[1], -1, *rows.shape[4:])


@pytest.mark.parametrize("run", [r for r in RUNS if "forward" not in r])
def test_split_matches_jax_one_device(world, run):
    """fp32: the split run's logits and cache within 1e-5 of their scale
    of JAX's one-device prefill on bridged weights, equal greedy tokens."""
    ranks, jax_out = world
    arch, layout, _ = run.split("|")
    got, want = ranks[0][f"{run}|True"], jax_out[f"{arch}|{layout}"]
    lg = got["logits"].numpy()
    s = float(np.abs(want["logits"]).max())
    assert float(np.abs(lg - want["logits"]).max()) <= 1e-5 * s
    assert (lg.argmax(-1) == want["logits"].argmax(-1)).all()
    for name in ("k", "v"):
        mine, ref = got[name].numpy(), want[name]
        if layout == "paged":
            mine = _paged_rows(mine, got["table"].numpy())[:, :, :S]
            ref = _paged_rows(ref, want["table"])[:, :, :S]
        assert float(np.abs(mine - ref).max()) <= \
            1e-5 * float(np.abs(ref).max()), name


# ---------------------------------------------------------------------------
# The cost counter sees the split
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def traced_split():
    (out,) = run_fake("""
from repro_torch.configs import get_smoke_config
from repro_torch.core.resharding import MeshConfig, shard_params, tp_plan
from repro_torch.core.train_step import make_prefill_step
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import dryrun
from repro_torch.models import layers
from repro_torch.models.param import abstract_params
from repro_torch.models.registry import build_model
from repro_torch.models.tensor_parallel import TPContext
from repro_torch.utils.cost import fake_mode, full_cost, start_fake_world

reports = []
report = fa_ops.report_kernel


def recorded(name, nbytes, flops):
    reports.append([name, nbytes, flops])
    report(name, nbytes, flops)


fa_ops.report_kernel = recorded
# the smoke qwen2 at tp=3 on its last rank, the split at 96 tokens
layers.SEQ_PARALLEL_MIN_S = 96
start_fake_world(3, rank=2)
model = build_model(get_smoke_config("qwen2-0.5b"))
with fake_mode():
    plan = tp_plan(model, MeshConfig("tp3", 1, 3), rank=2)
    tp = TPContext(plan)
    params = abstract_params(model.defs, torch.float32, "cpu")
    local = dict(shard_params(params, plan, 2))
    local = {k: torch.empty(v.shape, dtype=v.dtype) for k, v in local.items()}
    cache = model.init_cache(2, 128, kv_dtype="fp32", tp=tp)
    toks = torch.empty((2, 96), dtype=torch.int64)
    fc = full_cost(make_prefill_step(model, attn_impl="flash", tp=tp),
                   local, toks, cache)
out = dict(smoke=dict(reports=list(reports), kernels=fc.kernels,
                      gathers=fc.collective_counts.get("all-gather", 0)))
# the dry run's row: rank 15 of (16, 16)
layers.SEQ_PARALLEL_MIN_S = 16384
reports.clear()
row = dryrun.run_one("qwen2-0.5b", "prefill_32k", multi_pod=False,
                     verbose=False)
out["dryrun"] = dict(reports=reports, kernels=row["cost"]["kernels"],
                     gathers=row["collectives"]["by_kind_count"]
                     .get("all-gather", 0),
                     fallbacks=row["fallbacks"])
emit(out)
""", timeout=300)
    return out


def test_traced_split_prefill_reports_the_offset_work(traced_split):
    """The smoke qwen2's prefill at tp=3 on rank 2: two flash forwards of
    32 rows from position 64 over 96 keys, their work at that offset, and
    one all-gather a layer."""
    t = traced_split["smoke"]
    want = fa_ops.work("fwd", 2, 32, 96, 4, 2, 32, 4, q_offset=64)
    assert t["kernels"] == {"flash_fwd": 2} and t["gathers"] == 2
    assert t["reports"] == [["flash_fwd", *want]] * 2


def test_dry_run_traces_the_busiest_rank(traced_split):
    """qwen2-0.5b's prefill_32k on (16, 16), 2 rows of 32,768 tokens a
    data row: rank 15 runs 24 forwards of the last 2,048 rows, whose
    causal pairs are (31/32)/8 of the whole sequence's (31/256 of its
    S^2, 0.121) and 31 times rank 0's."""
    t = traced_split["dryrun"]
    want = fa_ops.work("fwd", 2, 2048, 32768, 14, 2, 64, 2,
                       q_offset=30720)
    assert t["kernels"] == {"flash_fwd": 24} and t["gathers"] == 24
    assert t["reports"] == [["flash_fwd", *want]] * 24
    share = (fa_ops.valid_pairs(2048, 32768, True, 0, 30720)
             / fa_ops.valid_pairs(32768, 32768, True, 0))
    assert abs(share - 31 / 256) < 1e-4
    first = fa_ops.valid_pairs(2048, 32768, True, 0)
    assert abs(fa_ops.valid_pairs(2048, 32768, True, 0, 30720) / first
               / 31 - 1) < 1e-3
    assert ["attention", "14 q heads do not divide 16 ways: replicated, "
                         "its queries split by sequence from 16384 tokens"] \
        in t["fallbacks"]
