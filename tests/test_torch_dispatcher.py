"""The port's Data Dispatcher against JAX's (port of
``tests/test_dispatcher.py`` and of the dispatch half of
``tests/test_pipeline.py``).

- Movement plans and centralized plans (per-rank send and recv bytes and
  the totals) are bitwise equal to JAX's on ``MOVEMENT_PLAN_SNIPPET``'s
  four cases and on a ``("pod", "data")`` split, a (2, 2, 2) mesh, the two
  disjoint submeshes of ``rollout_trainer_split(n_devices=8)``, a partly
  replicated source and ``cache_shardings`` over a paged int8 pool and a
  dense cache. The JAX side runs in a subprocess with eight host devices
  (``XLA_FLAGS`` never reaches this process).
- The executors run multi-rank on the CPU, in gloo subprocesses of 8 and
  4 ranks that meet through a ``FileStore`` under the test's temporary
  directory: direct within a mesh and across disjoint meshes, centralized,
  ``dispatch_async`` and ``all_to_all_resplit``. Each gathers a result
  bitwise equal to the global array; every rank's received bytes equal
  the plan's ``recv_bytes``, and the direct executor's sent bytes equal
  the plan's ``send_bytes`` except where a source is partly replicated
  (JAX's plan counts a replica twice there; ROADMAP Queue 3).
- The distributed advantages match JAX's within the JAX tests'
  tolerances; the trainer's dispatch path fills ``dispatch`` rows in the
  sync and async schedules, and ``--dispatch`` reaches the trainer.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.rl.algo import (group_relative_advantages as
                           jax_group_advantages,
                           reinforce_advantages as jax_reinforce_advantages)
from repro_torch.configs import get_smoke_config
from repro_torch.core.data_dispatcher import (DataDispatcher, MovementPlan,
                                              centralized_plan,
                                              estimate_latency,
                                              movement_plan)
from repro_torch.core.resharding import MeshConfig, NamedLayout, replicated
from repro_torch.core.stages import EarlTrainer
from repro_torch.launch.mesh import cache_shardings, rollout_trainer_split
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import DecodeCache, PagedDecodeCache
from repro_torch.models.layers import KVEntry
from repro_torch.optim.adamw import adamw
from repro_torch.rl.envs import TicTacToe
from repro_torch.rl.experience import ExperienceBatch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_jax_subprocess(code: str, *args: str, devices: int = 8) -> str:
    """JAX with ``devices`` host devices, in a subprocess."""
    env = dict(os.environ,
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code),
                          *args], capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


GLOO_PRELUDE = """
import json, sys
from datetime import timedelta
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK, WORLD = int(sys.argv[1]), int(sys.argv[2])
ARG = json.loads(sys.argv[4])
dist.init_process_group("gloo", store=dist.FileStore(sys.argv[3], WORLD),
                        rank=RANK, world_size=WORLD, **PG_TIMEOUT)


def emit(obj):
    print("RESULT " + json.dumps(obj), flush=True)
"""


# every rank done before the teardown; then leave without running the
# interpreter's own teardown, where gloo's threads of the mesh subgroups,
# still referenced by module globals, can abort the process
GLOO_EPILOGUE = """
dist.barrier()
dist.destroy_process_group()
sys.stdout.flush()
import os
os._exit(0)
"""


def run_gloo(code: str, world: int, workdir, arg=None, timeout: int = 300,
             pg_timeout=None):
    """Run ``code`` on ``world`` gloo ranks, one process each, meeting
    through a FileStore in ``workdir``. Returns each rank's ``emit``ted
    objects, by rank. ``pg_timeout`` (seconds) bounds every collective of
    the group, so a hang fails instead of waiting out ``timeout``."""
    workdir = str(workdir)
    script = os.path.join(workdir, f"gloo_{world}.py")
    pg = ("{}" if pg_timeout is None
          else f"dict(timeout=timedelta(seconds={pg_timeout}))")
    with open(script, "w") as f:
        f.write(GLOO_PRELUDE.replace("PG_TIMEOUT", pg)
                + textwrap.dedent(code) + GLOO_EPILOGUE)
    store = os.path.join(workdir, f"store_{world}")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    logs = [os.path.join(workdir, f"rank{r}_{world}.log")
            for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, script, str(r), str(world), store,
                 json.dumps(arg)], stdout=log, stderr=subprocess.STDOUT,
                env=env))
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for r, p in enumerate(procs):
        text = open(logs[r]).read()
        assert p.returncode == 0, f"rank {r} failed:\n{text[-4000:]}"
        out.append([json.loads(line[7:]) for line in text.splitlines()
                    if line.startswith("RESULT ")])
    return out


def mesh_kw(cfg: MeshConfig) -> dict:
    return dataclasses.asdict(cfg)


M8 = dict(name="dp8", dp=8, tp=1)
M42 = dict(name="dp4tp2", dp=4, tp=2)
M222 = dict(name="p2d2t2", dp=2, tp=2, pods=2)
ROLL, TRAIN = (mesh_kw(c) for c in rollout_trainer_split(n_devices=8))
R22 = dict(name="r2x2", dp=2, tp=2)
M4 = dict(name="dp4", dp=4, tp=1)
M22 = dict(name="d2t2", dp=2, tp=2)
LO2 = dict(name="lo", dp=2, tp=1)
HI2 = dict(name="hi", dp=2, tp=1, device_offset=2)

# name: (shape, dtype, src mesh, src spec, dst mesh, dst spec, controller,
# ranks the executors run on). Specs are lists; an inner list is a tuple of
# mesh axes splitting one dim.
CASES = {
    # MOVEMENT_PLAN_SNIPPET's four
    "noop": ((64, 32), "float32", M8, ["data", None], M8, ["data", None],
             0, 8),
    "transpose": ((64, 32), "float32", M8, ["data", None], M8,
                  [None, "data"], 0, 8),
    "dp_change": ((64, 32), "float32", M8, ["data", None], M42,
                  ["data", None], 0, 8),
    "replicated_src": ((64, 32), "float32", M8, [], M8, ["data", None],
                       0, 8),
    # MULTIDEV_SNIPPET's move
    "multidev": ((8, 64), "float32", M8, ["data", None], M42,
                 ["data", None], 0, 8),
    "pod_data_split": ((16, 8), "float32", M222, [["pod", "data"], "model"],
                       M8, [None, "data"], 0, 8),
    "mesh_2x2x2": ((4, 4, 8), "int32", M222, ["pod", "data", "model"], M222,
                   ["model", None, ["pod", "data"]], 0, 8),
    "disjoint_split": ((32, 16), "float32", ROLL, ["data", None], TRAIN,
                       ["data", None], 0, 8),
    "disjoint_transpose": ((32, 16), "int8", ROLL, ["data", None], TRAIN,
                           [None, "data"], 0, 8),
    "disjoint_partly_replicated": ((32, 16), "float32", R22, ["data", None],
                                   TRAIN, [None, "data"], 0, 8),
    # four ranks: a 2x2 mesh's model axis, halves of the world, and a
    # controller that holds no source shard
    "model_axis_2x2": ((8, 8), "float32", M22, ["data", None], M22,
                       [None, "model"], 0, 4),
    "halves": ((8, 6), "float32", LO2, ["data", None], HI2, [None, None],
               3, 4),
    "dp4_transpose": ((16, 8), "float32", M4, ["data", None], M4,
                      [None, "data"], 0, 4),
}
# The executors send what JAX's plans count except where a source block has
# replicas: JAX's plans let the lowest replicas in id order take the count
# (a replica can be counted for its twin's bytes), while the executors
# send each block once, from its lowest holder. (case, strategy) pairs:
SEND_DIFFERS = {("disjoint_partly_replicated", "direct"),
                ("disjoint_partly_replicated", "centralized"),
                ("model_axis_2x2", "centralized")}


def spec_of(spec):
    return tuple(tuple(e) if isinstance(e, list) else e for e in spec)


def layout(kw, spec) -> NamedLayout:
    return NamedLayout(MeshConfig(**kw), spec_of(spec))


def port_plans(case):
    shape, dtype, skw, sspec, dkw, dspec, controller, _ = CASES[case]
    src, dst = layout(skw, sspec), layout(dkw, dspec)
    dt = getattr(torch, dtype)
    return (movement_plan(shape, dt, src, dst),
            centralized_plan(shape, dt, src, dst, controller))


def plan_dict(p: MovementPlan) -> dict:
    return dict(total=p.total_bytes, send=dict(p.send_bytes),
                recv=dict(p.recv_bytes), bottleneck=p.bottleneck_bytes)


# ---------------------------------------------------------------------------
# The JAX side: plans, index maps, cache layouts, distributed advantages
# ---------------------------------------------------------------------------

JAX_SNIPPET = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.base import get_smoke_config
from repro.core.data_dispatcher import centralized_plan, movement_plan
from repro.core.resharding import MeshConfig
from repro.launch.mesh import cache_shardings
from repro.models.registry import build_model
from repro.rl.algo import (distributed_group_advantages,
                           distributed_reinforce_advantages)
from repro.utils.tree import tree_flatten_with_names

cases = json.loads(sys.argv[1])
meshes = {}


def mesh(kw):
    key = json.dumps(kw, sort_keys=True)
    if key not in meshes:
        meshes[key] = MeshConfig(**kw).make_mesh()
    return meshes[key]


def spec(s):
    return P(*[tuple(e) if isinstance(e, list) else e for e in s])


def plan_row(p):
    return dict(total=p.total_bytes, bottleneck=p.bottleneck_bytes,
                send={str(k): v for k, v in p.send_bytes.items()},
                recv={str(k): v for k, v in p.recv_bytes.items()})


def imap(sh, shape):
    return {str(d.id): [[s.start, s.stop] for s in idx]
            for d, idx in sh.devices_indices_map(tuple(shape)).items()}


def spec_json(sh):
    return [list(e) if isinstance(e, tuple) else e for e in sh.spec]


out = {"plans": {}, "maps": {}, "caches": {}}
for name, (shape, dtype, skw, sspec, dkw, dspec, ctl, _) in cases.items():
    src = NamedSharding(mesh(skw), spec(sspec))
    dst = NamedSharding(mesh(dkw), spec(dspec))
    dt = jnp.dtype(dtype)
    out["plans"][name] = dict(
        direct=plan_row(movement_plan(tuple(shape), dt, src, dst)),
        centralized=plan_row(centralized_plan(tuple(shape), dt, src, dst,
                                              ctl)))
    out["maps"][name] = [imap(src, shape), imap(dst, shape)]

model = build_model(get_smoke_config("qwen2-0.5b"))
caches = {
    "paged_int8": jax.eval_shape(lambda: model.init_cache(
        8, 64, layout="paged", page_size=16, n_pages=32, kv_dtype="int8")),
    "dense": jax.eval_shape(lambda: model.init_cache(8, 64)),
}
a = mesh(dict(name="dp4tp2", dp=4, tp=2))
b = mesh(dict(name="dp2tp4", dp=2, tp=4))
for cname, cache in caches.items():
    sa = cache_shardings(cache, a, seq_len=64, n_kv_heads=2)
    sb = cache_shardings(cache, b, seq_len=64, n_kv_heads=2)
    rows = {}
    for (n, leaf), (_, x), (_, y) in zip(tree_flatten_with_names(cache)[0],
                                         tree_flatten_with_names(sa)[0],
                                         tree_flatten_with_names(sb)[0]):
        rows[n] = dict(shape=list(leaf.shape), dtype=str(leaf.dtype),
                       spec_a=spec_json(x), spec_b=spec_json(y),
                       plan=plan_row(movement_plan(leaf.shape, leaf.dtype,
                                                   x, y)))
    out["caches"][cname] = rows

m8 = mesh(dict(name="m", dp=8, tp=1))
r = jnp.asarray(np.random.default_rng(0).normal(size=64), jnp.float32)
rs = jax.device_put(r, NamedSharding(m8, P("data")))
out["adv_reinforce"] = np.asarray(
    distributed_reinforce_advantages(rs, m8)).tolist()
r1 = jnp.asarray(np.random.default_rng(1).normal(size=64), jnp.float32)
rs1 = jax.device_put(r1, NamedSharding(m8, P("data")))
out["adv_group"] = np.asarray(
    distributed_group_advantages(rs1, m8, group_size=4)).tolist()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_side():
    return json.loads(run_jax_subprocess(JAX_SNIPPET, json.dumps(CASES)))


def _keyed(d):
    return {int(k): v for k, v in d.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plans_equal_jax_bitwise(jax_side, case):
    direct, cent = port_plans(case)
    for got, want in ((direct, jax_side["plans"][case]["direct"]),
                      (cent, jax_side["plans"][case]["centralized"])):
        assert got.total_bytes == want["total"]
        assert got.send_bytes == _keyed(want["send"])
        assert got.recv_bytes == _keyed(want["recv"])
        assert got.bottleneck_bytes == want["bottleneck"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_index_maps_equal_jax(jax_side, case):
    shape, _, skw, sspec, dkw, dspec, _, _ = CASES[case]
    for lay, want in zip((layout(skw, sspec), layout(dkw, dspec)),
                         jax_side["maps"][case]):
        got = {r: [[s.start, s.stop] for s in idx]
               for r, idx in lay.devices_indices_map(shape).items()}
        assert got == _keyed(want)
        assert list(got) == [int(k) for k in want]       # JAX's rank order


def _port_cache(rows, cname):
    """The port's cache structure holding meta tensors of JAX's leaf
    shapes (the port's paged pool carries one trash page more)."""
    t = {n: torch.empty(r["shape"], dtype=getattr(torch, r["dtype"]),
                        device="meta") for n, r in rows.items()}
    if cname == "dense":
        return DecodeCache(kv=KVEntry(t["kv/k"], t["kv/v"]), pos=t["pos"])
    return PagedDecodeCache(
        kv=KVEntry(t["kv/k"], t["kv/v"], t["kv/k_scale"], t["kv/v_scale"]),
        block_table=t["block_table"], refcount=t["refcount"], pos=t["pos"])


@pytest.mark.parametrize("cname", ["paged_int8", "dense"])
def test_cache_shardings_and_plans_equal_jax(jax_side, cname):
    from repro_torch.utils.tree import tree_flatten_with_names
    rows = jax_side["caches"][cname]
    cache = _port_cache(rows, cname)
    a = MeshConfig("dp4tp2", dp=4, tp=2)
    b = MeshConfig("dp2tp4", dp=2, tp=4)
    sa = dict(tree_flatten_with_names(
        cache_shardings(cache, a, seq_len=64, n_kv_heads=2)))
    sb = dict(tree_flatten_with_names(
        cache_shardings(cache, b, seq_len=64, n_kv_heads=2)))
    assert set(sa) == set(sb) == set(rows)
    as_json = lambda s: [list(e) if isinstance(e, tuple) else e
                         for e in s.spec]
    for n, r in rows.items():
        assert as_json(sa[n]) == r["spec_a"], n
        assert as_json(sb[n]) == r["spec_b"], n
        p = movement_plan(r["shape"], getattr(torch, r["dtype"]), sa[n],
                          sb[n])
        assert plan_dict(p) == dict(total=r["plan"]["total"],
                                    send=_keyed(r["plan"]["send"]),
                                    recv=_keyed(r["plan"]["recv"]),
                                    bottleneck=r["plan"]["bottleneck"]), n
    if cname == "paged_int8":
        # pages over data, kv heads over model where they divide
        assert as_json(sa["kv/k"]) == [None, "data", None, "model", None]
        assert as_json(sb["kv/k_scale"]) == [None, "data", None, None]
        assert as_json(sa["refcount"]) == [None]


# ---------------------------------------------------------------------------
# One rank, no process group
# ---------------------------------------------------------------------------

class TestSingleDevicePlans:
    def test_identity_plan_moves_nothing(self):
        x = torch.zeros((8, 4), dtype=torch.float32)
        d = DataDispatcher()
        out, rep = d.dispatch({"x": x},
                              {"x": replicated(MeshConfig("m", 1, 1))},
                              strategy="direct")
        assert rep.moved_bytes == 0
        assert rep.bottleneck_bytes == 0
        assert out["x"] is x

    def test_centralized_wall_time_positive(self):
        x = torch.ones((64, 64), dtype=torch.float32)
        d = DataDispatcher()
        out, rep = d.dispatch({"x": x},
                              {"x": replicated(MeshConfig("m", 1, 1))},
                              strategy="centralized")
        assert rep.wall_time_s > 0
        assert torch.equal(out["x"], x) and out["x"] is not x

    def test_moving_to_another_rank_needs_a_process_group(self):
        x = torch.ones((4, 4))
        with pytest.raises(RuntimeError, match="process group"):
            DataDispatcher().dispatch(
                {"x": x}, {"x": replicated(MeshConfig("r1", 1, 1,
                                                      device_offset=1))})


class TestMovementPlanProperties:
    """``test_dispatcher.py::TestMovementPlanProperties`` on the port's
    plans of the same four cases."""

    @pytest.fixture(scope="class")
    def rows(self):
        out = []
        for case in ("noop", "transpose", "dp_change", "replicated_src"):
            p, c = port_plans(case)
            out.append(dict(total=64 * 32 * 4, direct_moved=p.total_bytes,
                            direct_bn=p.bottleneck_bytes,
                            cent_moved=c.total_bytes,
                            cent_bn=c.bottleneck_bytes))
        return out

    def test_noop_plan_is_empty(self, rows):
        assert rows[0]["direct_moved"] == 0

    def test_direct_never_exceeds_global_bytes(self, rows):
        for r in rows:
            assert r["direct_moved"] <= r["total"]

    def test_centralized_bottleneck_carries_full_batch(self, rows):
        for r in rows[1:]:
            assert r["cent_bn"] >= r["total"] * 7 // 8

    def test_direct_bottleneck_leq_centralized(self, rows):
        for r in rows:
            assert r["direct_bn"] <= r["cent_bn"]


class TestLatencyModel:
    def test_latency_scales_linearly(self):
        pytest.importorskip("hypothesis")
        from hypothesis import given, settings, strategies as st

        @settings(max_examples=100, deadline=None)
        @given(st.integers(min_value=1, max_value=2**30),
               st.integers(min_value=1, max_value=64))
        def prop(nbytes, fan):
            plan = MovementPlan(nbytes * fan, {0: nbytes * fan},
                                {i: nbytes for i in range(1, fan + 1)})
            t_serial = estimate_latency(plan, bandwidth=1e9,
                                        links_parallel=False)
            t_parallel = estimate_latency(plan, bandwidth=1e9)
            assert t_serial == pytest.approx(plan.total_bytes / 1e9)
            assert t_parallel == pytest.approx(plan.bottleneck_bytes / 1e9)
            assert t_parallel <= t_serial + 1e-12

        prop()

    def test_link_rates_are_the_papers_and_nvlinks(self):
        from repro.core.data_dispatcher import ETHERNET_BW as JAX_ETH
        from repro_torch.core import data_dispatcher as dd
        assert dd.ETHERNET_BW == JAX_ETH
        assert dd.NVLINK_BW == 450e9


# ---------------------------------------------------------------------------
# Multi-rank, gloo
# ---------------------------------------------------------------------------

GLOO_CASES = """
from repro_torch.core.data_dispatcher import DataDispatcher
from repro_torch.core.resharding import MeshConfig, NamedLayout

cases = ARG["cases"]


def layout(kw, spec):
    return NamedLayout(MeshConfig(**kw), tuple(
        tuple(e) if isinstance(e, list) else e for e in spec))


def gather_check(name, strategy, shape, x, dst, shard, rep, extra=None):
    payload = None if shard.is_meta else shard.numpy()
    got = [None] * WORLD if RANK == 0 else None
    dist.gather_object((payload, rep.rank_send_bytes, rep.rank_recv_bytes),
                       got, dst=0)
    if RANK:
        return
    full = np.zeros(shape, dtype=x.numpy().dtype)
    shards_equal = True
    for r, idx in dst.devices_indices_map(shape).items():
        full[idx] = got[r][0]
        shards_equal &= bool(np.array_equal(got[r][0], x.numpy()[idx]))
    emit(dict(case=name, strategy=strategy,
              equal=bool(np.array_equal(full, x.numpy())) and shards_equal,
              sent={r: g[1] for r, g in enumerate(got)},
              recv={r: g[2] for r, g in enumerate(got)},
              moved=rep.moved_bytes, bottleneck=rep.bottleneck_bytes,
              eth=rep.est_latency_ethernet_s, **(extra or {})))


for i, name in enumerate(sorted(cases)):
    shape, dtype, skw, sspec, dkw, dspec, ctl, world = cases[name]
    if world != WORLD:
        continue
    shape = tuple(shape)
    src, dst = layout(skw, sspec), layout(dkw, dspec)
    x = torch.from_numpy((np.random.default_rng(i).standard_normal(shape)
                          * 50).astype(dtype))
    for strategy in ("direct", "centralized"):
        d = DataDispatcher(controller=ctl)
        out, rep = d.dispatch({"x": src.local_shard(x)}, {"x": dst},
                              strategy=strategy, src_shardings={"x": src})
        gather_check(name, strategy, shape, x, dst, out["x"], rep)
    # the asynchronous handoff: post, read the batch, then resolve
    d = DataDispatcher()
    h = d.dispatch_async({"x": src.local_shard(x)}, {"x": dst},
                         src_shardings={"x": src})
    logged = len(d.log)
    shard = h.batch["x"]
    _, rep = h.result()
    gather_check(name, "direct-async", shape, x, dst, shard, rep,
                 dict(logged_before=logged, logged_after=len(d.log)))
"""

GLOO_COLLECTIVES = """
from repro_torch.core.data_dispatcher import all_to_all_resplit
from repro_torch.core.resharding import MeshConfig
from repro_torch.rl.algo import (distributed_group_advantages,
                                 distributed_reinforce_advantages)


def gather_rows(t):
    got = [None] * WORLD if RANK == 0 else None
    dist.gather_object(t.numpy(), got, dst=0)
    return got


if WORLD == 8:
    mesh = MeshConfig("dp8", dp=8, tp=1).make_mesh("cpu")
    y = torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16)
    yt = all_to_all_resplit(y[RANK:RANK + 1], mesh, "data", split_dim=1,
                            concat_dim=0)
    got = gather_rows(yt)
    r = np.random.default_rng(0).normal(size=64).astype(np.float32)
    adv = distributed_reinforce_advantages(
        torch.from_numpy(r[8 * RANK:8 * RANK + 8]), mesh)
    adv = gather_rows(adv)
    r1 = np.random.default_rng(1).normal(size=64).astype(np.float32)
    adv_g = gather_rows(distributed_group_advantages(
        torch.from_numpy(r1[8 * RANK:8 * RANK + 8]), mesh, 4))
    if RANK == 0:
        emit(dict(a2a_equal=bool(np.array_equal(np.concatenate(got, axis=1),
                                                y.numpy())),
                  a2a_shape=list(got[0].shape),
                  adv_reinforce=np.concatenate(adv).tolist(),
                  adv_group=np.concatenate(adv_g).tolist()))
else:
    # the model axis of a 2x2 mesh: each data row re-splits on its own
    mesh = MeshConfig("d2t2", dp=2, tp=2).make_mesh("cpu")
    row, col = mesh.get_coordinate()
    y = torch.arange(8 * 8, dtype=torch.float32).reshape(8, 8)
    mine = y[4 * row:4 * row + 4, 4 * col:4 * col + 4]     # (data, model)
    yt = all_to_all_resplit(mine, mesh, "model", split_dim=0,
                            concat_dim=1)
    want = y[4 * row + 2 * col:4 * row + 2 * col + 2, :]
    ok = [None] * WORLD if RANK == 0 else None
    dist.gather_object(bool(torch.equal(yt, want)), ok, dst=0)
    if RANK == 0:
        emit(dict(a2a_equal=all(ok)))
"""


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    out = {}
    for world in (8, 4):
        wd = tmp_path_factory.mktemp(f"gloo{world}")
        ranks = run_gloo(GLOO_CASES + GLOO_COLLECTIVES, world, wd,
                         arg=dict(cases=CASES))
        rows = ranks[0]
        out[world] = dict(
            cases={(r["case"], r["strategy"]): r for r in rows
                   if "case" in r},
            collectives=[r for r in rows if "case" not in r][0])
    return out


def _run_of(gloo_runs, case, strategy):
    return gloo_runs[CASES[case][-1]]["cases"][(case, strategy)]


@pytest.mark.parametrize("strategy", ["direct", "centralized",
                                      "direct-async"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_executors_deliver_the_global_array(gloo_runs, case, strategy):
    row = _run_of(gloo_runs, case, strategy)
    assert row["equal"], row
    direct, cent = port_plans(case)
    plan = cent if strategy == "centralized" else direct
    recv = {int(r): b for r, b in row["recv"].items() if b}
    assert recv == {r: b for r, b in plan.recv_bytes.items() if b}
    assert sum(recv.values()) == plan.total_bytes
    sent = {int(r): b for r, b in row["sent"].items() if b}
    if (case, strategy.replace("-async", "")) not in SEND_DIFFERS:
        assert sent == {r: b for r, b in plan.send_bytes.items() if b}
    else:
        assert sent != plan.send_bytes          # ROADMAP Queue 3
        assert sum(sent.values()) == plan.total_bytes
    if strategy == "direct-async":
        assert (row["logged_before"], row["logged_after"]) == (0, 1)


class TestMultiDeviceDispatch:
    """``test_dispatcher.py::TestMultiDeviceDispatch`` on eight gloo
    ranks: dp8 rows to a dp4 x tp2 mesh."""

    @pytest.fixture(scope="class")
    def results(self, gloo_runs):
        return {s: _run_of(gloo_runs, "multidev", s)
                for s in ("centralized", "direct")}

    def test_both_strategies_deliver_identical_arrays(self, results):
        assert set(results) == {"centralized", "direct"}
        assert all(r["equal"] for r in results.values())

    def test_direct_moves_fewer_bytes(self, results):
        assert results["direct"]["moved"] < results["centralized"]["moved"]

    def test_direct_bottleneck_is_structurally_smaller(self, results):
        assert (results["direct"]["bottleneck"] * 4
                <= results["centralized"]["bottleneck"])

    def test_latency_model_orders_strategies(self, results):
        assert results["direct"]["eth"] < results["centralized"]["eth"]

    def test_all_to_all_resplit_preserves_data(self, gloo_runs):
        row = gloo_runs[8]["collectives"]
        assert row["a2a_equal"] and row["a2a_shape"] == [8, 2]
        assert gloo_runs[4]["collectives"]["a2a_equal"]


class TestDistributedAdvantages:
    """Advantages without centralizing the rewards, on eight gloo ranks,
    against JAX's distributed and replicated functions."""

    def test_distributed_loo_matches_replicated(self, gloo_runs, jax_side):
        got = np.asarray(gloo_runs[8]["collectives"]["adv_reinforce"])
        r = np.random.default_rng(0).normal(size=64).astype(np.float32)
        want = np.asarray(jax_reinforce_advantages(jnp.asarray(r)))
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got, jax_side["adv_reinforce"],
                                   atol=1e-5, rtol=1e-5)

    def test_distributed_groups_match_replicated(self, gloo_runs, jax_side):
        got = np.asarray(gloo_runs[8]["collectives"]["adv_group"])
        r = np.random.default_rng(1).normal(size=64).astype(np.float32)
        want = np.asarray(jax_group_advantages(jnp.asarray(r), 4))
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(got, jax_side["adv_group"], atol=1e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("baseline", ["none", "batch_mean"])
def test_reinforce_baselines_match_jax(baseline):
    from repro_torch.rl.algo import reinforce_advantages
    r = np.random.default_rng(2).normal(size=16).astype(np.float32)
    got = reinforce_advantages(torch.from_numpy(r), baseline=baseline)
    want = np.asarray(jax_reinforce_advantages(jnp.asarray(r),
                                               baseline=baseline))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="baseline"):
        reinforce_advantages(torch.from_numpy(r), baseline="median")


# ---------------------------------------------------------------------------
# The trainer's dispatch path (test_pipeline.py's TestTrainerDispatchPath
# and TestAsyncHandoff)
# ---------------------------------------------------------------------------

def _trainer(**kw):
    return EarlTrainer(model=build_model(get_smoke_config("qwen2-0.5b")),
                       env=TicTacToe(),
                       optimizer=adamw(1e-3, weight_decay=0.0),
                       batch_size=2, max_turns=1, max_turn_tokens=2,
                       max_context=64, device="cpu", **kw)


def _dst():
    return ExperienceBatch(*([replicated(MeshConfig("m", 1, 1))] * 10))


class TestTrainerDispatchPath:
    @pytest.mark.parametrize("strategy", ["direct", "centralized"])
    def test_train_forwards_dst_shardings(self, strategy):
        tr = _trainer(dispatch_strategy=strategy)
        _, _, hist = tr.train(1, dst_shardings=_dst())
        row = hist[0].dispatch
        assert row is not None and row["strategy"] == strategy
        assert row["n_leaves"] == 10 and row["moved_bytes"] == 0
        assert row["total_bytes"] > 0 and len(tr.dispatcher.log) == 1

    def test_async_train_dispatches_through_handle(self):
        tr = _trainer(pipeline="async", max_policy_lag=1, is_rho_max=2.0)
        _, _, hist = tr.train(2, dst_shardings=_dst())
        assert all(r.dispatch is not None for r in hist)
        assert [r.dispatch["strategy"] for r in hist] == ["direct-async"] * 2
        assert len(tr.dispatcher.log) == 2

    def test_engine_reports_source_layouts(self):
        tr = _trainer()
        tr.train(1)
        src = tr.rollout.experience_shardings
        assert isinstance(src, ExperienceBatch)
        assert src.tokens.spec == ("data", None)
        assert src.rewards.spec == ("data",)
        assert src.tokens.mesh_config == MeshConfig("local", 1, 1)


class TestAsyncHandoff:
    def test_dispatch_async_handle(self):
        d = DataDispatcher()
        x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
        handle = d.dispatch_async({"x": x},
                                  {"x": replicated(MeshConfig("m", 1, 1))})
        assert not handle._done and d.log == []
        out, rep = handle.result()
        assert torch.equal(out["x"], x)
        assert rep.strategy == "direct-async"
        assert rep.wall_time_s >= 0
        assert len(d.log) == 1
        handle.result()                          # idempotent
        assert len(d.log) == 1

    @pytest.mark.parametrize("strategy", ["direct", "centralized"])
    def test_unlogged_dispatch_matches_dispatch(self, strategy):
        """``dispatch_direct``/``dispatch_centralized`` return what
        ``dispatch`` does and log no report."""
        d = DataDispatcher()
        x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
        dst = {"x": replicated(MeshConfig("m", 1, 1))}
        out = getattr(d, f"dispatch_{strategy}")({"x": x}, dst)
        assert d.log == []
        assert torch.equal(out["x"], d.dispatch({"x": x}, dst,
                                                strategy=strategy)[0]["x"])

    def test_centralized_async_rejected(self):
        with pytest.raises(ValueError, match="direct"):
            DataDispatcher().dispatch_async({}, {}, strategy="centralized")

