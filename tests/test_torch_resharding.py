"""The port's mesh configs, layout rules and resharding against JAX's (port
of ``tests/test_core_system.py::TestShardingRules``, ``test_selector.py::
TestMeshConfig`` and ``test_pipeline.py::TestMeshSplit``).

- ``logical_to_physical`` (with its divisibility fallback), the specs of
  ``param_shardings`` over qwen2-0.5b's smoke and full-width ``ParamDef``s
  on dp=2 x tp=4 and dp=4 x tp=2 (FSDP on and off) with their fallback
  lists, ``batch_sharding``, ``_batch_spec`` and ``rollout_trainer_split``
  are equal to JAX's, which runs in a subprocess with eight host devices.
- ``tree_size_bytes`` counts what JAX's counts on the same arrays.
- ``reshard`` re-lays ``DTensor``s out through ``DTensor.redistribute`` on a
  2 x 2 gloo mesh of four ranks; each rank's local shard is the slice
  ``devices_indices_map`` names, and a reshard across meshes raises.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.utils.tree import tree_size_bytes as jax_tree_size_bytes
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.resharding import (MeshConfig, NamedLayout,
                                         batch_sharding, logical_to_physical,
                                         param_shardings, replicated,
                                         reshard_bytes_moved)
from repro_torch.launch.mesh import _batch_spec, rollout_trainer_split
from repro_torch.models.registry import build_model
from repro_torch.rl.experience import ExperienceBatch
from repro_torch.utils.tree import tree_size_bytes
from test_torch_dispatcher import run_gloo, run_jax_subprocess

SPLITS = [dict(n_devices=1), dict(n_devices=8),
          dict(n_devices=8, rollout_frac=0.75, rollout_tp=2),
          dict(n_devices=8, rollout_frac=0.25, rollout_tp=4),
          dict(n_devices=6, rollout_tp=2, trainer_tp=4)]
MESHES = {"dp2tp4": dict(name="dp2tp4", dp=2, tp=4),
          "dp4tp2": dict(name="dp4tp2", dp=4, tp=2)}
BATCH = [((8, 16), "dp4tp2"), ((6,), "dp4tp2"), ((8, 4), "p2d2t2"),
         (3, "dp2tp4")]

JAX_SNIPPET = """
import json, sys
import jax
from repro.configs.base import get_config, get_smoke_config
from repro.core.resharding import (MeshConfig, batch_sharding,
                                   logical_to_physical, param_shardings)
from repro.launch.mesh import _batch_spec, rollout_trainer_split
from repro.models.registry import build_model
from repro.utils.tree import tree_flatten_with_names

arg = json.loads(sys.argv[1])
meshes = {k: MeshConfig(**kw).make_mesh() for k, kw in arg["meshes"].items()}
meshes["p2d2t2"] = MeshConfig("p2d2t2", dp=2, tp=2, pods=2).make_mesh()


def spec_json(s):
    return [list(e) if isinstance(e, tuple) else e for e in s.spec]


out = {"params": {}, "fallback": {}, "splits": [], "batch": []}
for arch, get in (("smoke", get_smoke_config), ("full", get_config)):
    model = build_model(get("qwen2-0.5b"))
    for mname, mesh in meshes.items():
        if mname == "p2d2t2":
            continue
        for fsdp in (True, False):
            fb = []
            sh = param_shardings(model, mesh, fsdp=fsdp, fallbacks=fb)
            out["params"][f"{arch}/{mname}/{fsdp}"] = dict(
                specs={n.replace("/", "."): spec_json(s)
                       for n, s in tree_flatten_with_names(sh)[0]},
                fallbacks=[[list(a), d, t] for a, d, t in fb])
m = meshes["dp2tp4"]
for shape, axes in (((14, 64), ["heads", None]), ((16, 64), ["heads", None]),
                    ((64, 14), ["embed", "kv_heads"]),
                    ((8, 64), ["vocab", "mlp"])):
    fb = []
    s = logical_to_physical(tuple(shape), tuple(axes), m, fallbacks=fb)
    out["fallback"][json.dumps([shape, axes])] = dict(
        spec=spec_json(s), fallbacks=[[list(a), d, t] for a, d, t in fb])
for kw in arg["splits"]:
    r, t = rollout_trainer_split(**kw)
    out["splits"].append([vars(r), vars(t)])
for shape, mname in arg["batch"]:
    out["batch"].append(spec_json(_batch_spec(meshes[mname], shape)))
out["batch_sharding"] = [
    spec_json(batch_sharding(meshes["p2d2t2"], 3)),
    spec_json(batch_sharding(meshes["dp4tp2"], 3, seq_dim=1,
                             seq_axis="model"))]
print(json.dumps(out))
"""


def as_json(layout: NamedLayout):
    return [list(e) if isinstance(e, tuple) else e for e in layout.spec]


def mesh_cfg(name: str) -> MeshConfig:
    if name == "p2d2t2":
        return MeshConfig("p2d2t2", dp=2, tp=2, pods=2)
    return MeshConfig(**MESHES[name])


@pytest.fixture(scope="module")
def jax_side():
    return json.loads(run_jax_subprocess(JAX_SNIPPET, json.dumps(
        dict(meshes=MESHES, splits=SPLITS, batch=BATCH))))


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mname", sorted(MESHES))
@pytest.mark.parametrize("arch", ["smoke", "full"])
def test_param_shardings_equal_jax(jax_side, arch, mname, fsdp):
    get = get_smoke_config if arch == "smoke" else get_config
    fb = []
    got = param_shardings(build_model(get("qwen2-0.5b")), mesh_cfg(mname),
                          fsdp=fsdp, fallbacks=fb)
    want = jax_side["params"][f"{arch}/{mname}/{fsdp}"]
    assert {k: as_json(v) for k, v in got.items()} == want["specs"]
    # the same fallbacks, in JAX's (sorted-key) order
    assert sorted([list(a), d, t] for a, d, t in fb) == \
        sorted(want["fallbacks"])


def test_logical_to_physical_equal_jax(jax_side):
    m = mesh_cfg("dp2tp4")
    for key, want in jax_side["fallback"].items():
        shape, axes = json.loads(key)
        fb = []
        got = logical_to_physical(tuple(shape), tuple(axes), m, fallbacks=fb)
        assert as_json(got) == want["spec"], key
        assert [[list(a), d, t] for a, d, t in fb] == want["fallbacks"], key


def test_rollout_trainer_split_equal_jax(jax_side):
    for kw, want in zip(SPLITS, jax_side["splits"]):
        got = rollout_trainer_split(**kw)
        assert [vars(c) for c in got] == want, kw


def test_batch_specs_equal_jax(jax_side):
    for (shape, mname), want in zip(BATCH, jax_side["batch"]):
        assert as_json(_batch_spec(mesh_cfg(mname), shape)) == want
    assert [as_json(batch_sharding(mesh_cfg("p2d2t2"), 3)),
            as_json(batch_sharding(mesh_cfg("dp4tp2"), 3, seq_dim=1,
                                   seq_axis="model"))] == \
        jax_side["batch_sharding"]


class TestShardingRules:
    def test_logical_to_physical_divisibility_fallback(self):
        m = MeshConfig("m", dp=2, tp=4)
        fb = []
        s = logical_to_physical((14, 64), ("heads", None), m, fallbacks=fb)
        assert s.spec == (None, None), s.spec
        assert fb, "fallback must be recorded"
        s2 = logical_to_physical((16, 64), ("heads", None), m)
        assert s2.spec == ("model", None), s2.spec

    def test_param_shardings_cover_tree(self):
        model = build_model(get_smoke_config("qwen2-0.5b"))
        sh = param_shardings(model, MeshConfig("one", dp=1, tp=1))
        assert set(sh) == set(model.defs)
        # one device: every layout holds the whole tensor
        for k, lay in sh.items():
            shape = model.defs[k].shape
            assert lay.devices_indices_map(shape) == {
                0: tuple(slice(None) for _ in shape)}


class TestMeshConfig:
    def test_axis_names_and_shape(self):
        tp4 = MeshConfig("tp4", dp=2, tp=4)
        assert tp4.axis_names() == ("data", "model")
        assert tp4.shape() == (2, 4)
        mp = MeshConfig("mp", dp=16, tp=16, pods=2)
        assert mp.axis_names() == ("pod", "data", "model")
        assert mp.n_devices == 512
        assert MeshConfig("o", dp=2, tp=2, device_offset=4).ranks().tolist() \
            == [[4, 5], [6, 7]]

    def test_layout_placements(self):
        from torch.distributed.tensor import Replicate, Shard
        m = MeshConfig("p", dp=2, tp=2, pods=2)
        assert NamedLayout(m, (("pod", "data"), "model")).placements() == [
            Shard(0), Shard(0), Shard(1)]
        assert replicated(m).placements() == [Replicate()] * 3
        with pytest.raises(ValueError, match="mesh order"):
            NamedLayout(m, (("data", "pod"),)).placements()
        with pytest.raises(ValueError, match="not a mesh axis"):
            NamedLayout(MeshConfig("d", 2, 1), ("pod",))
        with pytest.raises(ValueError, match="does not divide"):
            NamedLayout(MeshConfig("d", 4, 1), ("data",)) \
                .devices_indices_map((6,))


class TestMeshSplit:
    def test_single_device_degenerates(self):
        r, t = rollout_trainer_split(n_devices=1)
        assert r.n_devices == t.n_devices == 1
        assert r.device_offset == t.device_offset == 0
        assert rollout_trainer_split() == (r, t)       # no process group

    def test_multi_device_windows_are_disjoint(self):
        r, t = rollout_trainer_split(n_devices=8, rollout_frac=0.75,
                                     rollout_tp=2)
        assert r.device_offset == 0 and t.device_offset == 6
        assert r.dp * r.tp == 6 and r.tp == 2
        assert t.n_devices == 2
        assert r.device_offset + r.n_devices <= t.device_offset

    def test_oversized_tp_is_clamped_to_the_side_share(self):
        r, t = rollout_trainer_split(n_devices=8, rollout_frac=0.25,
                                     rollout_tp=4)
        assert r.tp == 2 and r.n_devices == 2
        assert r.device_offset + r.n_devices <= t.device_offset
        assert t.device_offset + t.n_devices <= 8

    def test_offset_beyond_visible_devices_raises(self):
        cfg = MeshConfig("far", dp=1, tp=1, device_offset=10_000)
        with pytest.raises(ValueError, match="devices"):
            cfg.make_mesh("cpu")


def test_tree_size_bytes_matches_jax():
    rng = np.random.default_rng(0)
    arrays = dict(a=rng.normal(size=(4, 8)).astype(np.float32),
                  b=rng.integers(0, 9, size=(4, 8)).astype(np.int32),
                  c=rng.normal(size=(4,)) > 0,
                  d=np.zeros((3, 2), np.int8))
    exp = ExperienceBatch(*(torch.from_numpy(v) for v in
                            (arrays["b"], arrays["c"].repeat(8).reshape(4, 8),
                             arrays["c"].repeat(8).reshape(4, 8),
                             arrays["a"], arrays["a"], arrays["a"][:, 0],
                             arrays["a"][:, 1], arrays["a"][:, 2],
                             arrays["b"][:, 0], arrays["c"])))
    assert tree_size_bytes(exp) == jax_tree_size_bytes(
        [jnp.asarray(x.numpy()) for x in exp])
    flat = {k: torch.from_numpy(v) for k, v in arrays.items()}
    assert tree_size_bytes(flat) == jax_tree_size_bytes(
        {k: jnp.asarray(v) for k, v in arrays.items()})
    meta = torch.empty((5, 7), dtype=torch.bfloat16, device="meta")
    assert tree_size_bytes({"m": meta, "n": None}) == 70


def test_reshard_bytes_moved():
    params = {"w": torch.zeros(4, 4), "b": torch.zeros(4)}
    a, b = MeshConfig("a", 2, 4), MeshConfig("b", 4, 2)
    assert reshard_bytes_moved(params, a, MeshConfig("a2", 2, 4,
                                                     fsdp=False)) == 0
    assert reshard_bytes_moved(params, a, b) == 80


GLOO_RESHARD = """
from torch.distributed.tensor import distribute_tensor
from repro_torch.core.resharding import MeshConfig, NamedLayout, reshard

cfg = MeshConfig("d2t2", dp=2, tp=2)
mesh = cfg.make_mesh("cpu")
# every rank builds every mesh, also one it is outside of
sub = MeshConfig("lo", dp=2, tp=1).make_mesh("cpu")
x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
a = NamedLayout(cfg, ("data", None))
b = NamedLayout(cfg, (None, "model"))
c = NamedLayout(cfg, (("data", "model"), None))
xd = distribute_tensor(x, mesh, a.placements())
ok = torch.equal(xd.to_local(), x[a.devices_indices_map(x.shape)[RANK]])
y = reshard({"x": xd}, {"x": b})["x"]
ok &= torch.equal(y.to_local(), x[b.devices_indices_map(x.shape)[RANK]])
z = reshard([y], [c])[0]
ok &= torch.equal(z.to_local(), x[c.devices_indices_map(x.shape)[RANK]])
ok &= torch.equal(z.full_tensor(), x)
try:
    reshard(z, NamedLayout(MeshConfig("other", dp=4, tp=1), ("data",)))
    crossed = False
except ValueError:
    crossed = True
emit(dict(rank=RANK, ok=bool(ok), crossed_raises=crossed,
          sub_coordinate=sub.get_coordinate(),
          coordinate=mesh.get_coordinate()))
"""


def test_reshard_through_dtensor_on_four_ranks(tmp_path):
    rows = [r[0] for r in run_gloo(GLOO_RESHARD, 4, tmp_path)]
    assert all(r["ok"] and r["crossed_raises"] for r in rows)
    assert [r["coordinate"] for r in rows] == [[0, 0], [0, 1], [1, 0],
                                               [1, 1]]
    assert [r["sub_coordinate"] for r in rows] == [[0, 0], [1, 0], None,
                                                   None]
