"""The port's dry run (``repro_torch/launch/dryrun.py``) and production
layouts (``repro_torch/launch/mesh.py``) against JAX's.

- ``run_one`` traces full-width stage programs as rank 0 of the (16, 16)
  mesh on a fake world of 256 (in a process of its own: a process holds
  one default process group): qwen2-0.5b's train_4k step (also with
  ``--microbatch`` 8, whose slices straddle two ranks, against 16) and
  mamba2-370m's decode_32k step. Each row carries JAX's row fields
  (``lower_s`` and ``compile_s`` become ``trace_s``) plus ``feasible``
  and the layouts' ``fallbacks``; the train step's launches are the
  flash kernels' exact counts (full remat: two forwards a layer).
- Each rank's param bytes equal ``resharding.shard_bytes`` of the plan
  (exact), for a split, a replicated-attention and a concatenated-SSM
  plan.
- ``arch_config_for_shape`` gives JAX's sliding window for every arch and
  shape (exact); ``stage_shardings`` on the (2, 16, 16) mesh lays the
  batch over (pod, data), the update's params replicated and the serving
  params by the tp plan.
"""
import os

import pytest

from repro.configs.base import INPUT_SHAPES as JAX_SHAPES
from repro.launch import mesh as jmesh
from repro_torch.configs.base import ARCH_IDS, INPUT_SHAPES
from repro_torch.core.resharding import NamedLayout
from repro_torch.launch import mesh
from repro_torch.launch.dryrun import ASSIGNED_ARCHS
from test_torch_cost import run_fake

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX's row (``repro/launch/dryrun.py:run_one``) but its XLA timings
JAX_ROW = {"arch", "shape", "mesh", "kind", "chips", "memory",
           "peak_bytes_per_device", "cost", "collectives", "roofline"}
ROOFLINE_ROW = {"name", "chips", "hlo_flops", "hlo_bytes",
                "collective_bytes", "model_flops", "collective_count",
                "ring_size", "hw", "compute_s", "memory_s", "collective_s",
                "bottleneck", "useful_flops_ratio", "peak_memory_bytes",
                "step_time_s"}


@pytest.fixture(scope="module")
def rows():
    (out,) = run_fake("""
from repro_torch.core.resharding import shard_bytes
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (input_specs, production_mesh_config,
                                     stage_shardings)
from repro_torch.utils.cost import fake_mode

out = {}
for arch, shape in (("qwen2-0.5b", "train_4k"),
                    ("mamba2-370m", "decode_32k")):
    out[f"{arch}|{shape}"] = dryrun.run_one(arch, shape, multi_pod=False,
                                            verbose=False)
# the LM step in 8 slices of 32 rows, each straddling two ranks of 16
# rows, and in 16 slices of 16 rows, each whole on one rank
for mb in (8, 16):
    out[f"microbatch{mb}"] = dryrun.run_one("qwen2-0.5b", "train_4k",
                                            multi_pod=False, microbatch=mb,
                                            verbose=False)
# each rank's param bytes against shard_bytes of the plan
cfg = production_mesh_config()
out["params"] = {}
for arch, shape in (("qwen2-0.5b", "prefill_32k"),
                    ("glm4-9b", "decode_32k"),
                    ("mamba2-370m", "decode_32k")):
    with fake_mode():
        fn, args, meta = dryrun.build_stage(arch, shape, cfg)
        specs = input_specs(arch, shape)
        plan = stage_shardings(specs, cfg)["plan"]
        carried, kept = shard_bytes(specs["params"], plan, rank=0)
    out["params"][arch] = dict(row=meta["param_bytes"], kept=kept,
                               carried=carried)
emit(out)
""", timeout=600)
    return out


@pytest.mark.parametrize("key", ["qwen2-0.5b|train_4k",
                                 "mamba2-370m|decode_32k"])
def test_run_one_rows_carry_jax_fields(rows, key):
    row = rows[key]
    assert JAX_ROW <= set(row)
    assert {"trace_s", "feasible", "fallbacks"} <= set(row)
    assert not {"lower_s", "compile_s"} & set(row)
    assert set(row["roofline"]) == ROOFLINE_ROW
    assert row["mesh"] == "16x16" and row["chips"] == 256
    assert row["peak_bytes_per_device"] == row["memory"]["peak_bytes"] > 0
    assert row["feasible"] == (row["peak_bytes_per_device"] <= 80e9)
    assert row["roofline"]["hw"]["name"] == "h100-80g"
    assert row["cost"]["flops"] > 0 and row["roofline"]["step_time_s"] > 0


def test_train_row_launches_and_collectives(rows):
    """qwen2-0.5b's update at 16 rows a rank (256 over 16 data rows): two
    flash forwards a layer (full remat) and a dq and dk/dv each, its
    gradients summed over the data rows; replicated over model, its 16 x
    4,096 tokens' f32 logits alone pass 80 GB."""
    row = rows["qwen2-0.5b|train_4k"]
    assert row["kind"] == "train" and row["attn_impl"] == "flash"
    assert row["cost"]["kernels"] == {"flash_fwd": 48, "flash_dq": 24,
                                      "flash_dkv": 24}
    assert row["collectives"]["by_kind_bytes"]["all-reduce"] > 0
    assert not row["feasible"]
    assert ["update", "params and moments replicated over model (16 "
                      "ranks)"] in row["fallbacks"]


def test_train_row_with_microbatch_slices_straddling_ranks(rows):
    """``--microbatch 8`` at 16x16: qwen2-0.5b's 256 rows in 32-row
    slices over ranks of 16 rows, so each slice straddles two ranks. It
    traces, and with the same rows as ``--microbatch 16`` (16-row slices,
    each whole on a rank), only sliced otherwise, its FLOPs lie within
    0.1% of those and its kernels are the same; its one more all-reduce is
    the slices' token counts, summed up front."""
    a, b = rows["microbatch8"], rows["microbatch16"]
    assert a["kind"] == b["kind"] == "train"
    flops = b["cost"]["flops"]
    assert abs(a["cost"]["flops"] - flops) <= 1e-3 * flops, (
        a["cost"]["flops"], flops)
    assert a["cost"]["kernels"] == b["cost"]["kernels"] == {
        "flash_fwd": 48, "flash_dq": 24, "flash_dkv": 24}
    counts = [r["collectives"]["by_kind_count"] for r in (a, b)]
    assert counts[0]["all-reduce"] == counts[1]["all-reduce"] + 1, counts


def test_decode_row_of_a_recurrent_family(rows):
    """mamba2-370m decodes recurrently: no attention kernel, and its 32
    SSM heads split over 16 ranks (two all-reduces a layer: the gated
    norm's sum of squares and out_proj)."""
    row = rows["mamba2-370m|decode_32k"]
    assert row["kind"] == "decode" and row["cost"]["kernels"] == {}
    assert row["collectives"]["by_kind_count"]["all-reduce"] == 2 * 48
    assert row["feasible"]


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "glm4-9b", "mamba2-370m"])
def test_param_bytes_equal_shard_bytes(rows, arch):
    p = rows["params"][arch]
    assert p["row"] == p["kept"] > 0
    if arch == "mamba2-370m":       # in_proj and the conv travel whole
        assert p["carried"] > p["kept"]


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
def test_arch_config_for_shape_equals_jax(shape):
    for arch in ARCH_IDS:
        mine = mesh.arch_config_for_shape(arch, INPUT_SHAPES[shape])
        theirs = jmesh.arch_config_for_shape(arch, JAX_SHAPES[shape])
        assert mine.sliding_window == theirs.sliding_window, arch
        if shape == "long_500k" and mine.family not in ("ssm", "hybrid"):
            assert mine.sliding_window == mesh.LONG_CONTEXT_WINDOW == 8192


def test_assigned_archs_are_jax_ten():
    from repro.launch.dryrun import ASSIGNED_ARCHS as JAX_ARCHS
    assert ASSIGNED_ARCHS == JAX_ARCHS and len(ASSIGNED_ARCHS) == 10


def _specs_of(tree):
    if isinstance(tree, NamedLayout):
        return [tree.spec]
    items = tree.values() if isinstance(tree, dict) else tree
    return [s for x in items for s in _specs_of(x)]


@pytest.mark.parametrize("arch,shape", [
    ("qwen2-0.5b", "train_4k"), ("qwen2-0.5b", "prefill_32k"),
    ("glm4-9b", "decode_32k"), ("llama3-405b", "long_500k"),
    ("whisper-large-v3", "prefill_32k")])
def test_stage_shardings_on_the_two_pod_mesh(arch, shape):
    cfg = mesh.production_mesh_config(multi_pod=True)
    assert cfg.axis_names() == ("pod", "data", "model")
    assert cfg.n_devices == 512
    assert mesh.batch_axes(cfg) == ("pod", "data")
    specs = mesh.input_specs(arch, shape, device="cpu")
    fallbacks = []
    sh = mesh.stage_shardings(specs, cfg, fallbacks=fallbacks)
    kind = specs["kind"]
    B = INPUT_SHAPES[shape].global_batch
    batch = ("pod", "data") if B % 32 == 0 else None
    tok = {"train": "tokens", "prefill": "tokens", "decode": "token"}[kind]
    assert sh[tok].spec[0] == batch
    assert sh[tok].mesh_config == cfg
    if kind == "train":
        assert sh["plan"] is None
        assert set(_specs_of(sh["params"])) == {()}
        assert set(_specs_of(sh["opt_state"])) == {()}
        assert sh["labels"].spec[0] == batch
    elif specs["model"].cfg.family in ("audio", "vlm"):
        assert sh["plan"] is None and set(_specs_of(sh["params"])) == {()}
        assert ("family", "audio: no tp plan, replicated over model") \
            in fallbacks
    else:
        plan = sh["plan"]
        assert sh["params"] == plan.layouts and plan.tp == 16
        assert plan.index == 15          # mesh.traced_rank: rank 15
        for f in plan.fallbacks:
            assert f in fallbacks
        # the dense cache (layers, B, S, KV, hd): rows over (pod, data)
        assert sh["cache"].kv.k.spec[1] == batch
    if specs.get("extra"):
        assert set(sh["extra"]) == set(specs["extra"])
    assert sh["fallbacks"] is fallbacks


def test_no_fsdp_is_refused_with_its_reason(capsys):
    """The port shards no param over the data axis: ``--no-fsdp`` has no
    layout to turn off, so the dry run refuses it before tracing."""
    from repro_torch.launch import dryrun
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--no-fsdp", "--arch", "qwen2-0.5b"])
    assert exc.value.code == 2
    assert "shards no param over the data axis" in capsys.readouterr().err


def test_no_module_of_the_port_cites_item_12():
    """The cost model and the dry run are ported: no module of the port
    defers one to ROADMAP item 12."""
    root = os.path.join(REPO, "src", "repro_torch")
    for path, _, files in os.walk(root):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                with open(os.path.join(path, f)) as fh:
                    assert "item 12" not in fh.read(), os.path.join(path, f)


# ---------------------------------------------------------------------------
# The fake inputs and the tree helpers against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-0.5b", "granite-moe-3b-a800m",
                                  "zamba2-1.2b", "whisper-large-v3"])
def test_abstract_params_and_logical_specs_equal_jax(arch):
    """Every leaf's shape, dtype and logical axes, keyed by its dotted
    path, against JAX's ``abstract_params``/``logical_specs`` trees."""
    import jax
    from repro.models.registry import build_model as jax_build_model
    from repro.configs.base import get_config as jax_get_config
    from repro.models.param import logical_specs as jax_logical_specs
    from repro_torch.bridge import _flatten
    from repro_torch.configs import get_config
    from repro_torch.models.param import abstract_params, logical_specs
    from repro_torch.models.registry import build_model

    jm = jax_build_model(jax_get_config(arch))
    theirs, axes = {}, {}
    _flatten(jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                          jm.abstract(),
                          is_leaf=lambda s: hasattr(s, "shape")), "", theirs)
    _flatten(jax_logical_specs(jm.defs), "", axes)
    model = build_model(get_config(arch))
    mine = abstract_params(model.defs, device="cpu")
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in mine.items()} == theirs
    assert all(type(v).__name__ == "FakeTensor" for v in mine.values())
    assert logical_specs(model.defs) == axes


def test_experience_specs_equal_jax():
    from repro.rl.experience import experience_specs as jax_specs
    from repro_torch.rl.experience import experience_specs
    mine, theirs = experience_specs(4, 96, device="cpu"), jax_specs(4, 96)
    assert mine._fields == theirs._fields
    for a, b in zip(mine, theirs):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype).replace("torch.", "") == str(b.dtype)


def test_tree_helpers_equal_jax():
    import numpy as np
    from repro.utils import tree as jtree
    from repro_torch.utils import (tree_map_with_path, tree_param_count,
                                   tree_size_bytes)
    from repro_torch.utils.tree import tree_zeros_like
    import torch
    tree = {"a": np.ones((3, 4), np.float32),
            "b": {"c": np.ones((5,), np.float32)}}
    port = {"a": torch.ones(3, 4), "b": {"c": torch.ones(5)}}
    assert tree_param_count(port) == jtree.tree_param_count(tree) == 17
    assert tree_size_bytes(port) == jtree.tree_size_bytes(tree)
    keys = []
    tree_map_with_path(lambda k, x: keys.append(k), port)
    jkeys = []
    jtree.tree_map_with_path(lambda k, x: jkeys.append(k), tree)
    assert keys == jkeys == ["a", "b/c"]
    z = tree_zeros_like(port, torch.bfloat16)
    assert z["b"]["c"].dtype == torch.bfloat16 and not z["a"].any()
