"""Every architecture config of the port (``repro_torch/configs``) against
the JAX package's: ``ARCH_IDS`` in JAX's order, every field of the full and
smoke configs (nested MoE and SSM configs included), ``param_count`` and
``active_param_count``, the input shapes and ``with_sliding_window``.
``build_model`` serves every family, audio and vlm included, with JAX's
parameter shapes; the CLI takes every architecture, trains the moe and
hybrid smoke configs for two steps on the CPU (finite loss, the KL of
step 1 above 0, the layout resolved to the dense caches) and refuses
audio and vlm with the trainer's ``ValueError`` (the rollout carries no
modality inputs, as in JAX), not at argparse."""
import dataclasses
import json

import jax
import pytest

import repro.configs.base as jbase
from repro.models.registry import build_model as jax_build_model
from repro_torch.configs import base as tbase
from repro_torch.launch import train as train_cli
from repro_torch.models.registry import build_model

ARCHS = list(jbase.ARCH_IDS)


def test_arch_ids_are_jaxs():
    assert tbase.ARCH_IDS == jbase.ARCH_IDS
    assert tbase.list_archs() == jbase.list_archs()
    assert len(tbase.ARCH_IDS) == 11


@pytest.mark.parametrize("kind", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_and_param_count_match_jax(arch, kind):
    get = "get_config" if kind == "full" else "get_smoke_config"
    j, t = getattr(jbase, get)(arch), getattr(tbase, get)(arch)
    assert [f.name for f in dataclasses.fields(t)] == [
        f.name for f in dataclasses.fields(j)]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    assert t.head_dim_ == j.head_dim_
    assert t.is_attention_free == j.is_attention_free


def test_input_shapes_and_sliding_window_match_jax():
    assert {k: dataclasses.asdict(v) for k, v in tbase.INPUT_SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jbase.INPUT_SHAPES.items()}
    cfg = tbase.with_sliding_window(tbase.get_config("qwen2-0.5b"), 4096)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jbase.with_sliding_window(jbase.get_config("qwen2-0.5b"), 4096))


@pytest.mark.parametrize("arch", ARCHS)
def test_build_model_serves_the_ported_families(arch):
    cfg = tbase.get_smoke_config(arch)
    model = build_model(cfg)
    jmodel = jax_build_model(jbase.get_smoke_config(arch))
    shapes = {".".join(str(k.key) for k in path): tuple(leaf.shape)
              for path, leaf in jax.tree_util.tree_leaves_with_path(
                  jmodel.abstract())}
    assert {k: d.shape for k, d in model.defs.items()} == shapes
    assert model.has_aux == jmodel.has_aux


@pytest.mark.parametrize("arch", ARCHS)
def test_build_model_defs_match_jax_at_full_size(arch):
    """The published configs too: every leaf's shape (no tensor is made
    on either side)."""
    model = build_model(tbase.get_config(arch))
    jmodel = jax_build_model(jbase.get_config(arch))
    shapes = {".".join(str(k.key) for k in path): tuple(leaf.shape)
              for path, leaf in jax.tree_util.tree_leaves_with_path(
                  jmodel.abstract())}
    assert {k: d.shape for k, d in model.defs.items()} == shapes


@pytest.mark.parametrize("arch", ["whisper-large-v3",
                                  "llama-3.2-vision-11b"])
def test_cli_takes_every_arch_and_raises_at_build_model(arch):
    args = train_cli.parse_args(["--arch", arch, "--smoke"])
    assert args.arch == arch
    with pytest.raises(ValueError, match="rollout engine does not carry"):
        train_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--steps", "1"])


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "zamba2-1.2b"])
def test_cli_trains_the_moe_and_hybrid_families(arch, tmp_path):
    log = tmp_path / "train.jsonl"
    assert train_cli.main([
        "--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
        "--batch", "4", "--max-turns", "2", "--max-turn-tokens", "3",
        "--max-context", "96", "--log", str(log)]) == 0
    rows = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 1]
    assert all(r["page_capacity"] == 0 and r["loss"] == r["loss"]
               for r in rows)
    assert rows[1]["kl"] > 0
    with pytest.raises(ValueError, match="cache_layout='dense'"):
        train_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--cache-layout", "paged"])
