"""The port stands alone and never falls back: no file of
``src/repro_torch/`` (nor ``chip_smoke.py``) imports JAX or the JAX
package; entry points default to the GPU and raise without one; the
kernel loader raises without nvcc or CUDA."""
import ast
import pathlib

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import _build
from repro_torch.models.registry import build_model
from repro_torch.rl.engine import CompiledRolloutEngine
from repro_torch.rl.envs import TicTacToe

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "flax")]
    assert not bad, f"{path} imports {bad}"


def test_scan_covers_the_package():
    names = {p.name for p in FILES}
    assert {"compiled.py", "layers.py", "ops.py", "chip_smoke.py"} <= names


def test_engine_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(get_smoke_config("qwen2-0.5b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CompiledRolloutEngine(model, TicTacToe())
    # an explicit CPU request is honoured
    assert CompiledRolloutEngine(model, TicTacToe(),
                                 device="cpu").device.type == "cpu"


def test_engine_defaults_to_the_kernel_path():
    """With no options the engine runs both kernels (on the card; their
    plain versions for CPU tensors)."""
    eng = CompiledRolloutEngine(build_model(get_smoke_config("qwen2-0.5b")),
                                TicTacToe(), device="cpu")
    assert (eng.attn_impl, eng.sampling) == ("paged", "fused")


def test_loader_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_build, "_lib_path",
                        lambda name: ROOT / "build" / "absent" / "x.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("paged_attention")


def test_loader_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _build.load("fused_sample")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _build.build_all()
