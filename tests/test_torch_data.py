"""The port's data pipeline (``data/pipeline.py``) and ``rl/algo.
returns_to_go`` against the JAX package's, and the two example twins.

- For two seeds: the synthetic documents, the packed rows (EOS
  separators, the padded last row) and the batch order (in order and
  shuffled, with and without the remainder) bitwise equal to JAX's; both
  sides are numpy.
- ``TokenStream.window`` wraps as JAX's does.
- ``shard_batch`` puts a tree of numpy arrays on the CPU unchanged, and
  under a one-rank ``NamedLayout`` gives that rank's (whole) shard; with
  no device it asks for the GPU and raises without one.
- ``returns_to_go`` bitwise equal to JAX's reversed scan for gamma 1.0
  and 0.9 (the same f32 multiply-adds in the same order).
- ``examples/torch_quickstart.py`` (LM steps with a falling loss, a
  checkpoint round trip, generation) and ``examples/torch_serve_batched.py``
  (dense, audio and vlm smoke configs, plain and kernel names) run to
  completion with ``--device cpu``."""
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro.rl import algo as jalgo
from repro_torch.core.resharding import MeshConfig, NamedLayout
from repro_torch.data import pipeline as tpipe
from repro_torch.rl import algo as talgo

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [0, 7])
def test_documents_rows_and_batches_are_jaxs(seed):
    jd = jpipe.SyntheticLMDataset(512, seed=seed, mean_doc_len=40)
    td = tpipe.SyntheticLMDataset(512, seed=seed, mean_doc_len=40)
    jdocs, tdocs = jd.documents(30), td.documents(30)
    assert len(jdocs) == len(tdocs) == 30
    for a, b in zip(jdocs, tdocs):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(b, a)
    jrows = jpipe.pack_documents(jdocs, 64, eos_id=0)
    trows = tpipe.pack_documents(tdocs, 64, eos_id=0)
    assert trows.dtype == np.int32 and trows.shape == jrows.shape
    np.testing.assert_array_equal(trows, jrows)
    assert (trows == 0).sum() >= 30                  # the EOS separators
    for kw in (dict(), dict(shuffle_seed=seed), dict(drop_remainder=False),
               dict(drop_remainder=False, shuffle_seed=seed + 1)):
        jb = list(jpipe.make_batches(jrows, 5, **kw))
        tb = list(tpipe.make_batches(trows, 5, **kw))
        assert len(jb) == len(tb) > 0
        for a, b in zip(jb, tb):
            np.testing.assert_array_equal(b, a)


def test_token_stream_window_wraps():
    toks = np.arange(10, dtype=np.int32)
    j, t = jpipe.TokenStream(toks), tpipe.TokenStream(toks)
    assert len(t) == len(j) == 10
    np.testing.assert_array_equal(t.window(8, 5), j.window(8, 5))
    np.testing.assert_array_equal(t.window(8, 5), [8, 9, 0, 1, 2])


def test_shard_batch_places_and_lays_out(monkeypatch):
    batch = {"tokens": np.arange(12, dtype=np.int32).reshape(3, 4),
             "mask": np.ones((3, 4), bool)}
    out = tpipe.shard_batch(batch, "cpu")
    assert out["tokens"].device.type == "cpu"
    assert out["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(out["tokens"].numpy(), batch["tokens"])
    layout = NamedLayout(MeshConfig("m", 1, 1), ("data",))
    laid = tpipe.shard_batch(batch, "cpu", layout=layout)
    assert torch.equal(laid["mask"], out["mask"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.shard_batch(batch)


@pytest.mark.parametrize("gamma", [1.0, 0.9])
def test_returns_to_go_is_jaxs(gamma):
    r = np.random.default_rng(5).standard_normal((4, 6)).astype(np.float32)
    j = np.asarray(jalgo.returns_to_go(jnp.asarray(r), gamma))
    t = talgo.returns_to_go(torch.from_numpy(r), gamma)
    assert t.dtype == torch.float32 and t.shape == (4, 6)
    np.testing.assert_array_equal(t.numpy(), j)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_torch_quickstart_runs_on_cpu(capsys):
    assert _example("torch_quickstart").main(
        ["--device", "cpu", "--epochs", "2"]) == 0
    out = capsys.readouterr().out
    assert "checkpoint round-trip ok" in out
    assert "generated continuations" in out


@pytest.mark.parametrize("arch,impl", [
    ("qwen2-0.5b", "pallas"), ("whisper-large-v3", "pallas"),
    ("whisper-large-v3", "xla"), ("llama-3.2-vision-11b", "pallas")])
def test_torch_serve_batched_runs_on_cpu(arch, impl, capsys):
    assert _example("torch_serve_batched").main(
        ["--device", "cpu", "--arch", arch, "--attn-impl", impl,
         "--gen-tokens", "4"]) == 0
    out = capsys.readouterr().out
    assert f"attn_impl={impl}" in out and "generated 4 tokens" in out
