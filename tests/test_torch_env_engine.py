"""The port's engine on the bandit and connect_four envs against JAX's
``attn_impl="xla"`` engine at fp32 (the grid of
``tests/test_engine_parity.py``, at smaller sizes), with JAX's draws fed in
(``test_torch_envs.jax_noise``): tokens, masks, rewards and context lengths
equal, log-probs within atol 1e-5. And the CLI runs two smoke steps on
each env."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models.registry import build_model as jax_build_model
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.launch import train as train_cli
from repro_torch.models.registry import build_model
from test_torch_envs import assert_same_rollout, run_both

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small eager ops: one intra-op thread per test worker, so parallel
    workers do not oversubscribe the cores (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# tests/test_engine_parity.py's ENV_SETTINGS, connect_four cut to two
# turns and fewer episodes (its 45-token observation makes each turn long)
SETTINGS = {"bandit": dict(max_turns=1, max_turn_tokens=4, max_context=64),
            "connect_four": dict(max_turns=2, max_turn_tokens=4,
                                 max_context=96)}
SLOTS = {"bandit": (4, 9), "connect_four": (3, 5)}


@pytest.fixture(scope="module")
def models():
    jmodel = jax_build_model(jax_smoke_config("qwen2-0.5b"))
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    tmodel = build_model(get_smoke_config("qwen2-0.5b"))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, tmodel, tparams


@pytest.mark.parametrize("env_name", ["bandit", "connect_four"])
@pytest.mark.parametrize("layout", ["paged", "dense"])
@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_engine_matches_jax_engine(models, env_name, layout, temperature):
    env_kw = {"prompt_len": 8} if env_name == "bandit" else {}
    j, t, _ = run_both(models, env_name, env_kw, *SLOTS[env_name],
                       jax.random.PRNGKey(5), cache_layout=layout,
                       sampling="fused", kv_dtype="fp32", page_size=8,
                       temperature=temperature, **SETTINGS[env_name])
    assert_same_rollout(j, t)
    assert t[1].episodes_returned == SLOTS[env_name][1]


@pytest.mark.parametrize("env_name", ["bandit", "connect_four"])
def test_cli_runs_two_smoke_steps_on_each_env(tmp_path, env_name):
    log = tmp_path / "train.jsonl"
    assert train_cli.main([
        "--smoke", "--device", "cpu", "--env", env_name, "--steps", "2",
        "--batch", "2", "--max-turns", "2", "--max-turn-tokens", "3",
        "--max-context", "96", "--log", str(log)]) == 0
    rows = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 1]
    assert all(np.isfinite(r["loss"]) and r["kv_dropped_writes"] == 0
               for r in rows)
