"""Bridge between the JAX param tree and the PyTorch port: the smoke
qwen2 params round-trip JAX -> torch -> numpy bit for bit, and the port's
own param definitions have the JAX tree's paths and shapes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models.registry import build_model as jax_build_model
from repro_torch.bridge import params_from_numpy, params_to_numpy, to_torch
from repro_torch.configs import get_smoke_config
from repro_torch.models.registry import build_model


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, tree


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_smoke_params_round_trip_bitwise(dtype):
    model = jax_build_model(jax_smoke_config("qwen2-0.5b"))
    params = jax.tree.map(np.asarray,
                          model.init(jax.random.PRNGKey(0), dtype=dtype))
    tp = params_from_numpy(params)
    want = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    assert all(t.dtype == want for t in tp.values())
    back = params_to_numpy(tp)
    a, b = dict(_leaves(params)), dict(_leaves(back))
    assert a.keys() == b.keys() == tp.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        # compare the raw bits (bf16 has no numpy-native equality)
        np.testing.assert_array_equal(a[k].view(np.uint8),
                                      b[k].view(np.uint8), err_msg=k)


def test_port_param_defs_match_jax_tree():
    """Same paths, same shapes — including the tied head (no lm_head)."""
    jmodel = jax_build_model(jax_smoke_config("qwen2-0.5b"))
    jp = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0)))
    jshapes = {k: tuple(v.shape) for k, v in _leaves(jp)}
    tmodel = build_model(get_smoke_config("qwen2-0.5b"))
    tp = tmodel.init(torch.Generator().manual_seed(0), dtype=torch.float32)
    assert {k: tuple(v.shape) for k, v in tp.items()} == jshapes
    assert "lm_head" not in tp
    # init kinds: norms are ones, biases zeros, matrices ~ N(0, 1/fan_in)
    assert torch.equal(tp["ln_f"], torch.ones_like(tp["ln_f"]))
    assert torch.equal(tp["layers.attn.bq"],
                       torch.zeros_like(tp["layers.attn.bq"]))
    wq = tp["layers.attn.wq"]
    assert abs(float(wq.std()) * np.sqrt(wq.shape[-2]) - 1.0) < 0.1


def test_to_torch_bool_and_bf16_scalars():
    assert to_torch(np.array([True, False])).dtype == torch.bool
    x = np.asarray(jnp.asarray([1.5, -2.25], jnp.bfloat16))
    np.testing.assert_array_equal(to_torch(x).float().numpy(), [1.5, -2.25])
