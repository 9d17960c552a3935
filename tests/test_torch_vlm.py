"""The vlm family of the port (``models/vlm.py``, llama-3.2-vision-11b's
smoke config: one self layer then one gated cross layer, d 128, 4/2 heads
x 32, 16 image tokens) against the JAX package on the CPU, with the
harness of ``test_torch_encdec.py``: JAX's f32 params bridged, JAX's
``make_extras`` image embeddings bridged bit for bit, numpy tokens.

The cross layers' gates start at zero in both packages, so at init the
image path adds nothing to the logits and a wrong cross block would pass
unseen. Every parity test here therefore sets the gates in the numpy tree
before it goes to both sides (``gate_attn`` 0.5, ``gate_mlp`` -0.7):

- the bridge bitwise both ways (``layers``, ``cross_layers`` and the
  gates);
- ``forward`` logits within 1e-5 of the logit scale, "xla" against "xla"
  and the port's "flash" against JAX's "pallas" (interpreted);
- prefill, then 3 decode steps with row 1 frozen: logits within 1e-5 of
  the scale, ``pos`` equal, the self and image caches within 1e-5 of
  their scale, for the kernel names and for "xla";
- changing ``image_embeds`` moves the logits on both sides with the
  gates set, and moves neither (bitwise) at the init gates of zero."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_encdec import (IMPLS, Family, check_bridge, close,
                               run_prefill_decode, scale_of)

ARCH = "llama-3.2-vision-11b"


def set_gates(tree):
    tree["cross_layers"]["gate_attn"][...] = 0.5
    tree["cross_layers"]["gate_mlp"][...] = -0.7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fam():
    return Family(ARCH, edit=set_gates)


def test_bridge_round_trip(fam):
    check_bridge(fam)
    assert float(fam.tparams["cross_layers.gate_attn"][0]) == 0.5
    assert float(fam.tparams["cross_layers.gate_mlp"][0]) == np.float32(
        -0.7)


def test_layer_order_is_jaxs(fam):
    """n_cross groups of k self layers then one cross layer: the smoke
    config's one site, and the full config's 8 groups of 4."""
    from repro_torch.configs import get_config
    from repro_torch.models import vlm
    assert vlm._groups(fam.tmodel.cfg) == (1, 1)
    assert vlm._groups(get_config(ARCH)) == (8, 4)


@pytest.mark.parametrize("jimpl,timpl", [("xla", "xla"),
                                         ("pallas", "flash")])
def test_forward_matches_jax(fam, jimpl, timpl):
    jl, tl = fam.forward(jimpl, timpl)
    close(tl, jl)


@pytest.mark.parametrize("impls", sorted(IMPLS))
def test_prefill_decode_matches_jax(fam, impls):
    run_prefill_decode(fam, IMPLS[impls])


@pytest.mark.parametrize("gates", ["set", "init"])
def test_image_path_is_live_only_with_gates(fam, gates):
    f = fam if gates == "set" else Family(ARCH)
    if gates == "init":
        assert float(f.tparams["cross_layers.gate_attn"].abs().max()) == 0
    other = {"image_embeds": f.jextra["image_embeds"] * 3 + 0.01}
    j0, t0 = f.forward("xla", "xla")
    j1, t1 = f.forward("xla", "xla", jextra=other)
    if gates == "set":
        close(t1, j1)
        assert np.abs(j1 - j0).max() > 1e-3 * scale_of(j0)
        assert np.abs(t1 - t0).max() > 1e-3 * scale_of(t0)
    else:
        np.testing.assert_array_equal(j1, j0)
        np.testing.assert_array_equal(t1, t0)


def test_image_cache_is_fixed_by_prefill(fam):
    """Decode reads the image K/V prefill stored and never writes them."""
    steps = list(fam.prefill_decode(IMPLS["xla"], n_steps=2))
    img0 = steps[0][4].img_kv.k.clone()
    assert torch.equal(steps[-1][4].img_kv.k, img0)
    assert float(img0.abs().max()) > 0
    np.testing.assert_array_equal(np.asarray(steps[-1][3].img_kv.k,
                                             np.float32),
                                  np.asarray(steps[0][3].img_kv.k,
                                             np.float32))
    assert jnp.asarray(steps[0][3].img_kv.k).dtype == jnp.float32
