"""The audio family of the port (``models/encdec.py``, whisper-large-v3's
smoke config: 2 encoder and 2 decoder layers, d 128, 4/4 heads x 32, 64
frames) against the JAX package on the CPU, on JAX's f32 params bridged,
JAX's ``make_extras`` frames (bf16, bridged bit for bit) and numpy-seeded
tokens.

- The bridge carries the tree (``encoder``, ``enc_ln_f``,
  ``decoder.{self_attn,cross_attn,ln_x}``) bitwise both ways.
- ``encode`` within 1e-5 of its output scale.
- ``forward`` logits within 1e-5 of the logit scale: the port's "xla"
  against JAX's "xla", and the port's "flash" (the flash kernels' plain
  versions on the CPU) against JAX's "pallas" (interpreted).
- Prefill, then 3 decode steps with row 1 held by ``advance=False``:
  logits within 1e-5 of the scale, ``pos`` equal, and the self and cross
  caches (f32 on both sides) within 1e-5 of their scale, for the kernel
  names (prefill "flash" / decode "pallas" against JAX's "pallas") and
  for "xla".
- Changing the frames moves the logits on both sides.

The harness (``Family``) is shared with ``test_torch_vlm.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models import encdec as jencdec
from repro.models.registry import build_model as jax_build_model
from repro_torch.bridge import params_from_numpy, params_to_numpy, to_torch
from repro_torch.configs import get_smoke_config
from repro_torch.models import encdec
from repro_torch.models.registry import build_model

B, S, PROMPT, S_MAX = 3, 12, 8, 16
# (JAX prefill, JAX decode, port prefill, port decode)
IMPLS = {"kernels": ("pallas", "pallas", "flash", "pallas"),
         "xla": ("xla", "xla", "xla", "xla")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scale_of(a):
    return float(np.abs(np.asarray(a, np.float32)).max())


def close(port, ref, rel=1e-5, what=""):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(port, np.float32), ref, rtol=0,
                               atol=rel * scale_of(ref), err_msg=what)


@dataclasses.dataclass
class Family:
    """One architecture on both sides: JAX's f32 params (optionally
    edited in numpy first) bridged into the port, JAX's extras bridged,
    numpy tokens."""
    arch: str
    edit: object = None            # fn(numpy tree) -> None, in place

    def __post_init__(self):
        self.jmodel = jax_build_model(jax_smoke_config(self.arch))
        tree = jax.tree.map(np.array, self.jmodel.init(
            jax.random.PRNGKey(0), dtype=jnp.float32))
        if self.edit is not None:
            self.edit(tree)
        self.tree = tree
        self.jparams = jax.tree.map(jnp.asarray, tree)
        self.tmodel = build_model(get_smoke_config(self.arch))
        self.tparams = params_from_numpy(tree)
        self.jextra = self.jmodel.make_extras(jax.random.PRNGKey(1), B)
        self.textra = self.bridge_extra(self.jextra)
        self.tokens = np.random.default_rng(2).integers(
            0, self.jmodel.cfg.vocab_size, (B, S)).astype(np.int32)

    @staticmethod
    def bridge_extra(jextra):
        return {k: to_torch(np.asarray(v)) for k, v in jextra.items()}

    def forward(self, jimpl, timpl, jextra=None, tokens=None):
        tokens = self.tokens if tokens is None else tokens
        jextra = self.jextra if jextra is None else jextra
        jl, _ = self.jmodel.forward(self.jparams, jnp.asarray(tokens),
                                    extra=jextra, attn_impl=jimpl)
        with torch.no_grad():
            tl, _ = self.tmodel.forward(self.tparams,
                                        torch.from_numpy(tokens),
                                        extra=self.bridge_extra(jextra),
                                        attn_impl=timpl)
        return np.asarray(jl), tl.numpy()

    def prefill_decode(self, impls, n_steps=3):
        """Prefill PROMPT tokens, then ``n_steps`` decode steps with row 1
        frozen; yields ``(what, jax_logits, port_logits, jcache,
        tcache)`` after the prefill and after each step."""
        jpre, jdec, tpre, tdec = impls
        jc = self.jmodel.init_cache(B, S_MAX, dtype=jnp.float32)
        tc = self.tmodel.init_cache(B, S_MAX, torch.float32, device="cpu")
        toks = self.tokens
        jl, jc = self.jmodel.prefill(self.jparams,
                                     jnp.asarray(toks[:, :PROMPT]), jc,
                                     extra=self.jextra, attn_impl=jpre)
        with torch.no_grad():
            tl, tc = self.tmodel.prefill(
                self.tparams, torch.from_numpy(toks[:, :PROMPT]), tc,
                extra=self.textra, attn_impl=tpre)
        yield "prefill", np.asarray(jl), tl.numpy(), jc, tc
        adv = np.array([True, False, True])
        for j in range(n_steps):
            tok = toks[:, PROMPT + j]
            jl, jc = self.jmodel.decode_step(
                self.jparams, jnp.asarray(tok), jc, extra=self.jextra,
                attn_impl=jdec, advance=jnp.asarray(adv))
            with torch.no_grad():
                tl, tc = self.tmodel.decode_step(
                    self.tparams, torch.from_numpy(tok), tc,
                    extra=self.textra, attn_impl=tdec,
                    advance=torch.from_numpy(adv))
            yield f"decode {j}", np.asarray(jl), tl.numpy(), jc, tc


def check_caches(jc, tc, what):
    """Every cache field of the port against JAX's: the KV entries within
    1e-5 of their scale, ``pos`` equal."""
    assert jc._fields == tc._fields, what
    for name, jv, tv in zip(jc._fields, jc, tc):
        if name == "pos":
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv),
                                          err_msg=what)
            continue
        close(tv.k.numpy(), jv.k, what=f"{what} {name}.k")
        close(tv.v.numpy(), jv.v, what=f"{what} {name}.v")


def run_prefill_decode(fam, impls):
    for what, jl, tl, jc, tc in fam.prefill_decode(impls):
        close(tl, jl, what=what)
        check_caches(jc, tc, what)
    # the frozen row kept its position; the others advanced three times
    assert tc.pos.tolist() == [PROMPT + 3, PROMPT, PROMPT + 3]


def check_bridge(fam):
    assert {k: tuple(v.shape) for k, v in fam.tparams.items()} == {
        k: d.shape for k, d in fam.tmodel.defs.items()}
    back = params_to_numpy(fam.tparams)
    for path, a in jax.tree_util.tree_leaves_with_path(fam.jparams):
        leaf = back
        for k in path:
            leaf = leaf[k.key]
        np.testing.assert_array_equal(leaf, np.asarray(a))


@pytest.fixture(scope="module")
def fam():
    return Family("whisper-large-v3")


def test_bridge_round_trip(fam):
    check_bridge(fam)
    assert {"encoder.attn.wq", "enc_ln_f", "decoder.self_attn.wq",
            "decoder.cross_attn.wv", "decoder.ln_x"} <= set(fam.tparams)


def test_extras_spec_matches_jax(fam):
    jspec = fam.jmodel.input_extras(B)
    tspec = fam.tmodel.input_extras(B)
    assert sorted(jspec) == sorted(tspec) == ["frames"]
    assert tuple(jspec["frames"].shape) == tspec["frames"].shape
    assert tspec["frames"].dtype == torch.bfloat16
    ex = fam.tmodel.make_extras(torch.Generator().manual_seed(0), B)
    assert ex["frames"].shape == tspec["frames"].shape
    assert ex["frames"].dtype == torch.bfloat16
    assert 0.01 < float(ex["frames"].float().std()) < 0.03


def test_encode_matches_jax(fam):
    jo = jencdec.encode(fam.jmodel.cfg, fam.jparams, fam.jextra["frames"])
    with torch.no_grad():
        to = encdec.encode(fam.tmodel.cfg, fam.tparams,
                           fam.textra["frames"])
    assert to.dtype == torch.float32          # cast to enc_ln_f's dtype
    close(to.numpy(), jo, what="encode")


@pytest.mark.parametrize("jimpl,timpl", [("xla", "xla"),
                                         ("pallas", "flash")])
def test_forward_matches_jax(fam, jimpl, timpl):
    jl, tl = fam.forward(jimpl, timpl)
    assert tl.shape == (B, S, fam.jmodel.cfg.vocab_size)
    close(tl, jl)


@pytest.mark.parametrize("impls", sorted(IMPLS))
def test_prefill_decode_matches_jax(fam, impls):
    run_prefill_decode(fam, IMPLS[impls])


def test_frames_move_the_logits(fam):
    other = {"frames": fam.jextra["frames"] * 3 + 0.01}
    j0, t0 = fam.forward("xla", "xla")
    j1, t1 = fam.forward("xla", "xla", jextra=other)
    close(t1, j1)
    assert np.abs(j1 - j0).max() > 1e-3 * scale_of(j0)
    assert np.abs(t1 - t0).max() > 1e-3 * scale_of(t0)


def test_decode_scan_body_takes_extra(fam):
    """``Model.decode_scan_body`` with ``extra``: a frozen row keeps its
    logits, as ``scan_body_over`` merges them."""
    tc = fam.tmodel.init_cache(B, S_MAX, torch.float32, device="cpu")
    with torch.no_grad():
        tl, tc = fam.tmodel.prefill(
            fam.tparams, torch.from_numpy(fam.tokens[:, :PROMPT]), tc,
            extra=fam.textra)
        body = fam.tmodel.decode_scan_body(fam.tparams, extra=fam.textra)
        adv = torch.tensor([True, False, True])
        (l2, tc), _ = body((tl, tc), (torch.from_numpy(
            fam.tokens[:, PROMPT]), adv))
    assert torch.equal(l2[1], tl[1]) and not torch.equal(l2[0], tl[0])
    assert tc.pos.tolist() == [PROMPT + 1, PROMPT, PROMPT + 1]
