"""The stage programs of ``core/train_step.py`` that take the modality
inputs, against the JAX package's on the CPU at f32, on JAX's params and
extras bridged (the smoke configs: whisper-large-v3 for the audio family,
qwen2-0.5b and granite-moe-3b-a800m for dense and moe):

- ``lm_loss`` with a quarter of the labels below 0 (masked), on dense,
  moe (the router's aux loss added) and audio: loss, ``lm_loss`` and
  ``n_tokens`` within 2e-6 + 2e-6 relative (a few f32 ulps of a masked
  mean).
- One ``make_lm_train_step`` with AdamW on the audio family, at
  ``microbatch`` 0 (the whole batch) and 2 (gradients of two slices
  accumulated in f32): metrics as above, gradients within 1e-6 + 1e-4 of
  each leaf's largest |g| (the frameworks sum the products in another
  order), moments within the same relative bound (2e-4 for the squared
  ones), and the new params within 1e-6 + 1e-3·lr wherever the clipped
  gradient is 100 times its tolerance (elsewhere both sides move by at
  most one step); AdamW's eps is 1e-3 on both sides, so that a gradient
  near eps cannot turn last-bit differences into a step.
- ``make_serve_step`` after ``make_prefill_step``: greedy tokens equal to
  JAX's for 4 steps, logits within 1e-5 of the scale, for the kernel
  names and for "xla".
- ``make_ref_logprob_step`` and ``make_rl_train_step`` (PPO clip, KL)
  with ``extra`` on the audio family: log-probs within 2e-5, metrics and
  gradients within the bounds above.
- ``remat="full"`` (encoder and decoder blocks checkpointed) gives the
  LM step's gradients within 1e-6 relative of no remat.
- The trainer and both rollout engines refuse the audio and vlm families
  with a ``ValueError`` (their rollouts carry no modality inputs, as in
  the JAX package)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.core import train_step as jts
from repro.models.registry import build_model as jax_build_model
from repro.optim.adamw import Optimizer as JaxOptimizer
from repro.optim.adamw import adamw as jax_adamw
from repro.rl.experience import ExperienceBatch as JaxBatch
from repro_torch.bridge import params_from_numpy, to_torch
from repro_torch.configs import get_smoke_config
from repro_torch.core import train_step as tts
from repro_torch.core.stages import EarlTrainer
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import Optimizer, adamw
from repro_torch.rl.engine import CompiledRolloutEngine
from repro_torch.rl.envs import TicTacToe
from repro_torch.rl.experience import ExperienceBatch
from repro_torch.rl.rollout import RolloutEngine

B, S = 4, 16
LR = 1e-3
OPT = dict(eps=1e-3, weight_decay=0.01, max_grad_norm=1.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Pair:
    """One smoke architecture on both sides, JAX's f32 params and extras
    bridged, numpy tokens and labels (a quarter of them masked)."""

    def __init__(self, arch, remat="none"):
        jcfg = dataclasses.replace(jax_smoke_config(arch), remat=remat)
        self.jmodel = jax_build_model(jcfg)
        self.jparams = self.jmodel.init(jax.random.PRNGKey(0),
                                        dtype=jnp.float32)
        self.tmodel = build_model(dataclasses.replace(
            get_smoke_config(arch), remat=remat))
        self.tparams = params_from_numpy(jax.tree.map(np.asarray,
                                                      self.jparams))
        self.jextra = self.jmodel.make_extras(jax.random.PRNGKey(1), B)
        self.textra = (None if self.jextra is None else
                       {k: to_torch(np.asarray(v))
                        for k, v in self.jextra.items()})
        rs = np.random.RandomState(3)
        V = jcfg.vocab_size
        self.tokens = rs.randint(0, V, (B, S)).astype(np.int32)
        labels = np.roll(self.tokens, -1, axis=1)
        labels[rs.rand(B, S) < 0.25] = -1
        labels[:, -1] = -1
        self.labels = labels


@pytest.fixture(scope="module")
def audio():
    return Pair("whisper-large-v3")


def _capturing(opt, cls, store):
    def update(grads, state, params):
        store["grads"] = grads
        return opt.update(grads, state, params)
    return cls(init=opt.init, update=update)


def _flat(tree):
    return {k: v.numpy() for k, v in params_from_numpy(
        jax.tree.map(np.asarray, tree)).items()}


def _close_per_leaf(port, ref, rtol, what):
    assert set(port) == set(ref), what
    for k in ref:
        scale = float(np.abs(ref[k]).max())
        np.testing.assert_allclose(port[k], ref[k], rtol=0,
                                   atol=1e-6 + rtol * scale,
                                   err_msg=f"{what} {k}")


def _metrics_close(tm, jm):
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=2e-6,
                                   rtol=2e-6, err_msg=k)


def _step_close(jstore, jst, jp2, jparams, tstore, tst, tp2):
    """Gradients, moments and new params of one AdamW step."""
    _close_per_leaf({k: v.float().numpy() for k, v in
                     tstore["grads"].items()}, _flat(jstore["grads"]),
                    1e-4, "grad")
    _close_per_leaf({k: v.numpy() for k, v in tst.mu.items()},
                    _flat(jst.mu), 1e-4, "mu")
    _close_per_leaf({k: v.numpy() for k, v in tst.nu.items()},
                    _flat(jst.nu), 2e-4, "nu")
    jp2f, jmu, p0 = _flat(jp2), _flat(jst.mu), _flat(jparams)
    for k, v in tp2.items():
        g = np.abs(jmu[k]) / 0.1                 # the clipped gradient
        sure = g > 100 * (1e-6 + 1e-4 * g.max())
        np.testing.assert_allclose(v.numpy()[sure], jp2f[k][sure],
                                   atol=1e-6 + 1e-3 * LR, rtol=0,
                                   err_msg=f"param {k}")
        assert np.abs(v.numpy() - p0[k]).max() <= 1.1 * LR, k
        assert np.abs(jp2f[k] - p0[k]).max() <= 1.1 * LR, k


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "granite-moe-3b-a800m",
                                  "whisper-large-v3"])
def test_lm_loss_matches_jax(arch):
    pr = Pair(arch)
    jl, jm = jts.lm_loss(pr.jmodel, pr.jparams, jnp.asarray(pr.tokens),
                         jnp.asarray(pr.labels), extra=pr.jextra)
    with torch.no_grad():
        tl, tm = tts.lm_loss(pr.tmodel, pr.tparams,
                             torch.from_numpy(pr.tokens),
                             torch.from_numpy(pr.labels), extra=pr.textra)
    assert set(tm) == set(jm) == {"lm_loss", "n_tokens"}
    assert float(tm["n_tokens"]) == float((pr.labels >= 0).sum())
    _metrics_close(dict(tm, loss=tl), dict(jm, loss=jl))
    if arch.startswith("granite"):               # the aux term is in
        _, aux = pr.tmodel.forward(pr.tparams, torch.from_numpy(pr.tokens))
        assert float(aux["aux_loss"]) > 0
        assert float(tl) > float(tl - aux["aux_loss"])


@pytest.mark.parametrize("microbatch", [0, 2])
def test_lm_train_step_matches_jax(audio, microbatch):
    jstore, tstore = {}, {}
    jopt = _capturing(jax_adamw(LR, **OPT), JaxOptimizer, jstore)
    topt = _capturing(adamw(LR, **OPT), Optimizer, tstore)
    jp2, jst, jm = jts.make_lm_train_step(
        audio.jmodel, jopt, microbatch=microbatch)(
        audio.jparams, jopt.init(audio.jparams), jnp.asarray(audio.tokens),
        jnp.asarray(audio.labels), audio.jextra)
    tp2, tst, tm = tts.make_lm_train_step(
        audio.tmodel, topt, microbatch=microbatch)(
        audio.tparams, topt.init(audio.tparams),
        torch.from_numpy(audio.tokens), torch.from_numpy(audio.labels),
        audio.textra)
    expected = ({"lm_loss", "loss"} if microbatch else
                {"lm_loss", "n_tokens", "loss"})
    assert set(tm) == set(jm) == expected
    _metrics_close(tm, jm)
    if microbatch:
        assert all(v.dtype == torch.float32 for v in tstore["grads"].values())
    _step_close(jstore, jst, jp2, audio.jparams, tstore, tst, tp2)


def test_lm_train_step_remat_gives_the_same_grads(audio):
    remat = Pair("whisper-large-v3", remat="full")
    grads = []
    for pr in (audio, remat):
        store = {}
        opt = _capturing(adamw(LR, **OPT), Optimizer, store)
        tts.make_lm_train_step(pr.tmodel, opt, attn_impl="flash")(
            audio.tparams, opt.init(audio.tparams),
            torch.from_numpy(audio.tokens), torch.from_numpy(audio.labels),
            audio.textra)
        grads.append({k: v.numpy() for k, v in store["grads"].items()})
    _close_per_leaf(grads[1], grads[0], 1e-6, "remat grad")


@pytest.mark.parametrize("impls", [("pallas", "pallas", "flash", "pallas"),
                                   ("xla", "xla", "xla", "xla")],
                         ids=["kernels", "xla"])
def test_prefill_and_serve_steps_match_jax(audio, impls):
    jpre, jdec, tpre, tdec = impls
    P = 8
    jc = audio.jmodel.init_cache(B, S, dtype=jnp.float32)
    tc = audio.tmodel.init_cache(B, S, torch.float32, device="cpu")
    jl, jc = jts.make_prefill_step(audio.jmodel, attn_impl=jpre)(
        audio.jparams, jnp.asarray(audio.tokens[:, :P]), jc, audio.jextra)
    tl, tc = tts.make_prefill_step(audio.tmodel, attn_impl=tpre)(
        audio.tparams, torch.from_numpy(audio.tokens[:, :P]), tc,
        audio.textra)
    scale = float(np.abs(np.asarray(jl)).max())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(tc.cross_kv.k.numpy(),
                               np.asarray(jc.cross_kv.k), rtol=0,
                               atol=1e-5 * float(np.abs(np.asarray(
                                   jc.cross_kv.k)).max()))
    jserve = jts.make_serve_step(audio.jmodel, attn_impl=jdec)
    tserve = tts.make_serve_step(audio.tmodel, attn_impl=tdec)
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)
    ttok = tl.argmax(-1).to(torch.int32)
    for i in range(4):
        jtok, jl, jc = jserve(audio.jparams, jtok, jc, audio.jextra)
        ttok, tl, tc = tserve(audio.tparams, ttok, tc, audio.textra)
        assert ttok.dtype == torch.int32
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok),
                                      err_msg=f"step {i}")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-5 * scale, err_msg=f"step {i}")
    assert tc.pos.tolist() == np.asarray(jc.pos).tolist() == [P + 4] * B


def test_ref_logprob_step_with_extra_matches_jax(audio):
    j = jts.make_ref_logprob_step(audio.jmodel)(
        audio.jparams, jnp.asarray(audio.tokens), audio.jextra)
    t = tts.make_ref_logprob_step(audio.tmodel, attn_impl="flash")(
        audio.tparams, torch.from_numpy(audio.tokens), audio.textra)
    assert t.shape == (B, S) and bool((t[:, 0] == 0).all())
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=2e-5)


def test_rl_train_step_with_extra_matches_jax(audio):
    rs = np.random.RandomState(4)
    gen = rs.rand(B, S) < 0.5
    rewards = rs.choice([-1.0, 0.0, 1.0], size=B).astype(np.float32)
    arrs = dict(
        tokens=audio.tokens, gen_mask=gen, loss_mask=gen,
        logprobs=np.where(gen, -rs.rand(B, S) * 8 - 4, 0).astype(np.float32),
        ref_logprobs=np.where(gen, -rs.rand(B, S) * 8 - 4, 0).astype(
            np.float32),
        rewards=rewards, returns=rewards,
        advantages=(rewards - rewards.mean()).astype(np.float32),
        context_len=np.full((B,), S, np.int32),
        truncated=np.zeros((B,), bool))
    jstore, tstore = {}, {}
    jopt = _capturing(jax_adamw(LR, **OPT), JaxOptimizer, jstore)
    topt = _capturing(adamw(LR, **OPT), Optimizer, tstore)
    kw = dict(clip_eps=0.2, kl_coef=0.05)
    jp2, jst, jm = jts.make_rl_train_step(audio.jmodel, jopt, **kw)(
        audio.jparams, jopt.init(audio.jparams),
        JaxBatch(**{k: jnp.asarray(v) for k, v in arrs.items()}),
        audio.jextra)
    tp2, tst, tm = tts.make_rl_train_step(
        audio.tmodel, topt, attn_impl="flash", **kw)(
        audio.tparams, topt.init(audio.tparams),
        ExperienceBatch(**{k: torch.from_numpy(v) for k, v in arrs.items()}),
        audio.textra)
    _metrics_close(tm, jm)
    _step_close(jstore, jst, jp2, audio.jparams, tstore, tst, tp2)


@pytest.mark.parametrize("arch", ["whisper-large-v3",
                                  "llama-3.2-vision-11b"])
def test_trainer_and_engines_refuse_modality_families(arch):
    model = build_model(get_smoke_config(arch))
    msg = "rollout engine does not carry"
    with pytest.raises(ValueError, match=msg):
        EarlTrainer(model=model, env=TicTacToe(), device="cpu")
    with pytest.raises(ValueError, match=msg):
        EarlTrainer(model=model, env=TicTacToe(), device="cpu",
                    rollout_backend="python")
    with pytest.raises(ValueError, match=msg):
        CompiledRolloutEngine(model, TicTacToe(), cache_layout="dense",
                              device="cpu")
    with pytest.raises(ValueError, match=msg):
        RolloutEngine(model, TicTacToe(), device="cpu")
