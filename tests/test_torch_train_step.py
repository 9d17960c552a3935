"""One Model Update step of the port (``core/train_step.make_rl_train_step``
with the repo's AdamW) against the JAX package's on the same
``ExperienceBatch`` at fp32: smoke qwen2 (2 layers, 4/2 heads), B=4, T=96,
PPO clip 0.2, KL 0.05, global-norm clipping at 1.0 (the random batch's
gradient norm is above it, so the clip is live). The port's "flash"
(the kernels' plain versions on CPU) is held against JAX's "pallas"
(interpreted), and "xla" against "xla". Then the reference pass, the
aliasing of the reference params, and the loss and advantages of
``rl.algo`` alone (truncated importance sampling and entropy included).

Tolerances, float32 on both sides: the loss and its terms within atol
2e-6 + rtol 2e-6 (a few f32 ulps of masked means over ~150 tokens);
gradients within atol 1e-6 + rtol 1e-4 of each leaf's largest |g| (the
two frameworks sum the matmul and attention reductions in another order);
moments within the same relative bound (2e-4 for the squared ones);
params within 1e-5, 1% of one step, wherever the gradient is 100 times
its tolerance: the first Adam step moves an element by lr * g / (|g| +
eps), so an element whose |g| is near zero (the key bias's exact
gradient is 0) turns gradient noise into a step of up to lr; there both
sides are only held within one step. Remat against no remat within 1e-6
+ 1e-6 of each leaf's largest |g|: the same ops, with the tied
embedding's gradient contributions summed in another order."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.core.train_step import make_ref_logprob_step as jax_ref_step
from repro.core.train_step import make_rl_train_step as jax_train_step
from repro.models.registry import build_model as jax_build_model
from repro.optim.adamw import Optimizer as JaxOptimizer
from repro.optim.adamw import adamw as jax_adamw
from repro.rl import algo as jax_algo
from repro.rl.experience import ExperienceBatch as JaxBatch
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.core.train_step import (make_ref_logprob_step,
                                         make_rl_train_step)
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import Optimizer, adamw
from repro_torch.rl import algo
from repro_torch.rl.experience import ExperienceBatch, zeros_like_experience


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small eager ops: one intra-op thread per test worker, so parallel
    workers do not oversubscribe the cores (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, T = 4, 96
OPT = dict(weight_decay=0.01, max_grad_norm=1.0)
STEP = dict(clip_eps=0.2, kl_coef=0.05)
LR = 1e-3


@pytest.fixture(scope="module")
def setup():
    jmodel = jax_build_model(jax_smoke_config("qwen2-0.5b"))
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    tmodel = build_model(get_smoke_config("qwen2-0.5b"))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    V = jmodel.cfg.vocab_size
    rs = np.random.RandomState(0)
    gen = rs.rand(B, T) < 0.4
    rewards = rs.choice([-1.0, 0.0, 1.0], size=B).astype(np.float32)
    arrs = dict(
        tokens=rs.randint(0, V, (B, T)).astype(np.int32),
        gen_mask=gen, loss_mask=gen,
        logprobs=np.where(gen, -rs.rand(B, T) * 8 - 4, 0).astype(np.float32),
        ref_logprobs=np.where(gen, -rs.rand(B, T) * 8 - 4, 0).astype(
            np.float32),
        rewards=rewards, returns=rewards,
        advantages=(rewards - rewards.mean()).astype(np.float32),
        context_len=np.full((B,), T, np.int32),
        truncated=np.zeros((B,), bool))
    jbatch = JaxBatch(**{k: jnp.asarray(v) for k, v in arrs.items()})
    tbatch = ExperienceBatch(**{k: torch.from_numpy(v)
                                for k, v in arrs.items()})
    return jmodel, jparams, tmodel, tparams, jbatch, tbatch


def _capturing(opt, cls, store):
    """The optimizer with its ``update`` recording the grads it gets."""
    def update(grads, state, params):
        store["grads"] = grads
        return opt.update(grads, state, params)
    return cls(init=opt.init, update=update)


def _flat(tree):
    return {k: np.asarray(v) for k, v in params_from_numpy(
        jax.tree.map(np.asarray, tree)).items()}


def _close_per_leaf(port, ref, rtol, what):
    assert set(port) == set(ref), what
    for k in ref:
        scale = float(np.abs(ref[k]).max())
        np.testing.assert_allclose(port[k], ref[k], rtol=0,
                                   atol=1e-6 + rtol * scale,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("jax_impl,port_impl,extra", [
    pytest.param("pallas", "flash", {}, id="pallas-flash"),
    pytest.param("xla", "xla", {}, id="xla-xla"),
    # truncated IS: the batch's behaviour log-probs reweight the advantages
    pytest.param("xla", "xla", {"is_rho_max": 2.0}, id="xla-xla-is"),
])
def test_rl_train_step_matches_jax(setup, jax_impl, port_impl, extra):
    jmodel, jparams, tmodel, tparams, jbatch, tbatch = setup
    jstore, tstore = {}, {}
    jopt = _capturing(jax_adamw(LR, **OPT), JaxOptimizer, jstore)
    topt = _capturing(adamw(LR, **OPT), Optimizer, tstore)
    jp2, jst, jm = jax_train_step(jmodel, jopt, attn_impl=jax_impl,
                                  **STEP, **extra)(jparams, jopt.init(jparams),
                                                   jbatch)
    tp2, tst, tm = make_rl_train_step(tmodel, topt, attn_impl=port_impl,
                                      **STEP, **extra)(
        tparams, topt.init(tparams), tbatch)
    assert set(tm) == set(jm) >= {"loss", "kl", "clip_frac", "pg_loss"}
    assert ("is_weight_mean" in tm) == bool(extra)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=2e-6,
                                   rtol=2e-6, err_msg=k)
    gnorm = np.sqrt(sum(float(jnp.sum(g ** 2)) for g in
                        jax.tree.leaves(jstore["grads"])))
    assert gnorm > OPT["max_grad_norm"]          # the clip is exercised
    tgrads = {k: v.numpy() for k, v in tstore["grads"].items()}
    _close_per_leaf(tgrads, _flat(jstore["grads"]), 1e-4, "grad")
    _close_per_leaf({k: v.numpy() for k, v in tst.mu.items()},
                    _flat(jst.mu), 1e-4, "mu")
    _close_per_leaf({k: v.numpy() for k, v in tst.nu.items()},
                    _flat(jst.nu), 2e-4, "nu")
    assert int(tst.step) == int(jst.step) == 1
    jp2f, jmu, p0 = _flat(jp2), _flat(jst.mu), _flat(jparams)
    for k, v in tp2.items():
        # where the reference gradient is well above the gradient
        # tolerance, the step's sign and size are fixed: params agree;
        # elsewhere (e.g. the key bias, whose exact gradient is 0) each
        # side moves by at most one step of lr (plus the weight decay)
        g = np.abs(jmu[k]) / 0.1                 # the clipped gradient
        sure = g > 100 * (1e-6 + 1e-4 * g.max())
        np.testing.assert_allclose(v.numpy()[sure], jp2f[k][sure],
                                   atol=1e-5, rtol=0, err_msg=f"param {k}")
        assert np.abs(v.numpy() - p0[k]).max() <= 1.1 * LR, k
        assert np.abs(jp2f[k] - p0[k]).max() <= 1.1 * LR, k


def test_remat_full_gives_the_same_step(setup):
    """``remat="full"`` (per-layer checkpoint, forward recomputed in the
    backward) computes the same grads."""
    _, _, tmodel, tparams, _, tbatch = setup
    remat = build_model(dataclasses.replace(tmodel.cfg, remat="full"))
    grads = []
    for model in (tmodel, remat):
        store = {}
        opt = _capturing(adamw(LR, **OPT), Optimizer, store)
        make_rl_train_step(model, opt, attn_impl="flash", **STEP)(
            tparams, opt.init(tparams), tbatch)
        grads.append(store["grads"])
    _close_per_leaf({k: v.numpy() for k, v in grads[1].items()},
                    {k: v.numpy() for k, v in grads[0].items()}, 1e-6,
                    "remat grad")


@pytest.mark.parametrize("jax_impl,port_impl", [("pallas", "flash"),
                                                ("xla", "xla")])
def test_ref_logprob_step_matches_jax(setup, jax_impl, port_impl):
    jmodel, jparams, tmodel, tparams, jbatch, tbatch = setup
    j = jax_ref_step(jmodel, attn_impl=jax_impl)(jparams, jbatch.tokens)
    t = make_ref_logprob_step(tmodel, attn_impl=port_impl)(tparams,
                                                           tbatch.tokens)
    assert t.shape == (B, T) and bool((t[:, 0] == 0).all())
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=2e-5)


def test_step_leaves_aliased_reference_params_unchanged(setup):
    """The trainer's reference params alias the initial params; the step
    must return new tensors and write none of the old ones."""
    _, _, tmodel, tparams, _, tbatch = setup
    params = {k: v.clone() for k, v in tparams.items()}
    ref_params = params                          # aliased, as init_state
    snapshot = {k: v.clone() for k, v in params.items()}
    opt = adamw(LR, **OPT)
    state = opt.init(params)
    mu_before = {k: v.clone() for k, v in state.mu.items()}
    new, state2, _ = make_rl_train_step(tmodel, opt, attn_impl="flash",
                                        **STEP)(params, state, tbatch)
    for k in snapshot:
        assert torch.equal(ref_params[k], snapshot[k]), k
        assert new[k].data_ptr() != ref_params[k].data_ptr(), k
        assert torch.equal(state.mu[k], mu_before[k]), k
    assert any(not torch.equal(new[k], snapshot[k]) for k in snapshot)
    assert state2.mu is not state.mu


def test_experience_batch_helpers():
    z = zeros_like_experience(3, 7)
    assert (z.batch, z.seq) == (3, 7)
    assert z.nbytes() == 3 * 7 * (4 + 1 + 1 + 4 + 4) + 3 * (4 * 3 + 4 + 1)
    assert z.with_(rewards=torch.ones(3)).rewards.sum() == 3
    assert params_to_numpy(params_from_numpy({"a": np.ones(2)}))["a"].sum() \
        == 2


@pytest.mark.parametrize("opts", [
    dict(),
    dict(clip_eps=0.2, kl_coef=0.05),
    dict(is_rho_max=2.0),
    dict(clip_eps=0.2, kl_coef=0.05, is_rho_max=1.5, entropy_coef=0.01),
], ids=["reinforce", "clip_kl", "truncated_is", "all"])
def test_policy_gradient_loss_matches_jax(opts):
    """``rl.algo.policy_gradient_loss`` on random (B=4, T=24, V=11)
    inputs: loss, metrics and the gradients to the log-probs and the
    entropy logits against ``jax.value_and_grad`` of the JAX function,
    float32 on both sides within 1e-7 + 1e-5 relative (a few ulps of
    masked means over ~60 tokens). Both truncate the importance weights at
    ``is_rho_max`` and pass no gradient through them."""
    rs = np.random.RandomState(3)
    Bn, Tn, Vn = 4, 24, 11
    arrs = dict(
        logprobs=-rs.rand(Bn, Tn) * 3,
        old_logprobs=-rs.rand(Bn, Tn) * 3,
        ref_logprobs=-rs.rand(Bn, Tn) * 3,
        behavior_logprobs=-rs.rand(Bn, Tn) * 3,
        entropy_logits=rs.randn(Bn, Tn, Vn))
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    adv = rs.randn(Bn).astype(np.float32)
    mask = rs.rand(Bn, Tn) < 0.6
    kw = dict(opts)
    kw.setdefault("entropy_coef", 0.0)

    def jloss(lp, ent):
        ins = dict(arrs, logprobs=lp, entropy_logits=ent)
        return jax_algo.policy_gradient_loss(
            ins.pop("logprobs"), jnp.asarray(adv), jnp.asarray(mask),
            **{k: jnp.asarray(v) for k, v in ins.items()}, **kw)

    (jl, jm), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(arrs["logprobs"]), jnp.asarray(arrs["entropy_logits"]))
    t = {k: torch.tensor(v, requires_grad=k in ("logprobs",
                                                "entropy_logits"))
         for k, v in arrs.items()}
    tl, tm = algo.policy_gradient_loss(
        t["logprobs"], torch.tensor(adv), torch.tensor(mask),
        **{k: v for k, v in t.items() if k != "logprobs"}, **kw)
    tg = torch.autograd.grad(tl, (t["logprobs"], t["entropy_logits"]),
                             allow_unused=True)
    assert set(tm) == set(jm)
    tol = dict(atol=1e-7, rtol=1e-5)
    np.testing.assert_allclose(float(tl.detach()), float(jl), **tol)
    for k in jm:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                   err_msg=k, **tol)
    for g, ref in zip(tg, jg):
        np.testing.assert_allclose(
            np.zeros(ref.shape) if g is None else g.numpy(), np.asarray(ref),
            **tol)
    if opts.get("is_rho_max"):
        w = algo.truncated_importance_weights(
            t["logprobs"], t["behavior_logprobs"], rho_max=opts["is_rho_max"])
        assert not w.requires_grad and float(w.max()) <= opts["is_rho_max"]


def test_group_relative_advantages_match_jax():
    r = np.random.RandomState(4).randn(12).astype(np.float32)
    np.testing.assert_allclose(
        algo.group_relative_advantages(torch.from_numpy(r), 4).numpy(),
        np.asarray(jax_algo.group_relative_advantages(jnp.asarray(r), 4)),
        atol=1e-6)
