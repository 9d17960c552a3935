"""The port's bandit and connect_four envs against the JAX envs, with the
JAX draws injected: reset, reset_rows and step are bitwise equal (states,
rewards, done flags and observations, prompt prefixes included). Then the
port's engine on both envs against JAX's ``attn_impl="xla"`` engine at fp32
(the grid of ``tests/test_engine_parity.py``): tokens, masks, rewards and
context lengths equal, log-probs within atol 1e-5. And the CLI runs two
smoke steps on each env.

The JAX draws are made here for every test file of the slice
(``jax_noise``): the engine's non-preempt draws are keyed by macro-step
(``turn_rng``/``sample_rng``/``env_rng``/``reset_rng``, the initial reset
by the run's key itself), its preempt draws by episode
(``episode_env_rng``/``episode_reset_rng``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.rl.engine import CompiledRolloutEngine as JaxEngine
from repro.rl.engine import common as jcommon
from repro.rl.envs import make_env as jax_make_env
from repro_torch.bridge import to_torch
from repro_torch.rl.engine import CompiledRolloutEngine
from repro_torch.rl.envs import make_env


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small eager ops: one intra-op thread per test worker, so parallel
    workers do not oversubscribe the cores (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def env_draw(env, kind, key, batch):
    """The JAX env's own draw for ``kind`` under ``key``, in the port's
    noise layout: "env" — the opponent's Gumbel (B, width) or the bandit's
    uniform payout (B, 1); "reset" — the bandit's uniform means and normal
    hint noise, side by side (B, 2 * n_arms)."""
    if kind == "env":
        if hasattr(env, "n_arms"):
            return jax.random.uniform(key, (batch,))[:, None]
        return jax.random.gumbel(key, (batch, env.n_actions),
                                 jnp.float32)
    mrng, nrng = jax.random.split(jax.random.fold_in(key, 0x6BAD))
    n = env.n_arms
    return jnp.concatenate([jax.random.uniform(mrng, (batch, n)),
                            jax.random.normal(nrng, (batch, n))], axis=1)


def jax_noise(rng, env):
    """The JAX engine's draws for ``run(params, rng, ...)`` as the port's
    ``NoiseFn``. Tensor coordinates (preempt mode) are per-row episode ids
    and env steps."""
    base = jax.random.fold_in(rng, 1)
    brng = jax.random.fold_in(rng, 2)

    def noise(kind, m, index, shape):
        if kind == "sample":
            key = jcommon.sample_rng(jcommon.turn_rng(base, m), index)
            return to_torch(np.asarray(jax.random.gumbel(key, shape,
                                                         jnp.float32)))
        if isinstance(m, torch.Tensor):
            rows = []
            for e, t in zip(m.tolist(), index.tolist()):
                key = (jcommon.episode_env_rng(brng, e, t) if kind == "env"
                       else jcommon.episode_reset_rng(brng, e))
                rows.append(np.asarray(env_draw(env, kind, key, 1)))
            return to_torch(np.concatenate(rows))
        if kind == "env":
            key = jcommon.env_rng(jcommon.turn_rng(base, m))
        else:
            key = rng if m < 0 else jcommon.reset_rng(
                jcommon.turn_rng(base, m))
        return to_torch(np.asarray(env_draw(env, kind, key, shape[0])))
    return noise


def assert_state_equal(tstate, jstate):
    for name, a, b in zip(jstate._fields, tstate, jstate):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)


@pytest.mark.parametrize("kw", [{}, {"prompt_len": 19},
                                {"n_arms": 3, "obs_levels": 6,
                                 "prompt_len": 4}])
@pytest.mark.parametrize("seed", [0, 1])
def test_bandit_matches_jax(kw, seed):
    B = 8
    jenv, tenv = jax_make_env("bandit", **kw), make_env("bandit", **kw)
    assert tenv.prompt_prefix_len == jenv.prompt_prefix_len
    assert tenv.obs_len == jenv.obs_len
    key = jax.random.PRNGKey(seed)
    js = jenv.reset(key, B)
    ts = tenv.reset(B, device="cpu",
                    noise=to_torch(np.asarray(env_draw(jenv, "reset", key,
                                                       B))))
    assert_state_equal(ts, js)
    jo, to = np.asarray(jenv.encode_obs(js)), tenv.encode_obs(ts).numpy()
    np.testing.assert_array_equal(to, jo)
    # the declared prefix is identical in every row
    assert (to[:, :tenv.prompt_prefix_len] == to[:1, :tenv.prompt_prefix_len]
            ).all()
    actions = np.random.RandomState(seed).randint(0, tenv.n_arms, B)
    skey = jax.random.fold_in(key, 7)
    js2, jr = jenv.step(js, jnp.asarray(actions, jnp.int32), skey)
    ts2, tr = tenv.step(ts, torch.from_numpy(actions).int(),
                        to_torch(np.asarray(env_draw(jenv, "env", skey,
                                                     B))))
    assert_state_equal(ts2, js2)
    for name, a, b in zip(jr._fields, tr, jr):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    # a second step absorbs: no reward is emitted again
    js3, jr3 = jenv.step(js2, jnp.asarray(actions, jnp.int32), skey)
    ts3, tr3 = tenv.step(ts2, torch.from_numpy(actions).int(),
                         to_torch(np.asarray(env_draw(jenv, "env", skey,
                                                      B))))
    np.testing.assert_array_equal(tr3.reward.numpy(), np.asarray(jr3.reward))
    assert not tr3.reward.any()
    # reset_rows blends a fresh batch into the masked rows
    mask = np.arange(B) % 3 == 0
    rkey = jax.random.fold_in(key, 9)
    jb = jenv.reset_rows(rkey, js2, jnp.asarray(mask))
    tb = tenv.reset_rows(ts2, torch.from_numpy(mask), to_torch(
        np.asarray(env_draw(jenv, "reset", rkey, B))))
    assert_state_equal(tb, jb)


def test_bandit_reset_needs_its_draw():
    with pytest.raises(ValueError, match="noise"):
        make_env("bandit").reset(2, device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_connect_four_matches_jax(seed):
    """Random agent moves (illegal ones included) against JAX's opponent
    draws, until every board ends: state, rewards and observations equal
    at every step."""
    B = 16
    jenv, tenv = jax_make_env("connect_four"), make_env("connect_four")
    assert tenv.prompt_prefix_len == jenv.prompt_prefix_len == tenv.obs_len
    js, ts = jenv.reset(None, B), tenv.reset(B, device="cpu")
    assert_state_equal(ts, js)
    rs = np.random.RandomState(seed)
    for step in range(24):
        actions = rs.randint(0, 7, B)
        key = jax.random.PRNGKey(seed * 100 + step)
        js, jr = jenv.step(js, jnp.asarray(actions, jnp.int32), key)
        ts, tr = tenv.step(ts, torch.from_numpy(actions).int(), to_torch(
            np.asarray(env_draw(jenv, "env", key, B))))
        assert_state_equal(ts, js)
        for name, a, b in zip(jr._fields, tr, jr):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"{name} step {step}")
    assert ts.done.any()


def test_tictactoe_declares_its_whole_prompt_shared():
    jenv, tenv = jax_make_env("tictactoe"), make_env("tictactoe")
    assert tenv.prompt_prefix_len == jenv.prompt_prefix_len == tenv.obs_len


@pytest.mark.parametrize("name", ["tictactoe", "connect_four", "bandit"])
def test_noise_from_uniform_gives_each_envs_draw(name):
    """The engines' own draws: Gumbel for the board games' opponents, the
    uniform payout and (means, normal quantiles) reset for the bandit."""
    env = make_env(name)
    u = torch.tensor([[0.5, 0.9]]).expand(2, 2)
    out = env.noise_from_uniform("env", u)
    expect = u if name == "bandit" else -torch.log(-torch.log(u))
    torch.testing.assert_close(out, expect, rtol=0, atol=0)
    if name == "bandit":
        r = env.noise_from_uniform("reset", torch.full((2, 10), 0.5))
        assert (r[:, :5] == 0.5).all() and (r[:, 5:] == 0).all()


# ---------------------------------------------------------------------------
# the engine comparison the slice's engine tests share
# ---------------------------------------------------------------------------

def run_both(models, env_name, env_kw, B, N, rng, **kw):
    """JAX's engine (plain attention) and the port's (the layout's kernel
    route: its plain version on the CPU) on the same settings."""
    jmodel, jparams, tmodel, tparams = models
    tkw = {k: v for k, v in kw.items() if k != "port_attn_impl"}
    jeng = JaxEngine(jmodel, jax_make_env(env_name, **env_kw),
                     attn_impl="xla", **tkw)
    e1, s1 = jeng.run(jparams, rng, B, n_episodes=N)
    tenv = make_env(env_name, **env_kw)
    teng = CompiledRolloutEngine(tmodel, tenv, device="cpu",
                                 attn_impl=kw.get("port_attn_impl"), **tkw)
    e2, s2 = teng.run(tparams, B, N, noise=jax_noise(rng, tenv))
    return (e1, s1), (e2, s2), teng


def assert_same_rollout(j, t, lp_atol=1e-5):
    (e1, s1), (e2, s2) = j, t
    for f in ("tokens", "gen_mask", "rewards", "context_len", "truncated"):
        np.testing.assert_array_equal(getattr(e2, f).numpy(),
                                      np.asarray(getattr(e1, f)), err_msg=f)
    np.testing.assert_allclose(e2.logprobs.numpy(), np.asarray(e1.logprobs),
                               atol=lp_atol)
    np.testing.assert_array_equal(s2.n_turns, s1.n_turns)
    np.testing.assert_array_equal(s2.turn_lengths, s1.turn_lengths)
    for f in ("episodes_started", "episodes_returned", "pages_in_use",
              "page_capacity", "kv_dropped_writes", "shared_prefix_len",
              "preemptions", "requeue_depth", "pool_grows"):
        assert getattr(s2, f) == getattr(s1, f), f
