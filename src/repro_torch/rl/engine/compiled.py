"""Slot-based rollout engine on the paged KV pool or the dense ring-buffer
cache, with the reference pass folded in (port of
``repro/rl/engine/compiled.py``).

One *macro-step* is one agent turn for every slot:

    [generate max_turn_tokens steps] -> [pool telemetry] ->
    [fallback actions] -> [env step] -> [harvest finished episodes] ->
    [slot refill: release pages + reset rows] -> [one combined obs feed]

The combined feed teacher-forces continuing rows' env observation and
refilled rows' reset observation in one loop over ``obs_len`` decode
steps. JAX compiles the macro-step into one XLA program; here it is a
Python loop over device tensors that enqueues work without waiting on the
GPU: ``lax.scan`` becomes a ``for`` loop and ``lax.cond`` becomes
unconditional masked work (``torch.where``), which computes the same
result. The host syncs ONCE per turn — it reads the ``returned`` counter
(and, with ``on_exhaust="raise"``, the dropped-write counter); nothing
inside a macro-step calls ``.item()``, branches on a tensor, or indexes
with a boolean mask, except the speculative round loop below.

**Speculative decoding** (``speculation="self"`` or ``"draft"``, paged
layout, ``sampling="reference"``): generation runs verify rounds instead
of single decode steps. Each round samples c0 exactly as sequential decode
would, lets a draft model (the policy's first ``draft_layers`` layers, or
a separate small model) propose up to ``spec_k - 1`` more tokens, scores
the whole chunk in ONE ``transformer.spec_verify_step``, and commits the
longest prefix whose tokens are what sequential decode would have sampled
from the same noise rows, capped at the first action token. The draft
decodes on its own dense cache in plain attention (as in JAX) and consumes
every fed column; rejecting proposals rolls its fill line back. JAX's
round loop is a ``lax.while_loop`` whose exit test runs on the device;
here the test is read back once per round (``_more_rounds``). So the
contract is one host read per turn plus one per verify round. A turn
always runs at least one round (masked no-op work when no row writes).

Randomness is a tensor argument: ``run(..., noise=fn)`` takes a callable
``fn(kind, macro_step, index, shape) -> Tensor`` returning Gumbel noise
(``kind`` "sample": the draw for token ``index`` of the turn, shape (B, V);
"env": the opponent's draw, shape (B, env.step_noise_width)). Without it
the engine draws from ``generator`` on its device.

With ``run(..., ref_params=...)`` a second decode stream runs the
reference model over the same columns as the policy, on its own dense bf16
cache (whatever the policy's layout and dtype, as in JAX), and scores each
fed token from the reference logits before they advance: the harvested
``ref_logprobs`` are the ExpPrep reference log-probs, so the trainer needs
no separate reference forward.

The episode store and the slot token buffers carry one trash row/column
where JAX drops out-of-range writes (``slots.py``); the paged pools carry
one trash page (``models/layers.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.rl.algo import reinforce_advantages
from repro_torch.rl.engine import common, paging, slots
from repro_torch.rl.engine.common import ACTION_BASE
from repro_torch.rl.envs.base import TOK_PAD
from repro_torch.rl.experience import ExperienceBatch

NoiseFn = Callable[[str, int, int, tuple], torch.Tensor]


def _unported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet: it arrives with "
                               f"ROADMAP Queue 1 item {item}")


class _RefStream(NamedTuple):
    """The folded reference pass: its decode body and its carry fields."""
    decode: Callable
    logits: torch.Tensor       # (B, V) f32 last reference logits
    cache: Any                 # dense bf16 decode cache
    logprobs: torch.Tensor     # (B, T+1) f32 ref log-prob of each fed token


class _DraftStream(NamedTuple):
    """The speculative draft: its dense decode body and its cache."""
    decode: Callable
    cache: Any                 # dense bf16 decode cache of the draft


def _reset_cache_rows(cache, refill):
    """Reset a decode cache row-wise for refilled slots. Paged caches
    release the slots' pages back to the pool (no KV data touched). Other
    caches are zeroed generically over the families, as JAX's: ``pos``
    (rank 1) per row on dim 0, every other leaf (KV rings, conv windows,
    SSM states) on dim 1, with masked in-place writes. An SSM or conv
    state is not invalidated by position, so every leaf is zeroed."""
    if paging.is_paged(cache):
        return paging.release_slot_pages(cache, refill)

    def zero(leaf):
        if isinstance(leaf, tuple):                # the nested KV pair
            return type(leaf)(*(zero(x) for x in leaf))
        if leaf.dim() == 1:
            return torch.where(refill, 0, leaf)
        return leaf.masked_fill_(
            refill.view((1, -1) + (1,) * (leaf.dim() - 2)), 0)

    return zero(cache)


class CompiledRolloutEngine:
    """Multi-turn generation with slot-based continuous batching.
    ``run(params, batch, n_episodes)`` returns ``(ExperienceBatch,
    RolloutStats)``; with ``n_episodes > batch`` finished episodes free
    their slot and a fresh episode is reset into it. ``device=None`` means
    the GPU and raises if none is present.

    Options ported so far: ``cache_layout`` ("paged", the default, or
    "dense"; the ssm family takes only "dense", its recurrent
    ``MambaCache``), ``attn_impl`` (paged layout: "paged" = the paged CUDA
    kernel, "xla" = gather + dense attention; dense layout: "pallas" = the
    split-K decode kernel, "xla" = masked dense attention; ``None`` = the
    layout's kernel; with speculation the verify pass takes "paged" = the
    spec-verify kernel; the ssm decode has no attention and ignores it, as
    JAX's), ``ref_attn_impl`` (the reference stream's dense
    decode: "pallas" or "xla"), ``sampling`` ("fused" = the one-pass CUDA
    sampler, the default; "reference" = plain argmax + log-softmax),
    ``on_exhaust`` ("count" or "raise"), ``temperature``, ``top_p``,
    ``page_size``, ``cache_pages``, ``kv_dtype`` ("bf16" or "fp32") and
    ``speculation`` ("off", "self" or "draft", with ``spec_k``,
    ``draft_layers`` and ``draft_model``).
    The JAX engine's other options raise ``NotImplementedError``. Unlike
    the JAX engine, the defaults are the production path: the kernels on
    the card, and their plain versions for CPU tensors.
    """

    def __init__(self, model, env, *, max_turns: int = 4,
                 max_turn_tokens: int = 8, max_context: int = 256,
                 temperature: float = 1.0, top_p: float = 1.0,
                 sampling: str = "fused", attn_impl: Optional[str] = None,
                 ref_attn_impl: str = "pallas",
                 cache_layout: str = "paged", page_size: int = 16,
                 cache_pages: Optional[int] = None, kv_dtype: str = "bf16",
                 on_exhaust: str = "count", share_prefix: bool = False,
                 pool_growth: str = "off", speculation: str = "off",
                 spec_k: int = 4, draft_layers: Optional[int] = None,
                 draft_model=None, mesh_config=None, device=None):
        cfg = model.cfg
        if cache_layout not in ("dense", "paged"):
            raise ValueError(f"cache_layout must be 'dense' or 'paged', got "
                             f"{cache_layout!r}")
        if cache_layout == "paged" and cfg.family != "dense":
            raise ValueError(
                f"the paged KV pool is a dense-family layout; family "
                f"{cfg.family!r} decodes on its own recurrent cache: pass "
                f"cache_layout='dense'")
        if share_prefix:
            raise _unported("share_prefix (copy-on-write prefix sharing)",
                            "8")
        if kv_dtype == "int8":
            raise _unported("kv_dtype='int8'", "8")
        if on_exhaust == "preempt":
            raise _unported("on_exhaust='preempt'", "8")
        if pool_growth != "off":
            raise _unported("pool_growth", "8")
        if mesh_config is not None:
            raise _unported("mesh_config (multi-device)", "9")
        if ACTION_BASE + env.n_actions > cfg.vocab_size:
            raise ValueError("the action tokens do not fit the vocabulary")
        if env.obs_len + max_turn_tokens + env.obs_len > max_context:
            raise ValueError("max_context cannot fit even one turn")
        kernel = "paged" if cache_layout == "paged" else "pallas"
        attn_impl = kernel if attn_impl is None else attn_impl
        if attn_impl not in (kernel, "xla"):
            raise ValueError(f"attn_impl must be {kernel!r} or 'xla' on the "
                             f"{cache_layout} layout, got {attn_impl!r}")
        if ref_attn_impl not in ("pallas", "xla"):
            raise ValueError(f"ref_attn_impl must be 'pallas' or 'xla', got "
                             f"{ref_attn_impl!r}")
        if sampling not in ("fused", "reference"):
            raise ValueError(f"sampling must be 'fused' or 'reference', got "
                             f"{sampling!r}")
        if on_exhaust not in ("count", "raise"):
            raise ValueError(f"on_exhaust must be 'count' or 'raise', got "
                             f"{on_exhaust!r}")
        if kv_dtype not in ("bf16", "fp32"):
            raise ValueError(f"kv_dtype must be 'bf16' or 'fp32', got "
                             f"{kv_dtype!r}")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        draft_layers = self._check_speculation(
            cfg, speculation, cache_layout, sampling, spec_k, draft_layers,
            draft_model)
        self.model = model
        self.env = env
        self.max_turns = max_turns
        self.max_turn_tokens = max_turn_tokens
        self.max_context = max_context
        self.temperature = temperature
        self.top_p = top_p
        self.sampling = sampling
        self.attn_impl = attn_impl
        self.ref_attn_impl = ref_attn_impl
        self.cache_layout = cache_layout
        self.page_size = page_size
        self.cache_pages = cache_pages      # None = full provisioning
        self.kv_dtype = kv_dtype
        self.on_exhaust = on_exhaust
        self.speculation = speculation
        self.spec_k = spec_k
        self.draft_layers = draft_layers
        self._draft_cfg = (
            dataclasses.replace(cfg, n_layers=draft_layers)
            if speculation == "self" else
            draft_model.cfg if speculation == "draft" else None)
        self.device = resolve_device(device)

    @staticmethod
    def _check_speculation(cfg, speculation, cache_layout, sampling, spec_k,
                           draft_layers, draft_model):
        """JAX's speculation checks; returns ``draft_layers`` with its
        default (``n_layers // 2``) for ``"self"``."""
        if speculation not in ("off", "self", "draft"):
            raise ValueError(f"speculation must be 'off', 'self' or "
                             f"'draft', got {speculation!r}")
        if speculation == "off":
            return draft_layers
        if cache_layout != "paged":
            raise ValueError(
                "speculation requires cache_layout='paged': the verify pass "
                "writes the candidate chunk into pool pages before "
                "attending (models/transformer.spec_verify_step)")
        if cfg.family != "dense":
            raise ValueError(f"speculation is a dense-family feature; got "
                             f"family {cfg.family!r}")
        if sampling == "fused":
            raise ValueError(
                f"speculation={speculation!r} is incompatible with "
                f"sampling='fused': the speculative path samples from "
                f"precomputed per-step noise rows so the committed stream "
                f"stays the one sequential decode commits; the fused "
                f"sampler draws one token per call")
        if spec_k < 2:
            raise ValueError(f"spec_k must be >= 2 (k=1 is non-speculative "
                             f"decode), got {spec_k}")
        if speculation == "self":
            if draft_layers is None:
                draft_layers = max(1, cfg.n_layers // 2)
            if not 1 <= draft_layers < cfg.n_layers:
                raise ValueError(f"draft_layers must be in [1, n_layers) = "
                                 f"[1, {cfg.n_layers}), got {draft_layers}")
            return draft_layers
        if draft_model is None:
            raise ValueError(
                "speculation='draft' requires a draft_model (a small dense "
                "Model whose params are passed to run(draft_params=...)); "
                "use speculation='self' for the truncated-layer draft")
        if draft_model.cfg.family != "dense":
            raise ValueError("draft_model must be dense-family")
        if draft_model.cfg.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"draft_model vocab ({draft_model.cfg.vocab_size}) must "
                f"match the policy's ({cfg.vocab_size}): the draft proposes "
                f"token ids the verify pass scores")
        return draft_layers

    # -- carry ---------------------------------------------------------------
    def init_carry(self, B: int, N: int,
                   with_ref: bool = False) -> slots.SlotCarry:
        dev, T = self.device, self.max_context
        V = self.model.cfg.vocab_size
        live = torch.arange(B, device=dev) < N
        z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=dev)
        spec = self.speculation != "off"
        if self.cache_layout == "paged":
            cache = self.model.init_cache(
                B, T, layout="paged", page_size=self.page_size,
                n_pages=self.cache_pages, kv_dtype=self.kv_dtype,
                device=dev)
        else:
            kw = {} if self.kv_dtype == "bf16" else {"kv_dtype": self.kv_dtype}
            cache = self.model.init_cache(B, T, device=dev, **kw)
        return slots.SlotCarry(
            cache=cache,
            logits=z((B, V), torch.float32),
            env_state=self.env.reset(B, device=dev),
            tokens=torch.full((B, T + 1), TOK_PAD, dtype=torch.int32,
                              device=dev),
            gen_mask=z((B, T + 1), torch.bool),
            logprobs=z((B, T + 1), torch.float32),
            pos=z((B,), torch.int32),
            live=live,
            truncated=z((B,), torch.bool),
            n_turns=z((B,), torch.int32),
            turn_lengths=z((B, self.max_turns), torch.int32),
            episode=torch.where(live, torch.arange(B, device=dev), N).to(
                torch.int32),
            launched=torch.full((), min(B, N), dtype=torch.int32,
                                device=dev),
            returned=z((), torch.int32),
            store=slots.init_store(N, T, self.max_turns, dev),
            pages_peak=z((), torch.int32),
            kv_dropped=z((), torch.int32),
            kv_shortfall=z((B,), torch.int32),
            # the reference cache is always dense in its default bf16,
            # whatever the policy's layout and dtype (as in JAX)
            ref_cache=(self.model.init_cache(B, T, device=dev)
                       if with_ref else None),
            ref_logits=z((B, V), torch.float32) if with_ref else None,
            ref_logprobs=z((B, T + 1), torch.float32) if with_ref else None,
            # the draft's cache is always dense in its default bf16 (a
            # truncated stack or a small model; as in JAX)
            draft_cache=(transformer.init_cache(self._draft_cfg, B, T,
                                                device=dev)
                         if spec else None),
            spec_proposed=z((), torch.int32) if spec else None,
            spec_accepted=z((), torch.int32) if spec else None,
            spec_rounds=z((), torch.int32) if spec else None,
        )

    # -- pieces of the macro-step --------------------------------------------
    def _decode(self, params):
        return self.model.decode_scan_body(params, attn_impl=self.attn_impl)

    def _ref_stream(self, ref_params, c: slots.SlotCarry):
        """The carry's reference stream, or None when it has none."""
        if c.ref_cache is None:
            return None
        if ref_params is None:
            raise ValueError("this carry holds a reference stream: pass "
                             "ref_params")
        return _RefStream(
            self.model.decode_scan_body(ref_params,
                                        attn_impl=self.ref_attn_impl),
            c.ref_logits, c.ref_cache, c.ref_logprobs)

    def _draft_stream(self, params, draft_params,
                      c: slots.SlotCarry) -> Optional[_DraftStream]:
        """The carry's draft stream, or None when speculation is off. The
        draft decodes in plain attention, as JAX's (which passes no
        attn_impl): it launches no kernel."""
        if self.speculation == "off":
            return None
        if self.speculation == "self":
            d_params = transformer.draft_params_view(params,
                                                     self.draft_layers)
        elif draft_params is None:
            raise ValueError("speculation='draft' requires draft_params "
                             "(the draft_model's weights)")
        else:
            d_params = draft_params
        return _DraftStream(
            transformer.decode_scan_body(self._draft_cfg, d_params),
            c.draft_cache)

    @staticmethod
    def _ref_advance(ref: _RefStream, tok, mask, pos, rows,
                     cidx) -> _RefStream:
        """Score ``tok`` from the reference logits before they advance (0
        at position 0, where nothing predicts it, and for masked rows),
        then feed it to the reference stream."""
        ref.logprobs[rows, cidx] = torch.where(
            mask & (pos > 0), common.token_lp(ref.logits, tok), 0.0)
        (logits, cache), _ = ref.decode((ref.logits, ref.cache),
                                        (tok, mask))
        return ref._replace(logits=logits, cache=cache)

    def _feed_obs(self, decode, logits, cache, tokens, pos, obs, mask,
                  ref=None, draft=None):
        """Teacher-force the obs columns into ``mask`` rows, one decode
        step per column (and one of the reference stream and of the draft,
        when on; the draft's logits are discarded, as its proposals always
        start from a freshly sampled c0); other rows are no-ops."""
        T = self.max_context
        B = pos.shape[0]
        rows = torch.arange(B, device=pos.device)
        d_logits = (torch.zeros((B, self.model.cfg.vocab_size),
                                dtype=torch.float32, device=pos.device)
                    if draft is not None else None)
        for j in range(obs.shape[1]):
            col = torch.where(mask, obs[:, j], TOK_PAD).to(torch.int32)
            cidx = torch.where(mask, pos, T).long()     # T = trash column
            tokens[rows, cidx] = col
            if ref is not None:
                ref = self._ref_advance(ref, col, mask, pos, rows, cidx)
            if draft is not None:
                (d_logits, dc), _ = draft.decode((d_logits, draft.cache),
                                                 (col, mask))
                draft = draft._replace(cache=dc)
            (logits, cache), _ = decode((logits, cache), (col, mask))
            pos = pos + mask.to(torch.int32)
        return logits, cache, tokens, pos, ref, draft

    @staticmethod
    def _with_streams(carry: slots.SlotCarry, ref,
                      draft) -> slots.SlotCarry:
        if ref is not None:
            carry = carry._replace(ref_logits=ref.logits,
                                   ref_cache=ref.cache,
                                   ref_logprobs=ref.logprobs)
        if draft is not None:
            carry = carry._replace(draft_cache=draft.cache)
        return carry

    def _sample(self, logits, noise):
        if self.sampling == "fused":
            from repro_torch.kernels.fused_sample import ops as fs_ops
            return fs_ops.fused_sample_tokens(logits, self.temperature,
                                              top_p=self.top_p, noise=noise)
        return common.sample_with_noise(logits, noise, self.temperature,
                                        self.top_p)

    def init_feed(self, params, carry: slots.SlotCarry, ref_params=None,
                  draft_params=None) -> slots.SlotCarry:
        """Feed the initial observation of every live slot (run once before
        the macro-step loop)."""
        logits, cache, tokens, pos, ref, draft = self._feed_obs(
            self._decode(params), carry.logits, carry.cache, carry.tokens,
            carry.pos, self.env.encode_obs(carry.env_state), carry.live,
            self._ref_stream(ref_params, carry),
            self._draft_stream(params, draft_params, carry))
        return self._with_streams(carry._replace(
            logits=logits, cache=cache, tokens=tokens, pos=pos), ref, draft)

    @staticmethod
    def _more_rounds(pending) -> bool:
        """Whether any row still writes after a verify round: THE host read
        of the round. JAX's round loop is a ``lax.while_loop`` whose test
        runs on the device; eager PyTorch must read it back."""
        return bool(pending.any())

    def _spec_gen_turn(self, params, draft: _DraftStream, logits, cache,
                       tokens, gen_mask, logprobs, pos, active, m: int,
                       noise: NoiseFn):
        """One turn of speculative generation: verify rounds until no row
        writes (JAX's ``spec_gen_turn``, ``compiled.py:369-505``). Every
        round commits at least one token per writing row, so a turn runs at
        most ``max_turn_tokens`` rounds. Row b's token at turn index t is
        judged with the noise row the sequential loop draws for it,
        ``noise("sample", m, t, (B, V))``, all drawn up front (in the same
        order as the sequential loop) and gathered per row."""
        K, mtt, T = self.spec_k, self.max_turn_tokens, self.max_context
        V, n_actions = self.model.cfg.vocab_size, self.env.n_actions
        B = pos.shape[0]
        dev = pos.device
        rows = torch.arange(B, device=dev)
        i32 = lambda t: t.to(torch.int32)
        if self.temperature > 0.0:
            noise_all = torch.stack([noise("sample", m, t, (B, V))
                                     for t in range(mtt)])   # (mtt, B, V)
            noise_at = lambda t: noise_all[t.clamp(0, mtt - 1).long(), rows]
        else:
            noise_at = lambda t: None                       # greedy
        sample = lambda lg, t: common.sample_with_noise(
            lg, noise_at(t), self.temperature, self.top_p)
        dcache = draft.cache
        acted = ~active
        actions = torch.zeros((B,), dtype=torch.int32, device=dev)
        last_tok = torch.zeros_like(actions)
        tl = torch.zeros_like(actions)
        sp, sa, sr = (torch.zeros((), dtype=torch.int32, device=dev)
                      for _ in range(3))
        jarr = torch.arange(K, device=dev)[None, :]
        while True:
            write = active & ~acted & (tl < mtt)
            ek = torch.where(write, (mtt - tl).clamp(max=K), 0)
            # c0: the exact token sequential decode commits next; the draft
            # proposes c1 .. c_{K-1} and also consumes c_{K-1}, so its cache
            # covers every position a full acceptance can commit
            c0, lp0 = sample(logits, tl)
            toks, lps = [c0], [lp0]
            d_logits, cur = logits, c0
            for jj in range(K):
                (d_logits, dcache), _ = draft.decode(
                    (d_logits, dcache), (cur, write & (jj < ek)))
                if jj < K - 1:
                    cur, _ = sample(d_logits, tl + jj + 1)
                    toks.append(cur)
            chunk = torch.stack(toks, dim=1)                # (B, K)
            vlogits, cache = transformer.spec_verify_step(
                self.model.cfg, params, chunk, cache,
                attn_impl=self.attn_impl, advance=write, eff_k=ek)
            # chunk[:, j] commits iff it is the token sequential decode
            # samples from vlogits[:, j-1] with that step's noise row
            match, commits = write, i32(write)
            for jj in range(1, K):
                e_j, lp_j = sample(vlogits[:, jj - 1], tl + jj)
                lps.append(lp_j)
                match = match & (chunk[:, jj] == e_j) & (jj < ek)
                commits = commits + i32(match)
            # an action token ends the turn: never commit past the first
            is_act = common.action_mask(chunk, n_actions)
            first_act = i32(torch.where(is_act.any(dim=1),
                                        i32(is_act).argmax(dim=1), K))
            commits = torch.where(write,
                                  torch.minimum(commits, first_act + 1), 0)
            # every buffer in one scatter; the rest of the chunk lands in
            # the trash column T
            cmask = write[:, None] & (jarr < commits[:, None])
            cidx = torch.where(cmask, pos[:, None] + jarr, T).long()
            r2 = rows[:, None]
            tokens[r2, cidx] = chunk
            gen_mask[r2, cidx] = cmask
            logprobs[r2, cidx] = torch.stack(lps, dim=1)
            # carried logits: the full model's after the last committed
            # token (non-writing rows keep theirs)
            lastj = (commits - 1).clamp(0, K - 1).long()
            logits = torch.where(write[:, None], vlogits[rows, lastj],
                                 logits)
            cache = transformer.spec_commit(cache, commits)
            # the draft's rollback: its dense ring derives validity from
            # pos alone, so the committed fill line is the whole rollback
            dcache = dcache._replace(pos=pos + commits)
            last_tok = torch.where(write, chunk[rows, lastj], last_tok)
            newly = write & (first_act < commits)
            act_tok = chunk[rows, first_act.clamp(0, K - 1).long()]
            actions = torch.where(newly, act_tok - ACTION_BASE, actions)
            acted = acted | newly
            pos = pos + commits
            tl = tl + commits
            sp = sp + (ek - 1).clamp_min(0).sum(dtype=torch.int32)
            sa = sa + torch.where(write, commits - 1, 0).sum(
                dtype=torch.int32)
            sr = sr + write.sum(dtype=torch.int32)
            if not self._more_rounds(active & ~acted & (tl < mtt)):
                break
        return (logits, cache, draft._replace(cache=dcache), tokens,
                gen_mask, logprobs, pos, acted, actions, last_tok, tl,
                (sp, sa, sr))

    def turn_step(self, params, c: slots.SlotCarry, m: int,
                  noise: NoiseFn, ref_params=None,
                  draft_params=None) -> slots.SlotCarry:
        """One macro-step (one turn for every slot). Enqueues device work
        only, with no host read, unless speculation is on: then it reads
        one flag per verify round."""
        env, T, olen = self.env, self.max_context, self.env.obs_len
        mtt, mturns = self.max_turn_tokens, self.max_turns
        n_actions, V = env.n_actions, self.model.cfg.vocab_size
        B = c.pos.shape[0]
        N = c.store.tokens.shape[0] - 1
        dev = c.pos.device
        rows = torch.arange(B, device=dev)
        decode = self._decode(params)
        ref = self._ref_stream(ref_params, c)
        draft = self._draft_stream(params, draft_params, c)
        i32 = lambda t: t.to(torch.int32)

        # 1. truncation / active set
        room = c.pos + mtt + olen <= T
        truncated = c.truncated | (c.live & ~room)
        active = c.live & room & (c.n_turns < mturns)

        # 2. generation: mtt decode steps; sample, then write the token's
        #    K/V (fused sample-and-write when sampling="fused"). With
        #    speculation: verify rounds committing the same token stream.
        logits, cache, pos = c.logits, c.cache, c.pos
        tokens, gen_mask, logprobs = c.tokens, c.gen_mask, c.logprobs
        spec = (c.spec_proposed, c.spec_accepted, c.spec_rounds)
        if draft is not None:
            (logits, cache, draft, tokens, gen_mask, logprobs, pos, acted,
             actions, last_tok, tl, d_spec) = self._spec_gen_turn(
                params, draft, logits, cache, tokens, gen_mask, logprobs,
                pos, active, m, noise)
            spec = tuple(a + b for a, b in zip(spec, d_spec))
        else:
            acted = ~active
            actions = torch.zeros((B,), dtype=torch.int32, device=dev)
            last_tok = torch.zeros_like(actions)
            tl = torch.zeros_like(actions)
            for t in range(mtt):
                write = ~acted
                nz = (noise("sample", m, t, (B, V))
                      if self.temperature > 0.0 else None)
                tok, lp = self._sample(logits, nz)
                (logits_next, cache), _ = decode((logits, cache),
                                                 (tok, write))
                cidx = torch.where(write, pos, T).long()  # T: trash column
                tokens[rows, cidx] = tok
                gen_mask[rows, cidx] = write      # True where it lands
                logprobs[rows, cidx] = lp
                if ref is not None:
                    ref = self._ref_advance(ref, tok, write, pos, rows,
                                            cidx)
                pos = pos + i32(write)
                tl = tl + i32(write)
                last_tok = torch.where(write, tok, last_tok)
                newly = write & common.action_mask(tok, n_actions)
                actions = torch.where(newly, tok - ACTION_BASE, actions)
                acted = acted | newly
                logits = logits_next

        # 2b. pool telemetry after generation (peak: nothing released yet);
        #     the drop counter accumulates per-slot shortfall growth. The
        #     dense layout has no pool: its counters stay 0.
        pages_peak, kv_dropped, kv_shortfall = (c.pages_peak, c.kv_dropped,
                                                c.kv_shortfall)
        if paging.is_paged(cache):
            occ, _ = paging.pool_stats(cache)
            pages_peak = torch.maximum(pages_peak, occ)
            drop_now = paging.dropped_tokens(cache, self.page_size)
            kv_dropped = kv_dropped + (drop_now - kv_shortfall).clamp_min(
                0).sum(dtype=torch.int32)
            kv_shortfall = drop_now

        # 3. action fallback + turn accounting
        actions = common.fallback_actions(actions, last_tok, active, acted,
                                          n_actions)
        turn_idx = c.n_turns.clamp(0, mturns - 1).long()
        turn_lengths = c.turn_lengths.clone()
        turn_lengths[rows, turn_idx] = (turn_lengths[rows, turn_idx]
                                        + torch.where(active, tl, 0))
        n_turns = c.n_turns + i32(active)

        # 4. env transition (inactive rows absorb inside env.step)
        env_actions = i32(torch.where(active, actions, 0))
        state2, res = env.step(c.env_state, env_actions,
                               noise("env", m, 0,
                                     (B, env.step_noise_width)))

        # 5. harvest finished episodes (truncated -> zero reward)
        finished = c.live & (state2.done | truncated | (n_turns >= mturns))
        rewards_row = torch.where(truncated, 0.0, state2.reward).float()
        store = slots.harvest(
            c.store, finished=finished, episode=c.episode,
            tokens=tokens[:, :T], gen_mask=gen_mask[:, :T],
            logprobs=logprobs[:, :T], rewards=rewards_row, pos=pos,
            truncated=truncated, n_turns=n_turns, turn_lengths=turn_lengths,
            ref_logprobs=ref.logprobs[:, :T] if ref is not None else None)
        returned = c.returned + finished.sum(dtype=torch.int32)

        # 6. slot refill: release pages or zero dense rows, reset rows
        #    (masked, unconditional)
        refill, new_ids, launched = slots.refill_plan(finished, c.launched,
                                                      N)
        r1 = refill[:, None]
        cache = _reset_cache_rows(cache, refill)
        if ref is not None:
            ref = ref._replace(cache=_reset_cache_rows(ref.cache, refill),
                               logprobs=torch.where(r1, 0.0, ref.logprobs))
        if draft is not None:
            draft = draft._replace(cache=_reset_cache_rows(draft.cache,
                                                           refill))
        state3 = env.reset_rows(state2, refill)
        tokens = torch.where(r1, TOK_PAD, tokens)
        gen_mask = torch.where(r1, False, gen_mask)
        logprobs = torch.where(r1, 0.0, logprobs)
        pos = torch.where(refill, 0, pos)
        n_turns = torch.where(refill, 0, n_turns)
        turn_lengths = torch.where(r1, 0, turn_lengths)
        kv_shortfall = torch.where(refill, 0, kv_shortfall)

        # 7. one combined obs feed: continuing rows get the env observation,
        #    refilled rows their reset observation
        cont = active & ~state2.done & ~finished
        feed_mask = cont | refill
        obs = torch.where(r1, env.encode_obs(state3), res.obs_tokens)
        logits, cache, tokens, pos, ref, draft = self._feed_obs(
            decode, logits, cache, tokens, pos, obs, feed_mask, ref, draft)

        return self._with_streams(slots.SlotCarry(
            cache=cache, logits=logits, env_state=state3, tokens=tokens,
            gen_mask=gen_mask, logprobs=logprobs, pos=pos,
            live=(c.live & ~finished) | refill,
            truncated=torch.where(finished | refill, False, truncated),
            n_turns=n_turns, turn_lengths=turn_lengths,
            episode=torch.where(refill, new_ids,
                                torch.where(finished, N, c.episode)).to(
                                    torch.int32),
            launched=launched, returned=returned, store=store,
            pages_peak=pages_peak, kv_dropped=kv_dropped,
            kv_shortfall=kv_shortfall, spec_proposed=spec[0],
            spec_accepted=spec[1], spec_rounds=spec[2]), ref, draft)

    # ------------------------------------------------------------------------
    def default_noise(self, generator: Optional[torch.Generator] = None
                      ) -> NoiseFn:
        """Gumbel draws from ``generator`` (or the device's default
        generator) on the engine's device."""
        def draw(kind, m, index, shape):
            del kind, m, index
            return common.gumbel(shape, generator=generator,
                                 device=self.device)
        return draw

    def run(self, params, batch: int, n_episodes: Optional[int] = None, *,
            generator: Optional[torch.Generator] = None,
            noise: Optional[NoiseFn] = None, params_version: int = -1,
            ref_params=None, draft_params=None):
        """Roll out ``n_episodes`` (default ``batch``) episodes over
        ``batch`` slots. Returns ``(ExperienceBatch, RolloutStats)``.
        ``ref_params`` folds the reference pass into the rollout: the
        batch's ``ref_logprobs`` hold log p_ref of every fed token at
        positions ``1 .. context_len-1`` (zeros without it).
        ``draft_params`` are the draft model's weights for
        ``speculation="draft"`` (``"self"`` slices the policy's own
        stack)."""
        B = int(batch)
        N = int(n_episodes) if n_episodes is not None else B
        if N < 1 or B < 1:
            raise ValueError(f"batch and n_episodes must be >= 1, got {B}, "
                             f"{N}")
        if ref_params is not None and self.speculation != "off":
            raise ValueError(
                "speculation with the folded reference pass (ref_params) is "
                "not supported: the reference decode consumes tokens one "
                "step at a time and cannot consume drafted chunks. Run the "
                "reference pass separately (ExpPrep's standalone route) or "
                "turn speculation off.")
        noise = noise if noise is not None else self.default_noise(generator)
        carry = self.init_feed(
            params, self.init_carry(B, N, with_ref=ref_params is not None),
            ref_params, draft_params)
        max_macro = self.max_turns * math.ceil(N / B) + 2
        for m in range(max_macro):
            carry = self.turn_step(params, carry, m, noise, ref_params,
                                   draft_params)
            # the one host sync per turn (plus the drop counter in
            # on_exhaust="raise" mode, and one per speculative verify
            # round inside turn_step)
            if self.on_exhaust == "raise" and int(carry.kv_dropped) > 0:
                raise RuntimeError(
                    f"KV page pool exhausted during rollout: "
                    f"{int(carry.kv_dropped)} dropped KV write(s) by "
                    f"macro-step {m} (pool {carry.cache.n_pages} pages, "
                    f"peak in use {int(carry.pages_peak)}); grow "
                    f"cache_pages (see models.paging.pool_pages_needed) or "
                    f"use on_exhaust='count' to tolerate truncation")
            if int(carry.returned) >= N:
                break
        return self._finalize(carry, N, params_version)

    def _finalize(self, carry: slots.SlotCarry, N: int,
                  params_version: int = -1):
        s = carry.store
        rewards = s.rewards[:N]
        exp = ExperienceBatch(
            tokens=s.tokens[:N], gen_mask=s.gen_mask[:N],
            loss_mask=s.gen_mask[:N], logprobs=s.logprobs[:N],
            ref_logprobs=s.ref_logprobs[:N], rewards=rewards,
            returns=rewards, advantages=reinforce_advantages(rewards),
            context_len=s.context_len[:N], truncated=s.truncated[:N])
        stats = common.summarize(
            s.turn_lengths[:N].cpu(), s.context_len[:N].cpu(),
            s.n_turns[:N].cpu(), s.truncated[:N].cpu(), rewards.cpu(),
            episodes_started=int(carry.launched),
            episodes_returned=int(carry.returned),
            params_version=params_version,
            pages_in_use=int(carry.pages_peak),
            page_capacity=(carry.cache.n_pages
                           if paging.is_paged(carry.cache) else 0),
            kv_dropped_writes=int(carry.kv_dropped),
            **({} if self.speculation == "off" else dict(
                spec_proposed=int(carry.spec_proposed),
                spec_accepted=int(carry.spec_accepted),
                spec_rounds=int(carry.spec_rounds))))
        return exp, stats
