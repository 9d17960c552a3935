"""Batched Connect-Four on tensors (port of
``repro/rl/envs/connect_four.py``, the paper's §3.1 environment).

The agent drops piece 1, the opponent (uniform random over legal columns)
piece 2 right after it. The opponent's draw is an argument: ``step`` takes
``(B, 7)`` Gumbel noise (JAX's ``gumbel`` of ``connect_four.py:103``). The
reset is deterministic (an empty board), so the whole initial observation
is shared across episodes (``prompt_prefix_len``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.rl.envs.base import (StepResult, TOK_BOS, TOK_DRAW,
                                      TOK_ILLEGAL, TOK_LOSS, TOK_OBS_BASE,
                                      TOK_TURN, TOK_WIN, default_reset_rows,
                                      gumbel_from_uniform)

ROWS, COLS = 6, 7


def _wins(board, piece):
    """board: (B, 6, 7). Four in a row in any direction, by static shifted
    slices."""
    b = board == piece
    win = torch.zeros(board.shape[0], dtype=torch.bool, device=board.device)
    for dr, dc in ((0, 1), (1, 0), (1, 1), (1, -1)):
        r_span = ROWS - 3 * abs(dr)
        c0 = 3 if dc < 0 else 0
        c_span = COLS - 3 * abs(dc)
        acc = torch.ones((board.shape[0], r_span, c_span), dtype=torch.bool,
                         device=board.device)
        for i in range(4):
            r, c = i * dr, c0 + i * dc
            acc = acc & b[:, r:r + r_span, c:c + c_span]
        win = win | acc.flatten(1).any(dim=1)
    return win


class C4State(NamedTuple):
    board: torch.Tensor    # (B, 6, 7) int32; row 0 = top, row 5 = bottom
    done: torch.Tensor     # (B,) bool
    reward: torch.Tensor   # (B,) f32 (sticky terminal reward)


def _drop(board, col, piece, active):
    """Drop ``piece`` into column ``col`` (B,) where ``active``."""
    B = board.shape[0]
    rows = torch.arange(B, device=board.device)
    c = col.long()
    colvals = board[rows, :, c]                              # (B, 6)
    n_empty = (colvals == 0).sum(dim=1)
    row = (n_empty - 1).clamp(0, ROWS - 1)
    do = active & (n_empty > 0)
    out = board.clone()
    out[rows, row, c] = torch.where(do, piece, board[rows, row, c])
    return out


class ConnectFour:
    n_actions = COLS
    obs_len = 3 + ROWS * COLS      # BOS + 42 cells + result + turn marker
    step_noise_width = COLS        # opponent Gumbel noise, one per column
    reset_noise_width = 0          # the reset is deterministic
    # the empty-board reset makes the full initial observation identical
    # across episodes (engine prefix sharing)
    prompt_prefix_len = 3 + ROWS * COLS

    def noise_from_uniform(self, kind: str, u):
        """The opponent's Gumbel draw from uniform ``u``."""
        del kind
        return gumbel_from_uniform(u)

    def reset(self, batch: int, *, device, noise=None) -> C4State:
        del noise
        return C4State(
            board=torch.zeros((batch, ROWS, COLS), dtype=torch.int32,
                              device=device),
            done=torch.zeros((batch,), dtype=torch.bool, device=device),
            reward=torch.zeros((batch,), dtype=torch.float32, device=device))

    def reset_rows(self, state: C4State, mask, noise=None) -> C4State:
        return default_reset_rows(self, state, mask, noise)

    def encode_obs(self, state: C4State, result_tok=None):
        B = state.board.shape[0]
        dev = state.board.device
        cells = (TOK_OBS_BASE + state.board).reshape(B, ROWS * COLS)
        bos = torch.full((B, 1), TOK_BOS, dtype=torch.int32, device=dev)
        turn = torch.full((B, 1), TOK_TURN, dtype=torch.int32, device=dev)
        res = turn if result_tok is None else result_tok[:, None]
        return torch.cat([bos, cells, res, turn], dim=1).to(torch.int32)

    def step(self, state: C4State, actions, noise):
        """actions: (B,) int in [0, 7); noise: (B, 7) f32 Gumbel draws for
        the opponent's column. Returns (state', StepResult)."""
        board, done, reward = state.board, state.done, state.reward
        a = actions.long()
        top_free = board[:, 0, :].gather(1, a[:, None])[:, 0] == 0
        illegal_now = ~top_free & ~done
        play = ~done & top_free

        board1 = _drop(board, a, 1, play)
        agent_win = _wins(board1, 1) & play
        draw1 = (board1[:, 0, :] != 0).all(dim=1) & play & ~agent_win

        cont = play & ~agent_win & ~draw1
        free = board1[:, 0, :] == 0
        opp = torch.argmax(torch.where(free, noise.float(), -torch.inf),
                           dim=-1)
        board2 = _drop(board1, opp, 2, cont)
        opp_win = _wins(board2, 2) & cont
        draw2 = (board2[:, 0, :] != 0).all(dim=1) & cont & ~opp_win

        new_done = done | illegal_now | agent_win | draw1 | opp_win | draw2
        step_reward = agent_win.float() - (opp_win | illegal_now).float()
        new_reward = torch.where(done, reward, step_reward)
        result_tok = torch.where(
            agent_win, TOK_WIN,
            torch.where(opp_win, TOK_LOSS,
                        torch.where(draw1 | draw2, TOK_DRAW,
                                    torch.where(illegal_now, TOK_ILLEGAL,
                                                TOK_TURN)))).to(torch.int32)
        new_state = C4State(board=board2, done=new_done, reward=new_reward)
        obs = self.encode_obs(new_state, result_tok)
        edge = new_done & ~done
        return new_state, StepResult(reward=new_reward * edge.float(),
                                     done=new_done, obs_tokens=obs)
