"""Batched Tic-Tac-Toe on tensors (port of ``repro/rl/envs/tictactoe.py``)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.rl.envs.base import (StepResult, TOK_BOS, TOK_DRAW,
                                      TOK_ILLEGAL, TOK_LOSS, TOK_OBS_BASE,
                                      TOK_TURN, TOK_WIN, default_reset_rows)


class TTTState(NamedTuple):
    board: torch.Tensor    # (B, 9) int32: 0 empty / 1 agent / 2 opponent
    done: torch.Tensor     # (B,) bool
    reward: torch.Tensor   # (B,) float32 terminal reward (sticky)


class TicTacToe:
    n_actions = 9
    obs_len = 12           # BOS + 9 cells + result/turn + turn marker
    step_noise_width = 9   # opponent Gumbel noise per row, one per cell

    def reset(self, batch: int, *, device) -> TTTState:
        return TTTState(
            board=torch.zeros((batch, 9), dtype=torch.int32, device=device),
            done=torch.zeros((batch,), dtype=torch.bool, device=device),
            reward=torch.zeros((batch,), dtype=torch.float32, device=device))

    def reset_rows(self, state: TTTState, mask) -> TTTState:
        return default_reset_rows(self, state, mask)

    @staticmethod
    def _wins(board, piece):
        """Any row, column or diagonal of ``piece`` (slices, so no index
        table has to reach the device)."""
        b = (board == piece).reshape(-1, 3, 3)
        rows = b.all(dim=2).any(dim=1)
        cols = b.all(dim=1).any(dim=1)
        d1 = b.diagonal(dim1=1, dim2=2).all(dim=1)
        d2 = b.flip(2).diagonal(dim1=1, dim2=2).all(dim=1)
        return rows | cols | d1 | d2

    @staticmethod
    def _full(board):
        return (board != 0).all(dim=-1)

    def encode_obs(self, state: TTTState, result_tok=None):
        """-> (B, obs_len) int32 tokens describing the board."""
        B = state.board.shape[0]
        dev = state.board.device
        cells = TOK_OBS_BASE + state.board
        bos = torch.full((B, 1), TOK_BOS, dtype=torch.int32, device=dev)
        turn = torch.full((B, 1), TOK_TURN, dtype=torch.int32, device=dev)
        res = turn if result_tok is None else result_tok[:, None]
        return torch.cat([bos, cells, res, turn], dim=1).to(torch.int32)

    def step(self, state: TTTState, actions, noise):
        """actions: (B,) int in [0, 9); noise: (B, 9) f32 Gumbel draws for
        the opponent's move. Returns (state', StepResult)."""
        B = actions.shape[0]
        board, done, reward = state.board, state.done, state.reward
        rows = torch.arange(B, device=board.device)
        a = actions.long()

        legal = board.gather(1, a[:, None])[:, 0] == 0
        illegal_now = ~legal & ~done

        # agent move (only where active & legal)
        play = ~done & legal
        board1 = board.clone()
        board1[rows, a] = torch.where(play, 1, board[rows, a])
        agent_win = self._wins(board1, 1) & play
        draw1 = self._full(board1) & play & ~agent_win

        # opponent random legal move (only where the game continues)
        cont = play & ~agent_win & ~draw1
        opp_scores = torch.where(board1 == 0, noise.float(), -torch.inf)
        opp = torch.argmax(opp_scores, dim=-1)
        board2 = board1.clone()
        board2[rows, opp] = torch.where(cont, 2, board1[rows, opp])
        opp_win = self._wins(board2, 2) & cont
        draw2 = self._full(board2) & cont & ~opp_win

        new_done = done | illegal_now | agent_win | draw1 | opp_win | draw2
        step_reward = (agent_win.float()
                       - (opp_win | illegal_now).float())
        new_reward = torch.where(done, reward, step_reward)

        result_tok = torch.where(
            agent_win, TOK_WIN,
            torch.where(opp_win, TOK_LOSS,
                        torch.where(draw1 | draw2, TOK_DRAW,
                                    torch.where(illegal_now, TOK_ILLEGAL,
                                                TOK_TURN)))).to(torch.int32)
        new_state = TTTState(board=board2, done=new_done, reward=new_reward)
        obs = self.encode_obs(new_state, result_tok)
        # emit the reward once, on the done edge
        emitted = new_reward * new_done.float() * (~done).float()
        return new_state, StepResult(reward=emitted, done=new_done,
                                     obs_tokens=obs)
