from repro_torch.rl.envs.tictactoe import TicTacToe

__all__ = ["TicTacToe"]
