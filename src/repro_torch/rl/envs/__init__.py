from repro_torch.rl.envs.bandit import MultiArmedBandit
from repro_torch.rl.envs.connect_four import ConnectFour
from repro_torch.rl.envs.tictactoe import TicTacToe

ENVS = {"tictactoe": TicTacToe, "connect_four": ConnectFour,
        "bandit": MultiArmedBandit}


def make_env(name: str, **kw):
    return ENVS[name](**kw)


__all__ = ["ConnectFour", "ENVS", "MultiArmedBandit", "TicTacToe",
           "make_env"]
