"""The port's twins of ``examples/train_tictactoe.py`` and
``examples/dispatch_demo.py`` run to completion on the CPU (the pattern of
``tests/test_torch_data.py``'s example tests): the trainer with the
selector in the loop shows a switch, and the dispatcher demo on four gloo
ranks moves fewer bottleneck bytes direct than centralized."""
import importlib.util
import pathlib
import re

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

torch.set_num_threads(1)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_torch_train_tictactoe_runs_and_switches(capsys):
    assert _example("torch_train_tictactoe").main(
        ["--device", "cpu", "--steps", "2", "--batch", "4",
         "--log-every", "1", "--rollout-backend", "compiled",
         "--switch-at", "20"]) == 0
    out = capsys.readouterr().out
    assert "[switch {'from': 'short-ctx', 'to': 'long-ctx'" in out
    assert "mean return: first-20" in out


def test_torch_dispatch_demo_direct_beats_centralized(capfd):
    assert _example("torch_dispatch_demo").main(
        ["--ranks", "4", "--seq", "512"]) == 0
    out = capfd.readouterr().out
    neck = [float(x) for x in re.findall(r"bottleneck rank\s+([\d.]+) MiB",
                                         out)]
    assert "[centralized]" in out and "[direct]" in out
    assert len(neck) == 2 and neck[1] < neck[0]
    assert len(re.findall(r"est_latency_nvlink_s", out)) == 2
