"""Times phases of ``chip_smoke.py`` on two checkouts of the repo in turns.

    python3 tools/ab_phases.py OTHER_ROOT [--phases path,train]
                               [--order ABBA]

``A`` is OTHER_ROOT (for example an unpacked ``git archive`` of the parent
commit), ``B`` this checkout. Each run is a process of its own that puts
its tree's ``src`` on the path, imports that tree's ``chip_smoke.py``,
builds full-width qwen2-0.5b on random bf16 weights from seed 0 and calls
the named phase functions with the arguments their parameters name
(``torch``, ``model``, ``params``, ``report``: ``phase_path(torch, model,
params, report)``, ``phase_train(torch, model, report)``,
``phase_spec_branch(torch, model, params)``, and ``engine`` and
``dense_engine``, the path's and dense_path's engines, for
``phase_macro_step``). Each phase's wall seconds follow its lines as a
``{"phase": "<name>_wall"}`` line. ``--order A`` runs
OTHER_ROOT alone, as a bisect over several trees does. Every JSON line a
phase emits is printed again with ``tree`` ("A"/"B") and ``run`` (its
place in the order) added. Needs one CUDA device; A's kernel build reuses B's shared
objects where the sources hash the same (the names carry the hash).
"""
from __future__ import annotations

import argparse
import collections
import importlib.util
import inspect
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(root: str, phases: list) -> None:
    sys.path.insert(0, os.path.join(root, "src"))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.registry import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke.emit({"phase": "build", "seconds": _build.build_all()})
    model = build_model(get_config("qwen2-0.5b"))
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        dtype=torch.bfloat16)
    report = collections.defaultdict(dict)
    args = {"torch": torch, "model": model, "params": params,
            "report": report}
    for name in phases:
        fn = getattr(smoke, f"phase_{name}")
        names = inspect.signature(fn).parameters
        if "engine" in names and "engine" not in args:
            from repro_torch.rl.engine import CompiledRolloutEngine
            from repro_torch.rl.envs import TicTacToe
            args["engine"] = CompiledRolloutEngine(model, TicTacToe(),
                                                   **smoke.PATH)
            args["dense_engine"] = CompiledRolloutEngine(
                model, TicTacToe(), **dict(smoke.PATH, cache_layout="dense",
                                           attn_impl="pallas"))
        # phases take (torch, model[, params][, report]), by their names
        t0 = time.perf_counter()
        fn(*(args[p] for p in names))
        torch.cuda.synchronize()
        smoke.emit({"phase": f"{name}_wall",
                    "seconds": time.perf_counter() - t0})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other")
    ap.add_argument("--phases", default="path,train")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    phases = a.phases.split(",")
    if a.child:
        child(a.other, phases)
        return 0
    roots = {"A": os.path.abspath(a.other), "B": HERE}
    src = os.path.join(HERE, "build", "repro_torch")
    dst = os.path.join(roots["A"], "build", "repro_torch")
    for i, tree in enumerate(a.order):
        if tree == "A" and os.path.isdir(src):
            os.makedirs(dst, exist_ok=True)
            for f in os.listdir(src):
                if f.endswith(".so") and not os.path.exists(
                        os.path.join(dst, f)):
                    shutil.copy2(os.path.join(src, f), dst)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), roots[tree],
             "--phases", a.phases, "--child"],
            capture_output=True, text=True, cwd=roots[tree])
        for line in proc.stdout.splitlines():
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if isinstance(obj, dict):
                print(json.dumps(dict(obj, tree=tree, run=i)), flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
