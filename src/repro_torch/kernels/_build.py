"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C entry point (no PyTorch headers,
so ``nvcc`` takes seconds, not minutes). At first use in a process it is
compiled for Hopper into ``build/repro_torch/<name>-<hash>.so`` under the
repository root — the hash covers the source, the shared ``csrc/*.cuh``
headers and the flags, so an edited source rebuilds — and loaded with
``ctypes``. There is no fallback: without ``nvcc`` or a CUDA device,
loading raises.

The kernels may be loaded and launched from more than one host thread (the
async pipeline's update worker beside the rollout): ``load`` builds and
loads under a lock, and each wrapper bumps its launch counter under
``LAUNCH_LOCK``, so the exact launch counts stay exact.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
KERNELS = ("paged_attention", "fused_sample", "flash_attention",
           "flash_attention_bwd", "decode_attention", "spec_verify",
           "ssd_scan")

_loaded: Dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()
LAUNCH_LOCK = threading.Lock()   # held by every wrapper's counter bump


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default prefix. Raises if none is found."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the port's CUDA kernels are compiled at first "
        "use and cannot run without the CUDA toolkit; CPU tensors use the "
        "plain PyTorch versions instead")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start_build(name: str, nvcc: str):
    """Launch nvcc for one kernel; returns (process, tmp, target) or None
    when the library for this source hash already exists."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)          # atomic: concurrent builds agree


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port's kernels run only on a CUDA "
            "device (CPU tensors use the plain PyTorch versions)")


def build_all() -> float:
    """Compile every kernel in parallel (one nvcc per source, all started
    together) and load them. Returns the wall seconds taken."""
    t0 = time.perf_counter()
    _require_cuda()
    nvcc = find_nvcc()
    jobs = {n: _start_build(n, nvcc) for n in KERNELS}
    for n, job in jobs.items():
        if job is not None:
            _finish_build(n, job)
    for n in KERNELS:
        load(n)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if this
    source hash has not been built. Cached per process."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _load_lock:
        if name in _loaded:
            return _loaded[name]
        _require_cuda()
        out = _lib_path(name)
        if not out.exists():
            _finish_build(name, _start_build(name, find_nvcc()))
        lib = ctypes.CDLL(str(out))
        _loaded[name] = lib
        return lib


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (the kernels'
    split plans size their grids by it)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
