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

``start_all`` starts every build in the background (one nvcc per source,
all at once) and returns; a later ``load`` of a source waits for its own
build only, so a caller can run the kernels that are ready while the
others compile. ``build_seconds`` keeps each source's nvcc wall time.
``stop_all`` kills the builds still running (each nvcc with the compiler
stages it started), for a caller that gives up before it loads them.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import signal
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
           "flash_attention_bwd", "flash_hd160", "decode_attention",
           "spec_verify_f32", "spec_verify_bf16", "spec_verify_int8",
           "ssd_scan")

_loaded: Dict[str, ctypes.CDLL] = {}
_pending: Dict[str, "_Job"] = {}     # builds started and not yet loaded
build_seconds: Dict[str, float] = {}   # nvcc wall seconds per source
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


class _Job:
    """One nvcc process; a thread waits for it, so its wall time is its
    own whenever the caller collects it."""

    def __init__(self, name: str, cmd, tmp: Path, out: Path):
        self.name, self.tmp, self.out = name, tmp, out
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
        self.log = ""
        self.seconds = 0.0
        self._waiter = threading.Thread(target=self._wait, daemon=True)
        self._waiter.start()

    def _wait(self) -> None:
        self.log, _ = self.proc.communicate()
        self.seconds = time.perf_counter() - self.t0

    def finish(self) -> None:
        self._waiter.join()
        if self.proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{self.name}.cu "
                               f"(exit {self.proc.returncode}):\n{self.log}")
        os.replace(self.tmp, self.out)    # atomic: concurrent builds agree
        build_seconds[self.name] = self.seconds


def _start_build(name: str, nvcc: str):
    """Launch nvcc for one kernel; returns its ``_Job``, or None when the
    library for this source hash already exists."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return _Job(name, cmd, tmp, out)


def _children(pid: int):
    """Pids whose parent is ``pid``, read from /proc."""
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        # the fields after the command name: state, then the parent's pid
        if int(stat[stat.rindex(")") + 2:].split()[1]) == pid:
            out.append(int(d))
    return out


def kill_tree(pid: int) -> None:
    """SIGKILL process ``pid`` and every process below it. Each process is
    stopped before its children are listed, so none starts another that
    the walk would miss (nvcc runs cicc and ptxas as children)."""
    seen, todo = [], [pid]
    while todo:
        p = todo.pop()
        try:
            os.kill(p, signal.SIGSTOP)
        except ProcessLookupError:
            continue
        seen.append(p)
        todo.extend(_children(p))
    for p in seen:
        try:
            os.kill(p, signal.SIGKILL)
        except ProcessLookupError:
            pass


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port's kernels run only on a CUDA "
            "device (CPU tensors use the plain PyTorch versions)")


def start_all() -> None:
    """Start the build of every kernel not built yet (one nvcc per source,
    all at once) and return without waiting."""
    _require_cuda()
    nvcc = find_nvcc()
    with _load_lock:
        for n in KERNELS:
            if n not in _loaded and n not in _pending:
                job = _start_build(n, nvcc)
                if job is not None:
                    _pending[n] = job


def stop_all() -> None:
    """Kill every build that ``start_all`` started and no ``load`` has
    collected, and remove its partial output."""
    with _load_lock:
        jobs = list(_pending.values())
        _pending.clear()
    for job in jobs:
        if job.proc.poll() is None:
            kill_tree(job.proc.pid)
        job._waiter.join()
        job.tmp.unlink(missing_ok=True)


def build_all() -> float:
    """Compile every kernel in parallel (one nvcc per source, all started
    together) and load them. Returns the wall seconds taken."""
    t0 = time.perf_counter()
    start_all()
    for n in KERNELS:
        load(n)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``: waits for its build when
    ``start_all`` started one, else builds it first if this source hash
    has not been built. Cached per process."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _load_lock:
        if name in _loaded:
            return _loaded[name]
        _require_cuda()
        job = _pending.pop(name, None)
        if job is None and not _lib_path(name).exists():
            job = _start_build(name, find_nvcc())
        if job is not None:
            job.finish()
        lib = ctypes.CDLL(str(_lib_path(name)))
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
