"""Build and load the port's CUDA kernels.

Each source under ``ops/csrc`` is compiled by ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface, then loaded with ``ctypes``.
Nothing happens at import: the first call that needs a kernel builds it,
so ``python3 chip_smoke.py`` alone builds everything from the checkout.
Libraries land in ``build/kernels`` at the repository root (ignored by
git), named by a digest of source and flags, so an edited source is
rebuilt and an unchanged one is reused.

Every kernel wrapper owns a :class:`LaunchCounter` registered here; a run
resets them all, drives a path, and reads which kernels it launched.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

#: kernel library name -> source file under ops/csrc
SOURCES = {"embedding_bag": "embedding_bag.cu",
           "flash_attention": "flash_attention.cu",
           "flash_attention_bwd": "flash_attention_bwd.cu",
           "paged_attention": "paged_attention.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

#: flags of one library on top of NVCC_FLAGS. The lookup is held bitwise
#: to its plain version, so nvcc may not contract its adds into FMAs;
#: attention is held to a tolerance and needs the FMA rate.
EXTRA_FLAGS = {"embedding_bag": ("--fmad=false",)}


def nvcc_flags(name: str) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())

#: nvcc's output of each library built by this process (registers, spills)
build_logs: Dict[str, str] = {}

_build_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class LaunchCounter:
    """A plain count of kernel launches, bumped by the wrapper right where
    it launches its kernel and nowhere else."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> None:
        with self._lock:
            self.value += n

    def reset(self) -> None:
        with self._lock:
            self.value = 0


_counters_lock = threading.Lock()
_counters: Dict[str, LaunchCounter] = {}


def launch_counter(name: str) -> LaunchCounter:
    """The one counter of kernel ``name`` (created on first ask)."""
    with _counters_lock:
        return _counters.setdefault(name, LaunchCounter(name))


def launch_counts() -> Dict[str, int]:
    with _counters_lock:
        return {n: c.value for n, c in _counters.items()}


def reset_launch_counts() -> None:
    with _counters_lock:
        for c in _counters.values():
            c.reset()


def raw_stream(index: int) -> int:
    """The handle of device ``index``'s current stream, as an int (no
    ``Stream`` object is made), for a C entry point's ``stream``."""
    return torch._C._cuda_getCurrentRawStream(index)


def nvcc_path() -> str:
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda); "
                       "the CUDA kernels cannot be built")


def lib_path(name: str) -> Path:
    src = (_CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(
        src + " ".join(nvcc_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> float:
    """Compile every named library that is not built yet (all by default),
    one ``nvcc`` per source, all started together. Returns the seconds it
    took; raises with nvcc's output if any build fails."""
    names = list(SOURCES if names is None else names)
    t0 = time.perf_counter()
    todo = [(n, lib_path(n)) for n in names if not lib_path(n).exists()]
    if not todo:
        return time.perf_counter() - t0
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, out in todo:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *nvcc_flags(name), "-o", str(tmp),
               str(_CSRC / SOURCES[name])]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)   # atomic: a concurrent build never
            # loads a half-written library
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _build_lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            _libs[name] = lib
        return lib
