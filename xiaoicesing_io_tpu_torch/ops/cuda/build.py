"""Build the CUDA sources under ``csrc/`` into shared libraries and load them.

Each ``csrc/<name>.cu`` becomes ``_build/<name>-<hash>.so`` with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` at first use and bound with
``ctypes``.  The hash covers the source and the flags, so an edited source is
rebuilt and a stale library is never loaded.  ``build_all`` starts one
``nvcc`` per source at once; the build log (``-Xptxas -v``: registers, shared
memory, spills) is kept beside each library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
SOURCES = ("lynx_conv", "hifigan_stage")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from source at first use")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every missing library in parallel; returns seconds per built source."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        log = open(target.with_suffix(".log"), "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                       tmp, target, log, time.perf_counter())
    seconds = {}
    failed = []
    for name, (proc, tmp, target, log, start) in procs.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - start
        if rc != 0:
            failed.append(f"{name}: nvcc exited {rc}\n{target.with_suffix('.log').read_text()}")
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        target = _target(name)
        if not target.exists():
            build_all([name])
        lib = ctypes.CDLL(str(target))
        _loaded[name] = lib
    return lib


def check(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")


def stream_ptr(device: Optional[object] = None) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
