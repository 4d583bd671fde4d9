"""Build the CUDA sources under ``csrc/`` into shared libraries and load them.

Each ``csrc/<name>.cu`` becomes ``_build/<name>-<hash>.so`` with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` at first use and bound with
``ctypes``.  The hash covers the source, the shared headers (``csrc/*.cuh``)
and the flags, so an edited source is rebuilt and a stale library is never
loaded.  ``build_all`` starts one
``nvcc`` per source at once; the build log (``-Xptxas -v``: registers, shared
memory, spills) is kept beside each library, and :func:`resource_usage` reads
it per kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
SOURCES = ("lynx_conv", "hifigan_stage", "wavenet_block", "mel_spec", "lynx_layer",
           "lynx_hybrid", "hifigan_resblock")

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
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
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


_FUNCTION = re.compile(r"Function properties for (\S+)")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")


def parse_ptxas(text: str) -> List[dict]:
    """Per function of a ``-Xptxas -v`` log, in the log's order: its mangled
    ``function`` name, ``registers``, ``stack`` (stack frame bytes),
    ``spill_stores`` and ``spill_loads`` (bytes)."""
    out: List[dict] = []
    for line in text.splitlines():
        m = _FUNCTION.search(line)
        if m:
            out.append({"function": m.group(1).strip("'"), "registers": None, "stack": 0,
                        "spill_stores": 0, "spill_loads": 0})
            continue
        if not out:
            continue
        m = _FRAME.search(line)
        if m:
            out[-1].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
            continue
        m = _USED.search(line)
        if m and out[-1]["registers"] is None:
            out[-1]["registers"] = int(m.group(1))
    return out


def demangle(names: List[str]) -> List[str]:
    """C++ names as ``cu++filt`` (or ``c++filt``) reads them, without the
    anonymous namespaces, the return type and the parameter list (a
    kernel's template arguments stay); the mangled names where neither is
    found."""
    nvcc = shutil.which("nvcc") or str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
                                       / "bin" / "nvcc")
    tool = next((t for t in (str(Path(nvcc).parent / "cu++filt"), shutil.which("cu++filt"),
                             shutil.which("c++filt")) if t and Path(t).exists()), None)
    if tool is None or not names:
        return list(names)
    done = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True)
    lines = done.stdout.splitlines()
    if done.returncode != 0 or len(lines) != len(names):
        return list(names)
    return [_kernel_name(n.replace("(anonymous namespace)::", "").replace("<unnamed>::", ""))
            for n in lines]


def _kernel_name(name: str) -> str:
    """``void ns::f<T>(args)`` -> ``ns::f<T>``: up to the first ``(`` outside
    the template brackets, without a leading ``void``."""
    depth = 0
    for i, c in enumerate(name):
        depth += (c == "<") - (c == ">")
        if c == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[5:] if name.startswith("void ") else name


def resource_usage(name: str) -> List[dict]:
    """:func:`parse_ptxas` of ``csrc/<name>.cu``'s build log, each function's
    name demangled (``kernel``)."""
    usage = parse_ptxas(build_log(name))
    for u, readable in zip(usage, demangle([u["function"] for u in usage])):
        u["kernel"] = readable
    return usage


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
