"""Build and load the CUDA kernels in ``ops/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into its own shared library under ``ops/_build/`` (listed in
``.gitignore``) the first time a kernel of it is launched, then loaded
with :mod:`ctypes`. The library's file name carries a hash of the source,
so an edited kernel is rebuilt and a stale build is never loaded.
:func:`build_all` starts one ``nvcc`` per source at once, so a cold
process pays the slowest single build rather than their sum.

Every exported C function returns ``cudaGetLastError()`` after its
launch; :func:`check` turns a non-zero code into an exception, since a
refused launch never runs and a later synchronise does not report it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
SOURCES = ("flash_fwd", "flash_bwd", "paged_decode", "fused_norms")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# source name -> (seconds the build took, nvcc's stderr) for the last
# build this process ran
BUILD_LOG: Dict[str, tuple] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels are built on the machine with the card")


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _start(name: str, out: str, extra: Iterable[str]):
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, *extra, "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, tmp


def build_all(names: Optional[Iterable[str]] = None, *,
              verbose_ptxas: bool = False) -> Dict[str, float]:
    """Compile every source that has no current build, all at once.
    Returns ``{name: seconds}`` for the sources built by this call.
    ``verbose_ptxas`` adds ``-Xptxas -v`` (registers, shared memory and
    spills per kernel land in :data:`BUILD_LOG`)."""
    names = tuple(names or SOURCES)
    os.makedirs(BUILD_DIR, exist_ok=True)
    extra = ("-Xptxas", "-v") if verbose_ptxas else ()
    started = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if not os.path.exists(out):
            started[name] = (out, *_start(name, out, extra))
    took = {}
    errors = []
    for name, (out, proc, tmp) in started.items():
        _, err = proc.communicate()
        took[name] = time.perf_counter() - t0
        BUILD_LOG[name] = (took[name], err)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu "
                          f"(rc {proc.returncode}):\n{err}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _lib_path(name)
            if not os.path.exists(path):
                build_all([name])
            lib = ctypes.CDLL(path)
            _LIBS[name] = lib
        return lib


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {code} "
                           "(cudaGetLastError)")
