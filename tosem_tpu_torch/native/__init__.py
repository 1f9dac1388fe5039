"""Native (C++) runtime components, built on demand with g++.

The port's copy of the ``load_library`` half of
``tosem_tpu/native/__init__.py``: small C++ cores with a plain C ABI,
loaded via ctypes. ``load_library`` compiles ``native/<stem>.cpp`` into
``_build/lib<stem>.so`` the first time (or when the source is newer than
the cached ``.so``) and returns the loaded ``ctypes.CDLL``. Only
``objstore`` (the runtime's shared-memory object store, one source with
no local headers) lives here so far.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(_NATIVE_DIR, "_build")
_lock = threading.Lock()
_cache = {}

CXX = os.environ.get("TOSEM_CXX", "g++")
CXXFLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared", "-Wall"]
LDFLAGS = ["-lpthread", "-lrt"]


class NativeBuildError(RuntimeError):
    pass


def _compile(stem: str, out: str) -> str:
    src = os.path.join(_NATIVE_DIR, f"{stem}.cpp")
    if not os.path.exists(src):
        raise NativeBuildError(f"no such native source: {src}")
    if (not os.path.exists(out)
            or os.path.getmtime(out) < os.path.getmtime(src)):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        # a per-process temporary name: concurrent builders never write
        # one file, and the rename below is atomic
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [CXX, *CXXFLAGS, "-o", tmp, src, *LDFLAGS]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise NativeBuildError(f"g++ failed for {stem}:\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: racing procs see old or new
    return out


def load_library(stem: str) -> ctypes.CDLL:
    """Compile ``native/<stem>.cpp`` → ``_build/lib<stem>.so`` and load it."""
    with _lock:
        if stem in _cache:
            return _cache[stem]
        out = _compile(stem, os.path.join(_BUILD_DIR, f"lib{stem}.so"))
        lib = ctypes.CDLL(out)
        _cache[stem] = lib
        return lib
