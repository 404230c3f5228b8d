"""ctypes binding of the native PLY reader ``tools/fastply.cpp`` (port of
``data/fastply_binding.py``).

The JAX package binds ``tools/libfastply.so``, built by ``make -C tools``.
The port builds the same source at first use with the host's C++ compiler
(``$CXX``, else ``c++`` or ``g++``) into ``build/host/`` at the root of the
checkout (git-ignored); the library's file name carries a hash of the source
and the flags, so an edited source is rebuilt, and no ``-march=native``: a
checkout copied to another host loads it there.  Where no compiler is found
or the build fails, :func:`available` is False and ``data/ply.py`` reads
with numpy, as the JAX package does without its library.  Nothing is built
at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "tools" / "fastply.cpp"
BUILD_DIR = ROOT / "build" / "host"
FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]

_lib = None
_tried = False


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libfastply-{h.hexdigest()[:16]}.so"


def compiler() -> Optional[str]:
    """The host's C++ compiler, or None."""
    return os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")


def build() -> Optional[Path]:
    """The built library (building it if needed), or None where the source
    or a compiler is missing or the build fails."""
    cxx = compiler()
    if cxx is None or not SOURCE.exists():
        return None
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    done = subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True,
                          timeout=300)
    if done.returncode != 0:
        return None
    os.replace(tmp, out)  # whole, even with several processes building at once
    return out


def _load():
    global _lib, _tried
    if not _tried:
        _tried = True
        path = build()
        if path is not None:
            lib = ctypes.CDLL(str(path))
            lib.fastply_read_points.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
            lib.fastply_read_points.restype = ctypes.POINTER(ctypes.c_float)
            lib.fastply_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
            lib.fastply_free.restype = None
            _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def read_points(path: str) -> Optional[np.ndarray]:
    """(N, 3) float32 vertex x/y/z, or None where the library is absent or
    does not read the file."""
    lib = _load()
    if lib is None:
        return None
    n = ctypes.c_int64(0)
    buf = lib.fastply_read_points(path.encode(), ctypes.byref(n))
    if not buf or n.value <= 0:
        return None
    try:
        arr = np.ctypeslib.as_array(buf, shape=(n.value, 3)).copy()
    finally:
        lib.fastply_free(buf)
    return arr
