"""Build the hand-written CUDA kernels under ``csrc/`` and bind them with ctypes.

Each ``csrc/*.cu`` file compiles with ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a file builds in seconds).
The first launch of any kernel builds every source that is not built yet,
all ``nvcc`` processes at once, into ``build/kernels/`` at the root of the
checkout; a library's file name carries a hash of the sources and flags, so
an edited source is rebuilt.  Nothing is built or loaded at import time: the
CPU tests import every module, and this machine may have no ``nvcc``.

A :class:`CudaKernel` is one C entry point.  Its ``launches`` counter goes up
by one each time the entry point launches its kernel, which is how a run
shows that the main path went through the kernels.  One entry point may be
bound twice under two names, to count two modes of it apart; a mode that
is its own entry point (the bfloat16 modes, ``<symbol>_bf16``) counts
under ``<symbol>[bf16]``.  An entry point that runs one of several designs
(B, C, S, S', C', B', K1, K2, K3, and A in bf16) also counts each launch
under the design's name (:func:`variant_counts`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
]

_libs: Dict[str, ctypes.CDLL] = {}
KERNELS: List["CudaKernel"] = []


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path(source: Path) -> Path:
    """Where ``source`` builds to: a name carrying a hash of it, the headers
    of ``csrc/`` and the flags."""
    h = hashlib.sha256()
    for part in [source, *sorted(CSRC.glob("*.cuh"))]:
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, str]:
    """Compile every source whose library is missing, all at once.

    Returns the compiler's report (``-Xptxas=-v``: registers, shared memory,
    spills) for each source it built; raises with nvcc's output on failure.
    """
    todo = [(s, library_path(s)) for s in sources() if not library_path(s).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src, out in todo:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    reports, failed = {}, []
    for src, out, tmp, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {src.name}:\n{text}")
            continue
        os.replace(tmp, out)
        reports[src.name] = text
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def build_source(source: Path) -> Path:
    """Compile one source outside ``csrc/`` (a probe under ``tools/``, which
    includes ``csrc/`` headers by relative path) into ``build/kernels/``
    unless its library is there; returns the library's path."""
    out = library_path(source)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source.name}:\n{proc.stdout}")
        os.replace(tmp, out)
    return out


def _library(source: str) -> ctypes.CDLL:
    """The library of ``source``: a file name under ``csrc/``, or the path of
    a source elsewhere (:func:`build_source`)."""
    lib = _libs.get(source)
    if lib is None:
        if os.sep in source:
            path = build_source(Path(source))
        else:
            path = library_path(CSRC / source)
            if not path.exists():
                build_all()
        lib = ctypes.CDLL(str(path))
        lib.vnk_error_string.argtypes = [ctypes.c_int]
        lib.vnk_error_string.restype = ctypes.c_char_p
        _libs[source] = lib
    return lib


class CudaKernel:
    """One C entry point of a ``csrc/`` library.

    Calling it launches the kernel and raises if the launch was refused (the
    C function returns ``cudaGetLastError()``).
    """

    def __init__(self, source: str, symbol: str, argtypes: list, name: str = "",
                 counted: bool = True):
        self.source = source
        self.symbol = symbol
        self.name = name or symbol  # the key of its count in launch_counts()
        self.argtypes = argtypes
        self.launches = 0
        self.variants: Dict[str, int] = {}  # launches by design, where one is named
        self._fn = None
        if counted:  # a probe that no path launches (counted=False) stays out of the counts
            KERNELS.append(self)

    def __call__(self, like, *args, variant: str = "") -> None:
        """Launch on the device of tensor ``like``, on PyTorch's current
        stream there; ``args`` are the C arguments before the stream;
        ``variant`` names the design the arguments choose, if any."""
        import torch

        if self._fn is None:
            fn = getattr(_library(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        with torch.cuda.device(like.device):
            err = self._fn(*args, torch.cuda.current_stream(like.device).cuda_stream)
        if err != 0:
            msg = _library(self.source).vnk_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.launches += 1
        if variant:
            self.variants[variant] = self.variants.get(variant, 0) + 1


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
        k.variants = {}


def launch_counts() -> Dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


def variant_counts() -> Dict[str, int]:
    """Launches by design: ``<name>/<variant>`` -> count, since the last
    :func:`reset_launch_counts`."""
    return {f"{k.name}/{v}": n for k in KERNELS for v, n in k.variants.items()}


def check_cuda(name: str, takes: str, *pairs, contiguous: bool = True) -> None:
    """Raise unless each ``(tensor, dtype)`` of ``pairs`` is a tensor of
    that dtype (and contiguous, unless the kernel reads strides), all on
    one card.  ``takes`` says in words what the kernel takes (its modes'
    element types), for the error."""
    dev = pairs[0][0].device
    for t, dtype in pairs:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if t.dtype != dtype:
            raise TypeError(f"{name} takes {takes}; got {t.dtype} where it "
                            f"takes {dtype}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous tensors")
