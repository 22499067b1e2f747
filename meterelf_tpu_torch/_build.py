"""Build the port's native code and load it.

All of ``csrc/*.cu`` is compiled by nvcc into one shared library with a
plain C interface (``csrc/meterelf_kernels.h``), at first use, into
``_build/`` beside this file, and loaded with ctypes (``library``). The
host JPEG readers in ``io/native/`` (the coefficient reader coefs.c, the
general decoder decoder.c and what they share, jpeg_common.c) are
compiled by gcc into a library of their own in the same place
(``host_jpeg``); they need no libjpeg and no GPU. A library's name
carries a hash of its sources and flags, so an edited source builds
anew. Nothing here runs at import
time, and nothing falls back: a missing compiler or a failed build
raises.

``--fmad=false`` keeps nvcc from contracting a*b+c into one FMA (the
exact colour and score chains are spelled with round-to-nearest
intrinsics as well); division stays IEEE (``-prec-div=true`` is nvcc's
default, and ``--use_fast_math`` is never passed).
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
from typing import Any, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
HOST_DIR = Path(__file__).resolve().parent / "io" / "native"
HOST_SRCS = ("coefs.c", "decoder.c", "jpeg_common.c")
GCC_FLAGS = ["-O3", "-fPIC", "-shared", "-pthread"]
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every exported function (csrc/meterelf_kernels.h)
_SIGNATURES = {
    "meterelf_frontend": [_P, _I, _I, _I, _P, _I, _I, _F, _F,
                          _P, _P, _P, _P],
    "meterelf_frontend_smem_bytes": [_I, _I, _I, _I],
    "meterelf_frontend_windows": [_P, _I, _I, _I, _P, _I, _I, _F, _F, _P,
                                  _P, _I, _P, _P, _P, _P, _P],
    "meterelf_windows": [_P, _I, _I, _I, _P, _P, _P, _I, _P, _I, _P, _P],
    "meterelf_ccl": [_P, _I, _I, _I, _I, _P, _P, _P],
    "meterelf_propagate": [_P, _I, _I, _I, _I, _P, _P, _P],
    "meterelf_match_scores": [_P, _I, _I, _I, _P, _I, _I, _I, _F, _P, _P],
    "meterelf_match_corr": [_P, _I, _I, _I, _P, _I, _I, _I, _P, _P],
    "meterelf_stats": [_P, _I, _P, _P, _P],
    "meterelf_stats_select": [_P, _P, _I, _P, _P],
    "meterelf_backhalf_planes": [_P, _P, _P, _I, _P, _I, _P, _P, _P],
    "meterelf_upsample_color_pack": [_P, _P, _P, _I, _P, _P, _P],
    "meterelf_readout": [_P, _I, _P, _I, _I, _P, _P, _P, _P, _I, _P, _P,
                         _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I,
                         _P, _P, _P, _P],
    "meterelf_result_pack": [_P, _P, _P, _P, _F, _P, _P, _P, _P, _P, _I, _I,
                             _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
}


class KernelLibrary:
    """The loaded library plus how it was built."""

    def __init__(self, lib: ctypes.CDLL, path: Path, seconds: float,
                 log: str) -> None:
        self.lib = lib
        self.path = path
        self.build_seconds = seconds  # 0.0 when an up-to-date .so existed
        self.build_log = log          # nvcc/ptxas output of the build

    def __getattr__(self, name: str) -> Any:
        return getattr(self.lib, name)


_LOCK = threading.Lock()
_LOADED: List[KernelLibrary] = []


def sources() -> List[Path]:
    """The kernel sources the library is built from."""
    return sorted(p for p in CSRC.iterdir()
                  if p.suffix in (".cu", ".cuh", ".h"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
        "cannot be built on this machine")


def _compile(cmd: List[str], target: Path, what: str) -> str:
    """Run a compiler command with ``-o`` a temporary name, then move the
    result to ``target``; returns the compiler's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [*cmd, "-o", str(tmp)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(
            f"{cmd[0]} failed building {what}:\n" + " ".join(cmd)
            + "\n" + r.stdout[-4000:] + r.stderr[-8000:])
    os.replace(tmp, target)
    return r.stdout + r.stderr


def _build(target: Path) -> str:
    cus = [str(p) for p in sources() if p.suffix == ".cu"]
    return _compile([_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), *cus], target,
                    "the CUDA kernels")


def _bind(lib: ctypes.CDLL, names) -> ctypes.CDLL:
    """Set the C signature of each exported function in ``names``."""
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def build_source(source: Path, name: str, entries) -> KernelLibrary:
    """One kernel source alone (an earlier revision or a patched copy of
    a ``csrc/`` file), built anew into ``_build/lib{name}.so`` against
    ``csrc/``'s headers and loaded with the C signatures of ``entries``:
    for experiments that time two builds of a kernel in one process."""
    target = BUILD_DIR / f"lib{name}.so"
    t0 = time.perf_counter()
    log = _compile([_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), str(source)],
                   target, str(source))
    return KernelLibrary(_bind(ctypes.CDLL(str(target)), entries), target,
                         time.perf_counter() - t0, log)


def library() -> KernelLibrary:
    """The kernel library, built from ``csrc/`` on first use in this
    process (or loaded from ``_build/`` when a build of the same sources
    is there)."""
    with _LOCK:
        if not _LOADED:
            target = BUILD_DIR / f"libmeterelf_kernels_{_digest()}.so"
            log: Optional[str] = None
            t0 = time.perf_counter()
            if not target.exists():
                log = _build(target)
            seconds = time.perf_counter() - t0 if log is not None else 0.0
            lib = _bind(ctypes.CDLL(str(target)), _SIGNATURES)
            _LOADED.append(KernelLibrary(lib, target, seconds, log or ""))
        return _LOADED[0]


_COEF_SIGNATURE = [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                   _P, _P, _P, _P, _P, _I]
_HOST_SIGNATURES = {
    "mej_read_coefs_region_batch": _COEF_SIGNATURE,
    "mej_read_coefs_region_batch_compact": _COEF_SIGNATURE + [_P, _P, _P],
    "mej_decode_full_batch": [_P, _P, _I, _P, _I, _I, _P, _P, _P, _I],
    "mej_decode_packed_batch": [_P, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                                _P, _I],
}
_HOST_LOADED: List[ctypes.CDLL] = []


def host_jpeg() -> ctypes.CDLL:
    """The host JPEG library (``io/native/*.c``), built with gcc on first
    use in this process (or loaded from ``_build/`` when a build of the
    same sources is there)."""
    with _LOCK:
        if not _HOST_LOADED:
            h = hashlib.sha256(" ".join(GCC_FLAGS).encode())
            paths = [HOST_DIR / n for n in HOST_SRCS]
            for p in [*paths, HOST_DIR / "jpeg_common.h"]:
                h.update(p.read_bytes())
            target = BUILD_DIR / f"libmeterelf_jpeg_{h.hexdigest()[:16]}.so"
            if not target.exists():
                _compile(["gcc", *GCC_FLAGS, "-I", str(HOST_DIR),
                          *map(str, paths)], target, "the host JPEG readers")
            lib = ctypes.CDLL(str(target))
            for name, argtypes in _HOST_SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = None
            _HOST_LOADED.append(lib)
        return _HOST_LOADED[0]
