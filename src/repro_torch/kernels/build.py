"""Build and load the CUDA kernels.

``csrc/lda_estep.cu`` is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, at first use, into ``_build/``
beside this module (named by a hash of the source, so an edited source is
rebuilt). It is loaded with ``ctypes``: pointers and the CUDA stream pass
as ``c_void_p``, and each entry returns ``cudaGetLastError()``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

SOURCE = Path(__file__).resolve().parent / "csrc" / "lda_estep.cu"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float

# C entry points of lda_estep.cu and their argument types
_SIGNATURES = {
    "lda_fixed_point": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I,
                        _I, _P],
    "lda_token_pi": [_P, _P, _P, _P, _P, _I64, _I, _I, _I, _P],
    "lda_segment_scatter": [_P, _P, _P, _I64, _P, _P, _P, _P, _P, _I, _P],
    "lda_fixed_point_csr_blocks": [_I, _I],
    "lda_fixed_point_csr": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F,
                            _F, _I, _I, _P],
    "lda_token_pi_csr": [_P, _P, _P, _P, _P, _P, _I64, _I, _I, _P],
    "lda_fixed_point_max_k": [],
    "lda_error_string": [_I],
}

_lib: Optional[ctypes.CDLL] = None
#: What the build of this process reported: seconds, the nvcc command and
#: the ``-Xptxas -v`` lines (registers, shared memory, spills per kernel).
BUILD_INFO: Dict[str, object] = {}


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source on the machine with the card")


def nvcc_command(nvcc: str, out: Path) -> List[str]:
    """The build command: sm_90a (Hopper), plain C interface, ptxas report."""
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", str(out), str(SOURCE)]


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"liblda_estep_{digest}.so"


def build() -> Path:
    """Compile the library unless this source's build already exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = nvcc_command(find_nvcc(), tmp)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)     # atomic: a concurrent build sees a whole file
    BUILD_INFO.update(
        seconds=seconds, command=" ".join(cmd),
        ptxas=[ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
               if "ptxas" in ln])
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first use in this process)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = (ctypes.c_char_p if name == "lda_error_string"
                          else ctypes.c_int)
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if rc != 0:
        msg = load().lda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc}: {msg}")
