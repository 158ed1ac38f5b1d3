"""Build and load the CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into
its own shared library with a plain C interface, at first use, into
``_build/`` beside this module (named by a hash of the source, so an
edited source is rebuilt): ``lda_estep.cu`` (the E-step kernels K1–K8)
and ``flash_attention.cu`` (K9). A library is loaded with ``ctypes``:
pointers and the CUDA stream pass as ``c_void_p``, and each entry returns
``cudaGetLastError()``. ``build_all`` starts one ``nvcc`` per library at
once, so a cold start pays the slowest build and not their sum.
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

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "lda_estep.cu"
ATTENTION_SOURCE = CSRC / "flash_attention.cu"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float

# C entry points of lda_estep.cu and their argument types
_SIGNATURES = {
    "lda_fixed_point_blocks": [_I, _I, _I, _I],
    "lda_fixed_point_warps": [_I],
    "lda_fixed_point": [_P] * 11 + [_I, _I, _I, _F, _F, _I, _I, _I, _P],
    "lda_token_pi": [_P, _P, _P, _P, _P, _I64, _I, _I, _I, _P],
    "lda_segment_scatter": [_P, _P, _I, _P, _P, _P, _P, _P, _I, _P],
    "lda_fixed_point_csr": [_P] * 12 + [_I, _I64, _I, _F, _F, _I, _I, _P],
    "lda_token_pi_csr": [_P, _P, _P, _P, _P, _P, _I64, _I, _I, _P],
    "lda_fixed_point_smem_bytes": [_I, _I, _I],
    "lda_max_smem_bytes": [],
    "lda_dense_k_tiles": [_I],
    "lda_sweep_splits": [_I, _I],
    "lda_sweep": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    "lda_sstats": [_P, _P, _P, _P, _I, _I, _I, _P],
    "lda_onehot_block_v": [],
    "lda_memo_delta_onehot": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                              _I, _I, _I, _I, _I, _P],
    "lda_error_string": [_I],
}

# C entry points of flash_attention.cu and their argument types
_ATTENTION_SIGNATURES = {
    "attn_flash": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _P],
    "attn_max_head_dim": [],
    "attn_error_string": [_I],
}

# library name -> (source, entry points, the entry that names an error)
LIBRARIES = {
    "lda_estep": (SOURCE, _SIGNATURES, "lda_error_string"),
    "flash_attention": (ATTENTION_SOURCE, _ATTENTION_SIGNATURES,
                        "attn_error_string"),
}

_libs: Dict[str, ctypes.CDLL] = {}
#: What the builds of this process reported, by library: seconds, the nvcc
#: command and the ``-Xptxas -v`` lines (registers, shared memory, spills
#: per kernel).
BUILD_INFO: Dict[str, Dict[str, object]] = {}


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source on the machine with the card")


def nvcc_command(nvcc: str, out: Path, source: Path = SOURCE) -> List[str]:
    """The build command: sm_90a (Hopper), plain C interface, ptxas report."""
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", str(out), str(source)]


def library_path(source: Path = SOURCE) -> Path:
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{source.stem}_{digest}.so"


def build_all(names: Optional[List[str]] = None) -> Dict[str, Path]:
    """Compile every named library (all by default) whose build for this
    source does not exist yet, one ``nvcc`` each, all started together."""
    names = list(LIBRARIES) if names is None else names
    outs = {name: library_path(LIBRARIES[name][0]) for name in names}
    todo = [name for name in names if not outs[name].exists()]
    if not todo:
        return outs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    running = {}
    for name in todo:
        tmp = outs[name].with_suffix(f".{os.getpid()}.tmp")
        cmd = nvcc_command(nvcc, tmp, LIBRARIES[name][0])
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, cmd, tmp, time.perf_counter())
    failed = []
    for name, (proc, cmd, tmp, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{log}")
            continue
        os.replace(tmp, outs[name])   # atomic: others see a whole file
        BUILD_INFO[name] = dict(
            seconds=seconds, command=" ".join(cmd),
            ptxas=[ln.strip() for ln in log.splitlines()
                   if "ptxas" in ln or "spill" in ln])
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def load(name: str = "lda_estep") -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built on first use in this
    process)."""
    if name not in _libs:
        _, signatures, error_entry = LIBRARIES[name]
        lib = ctypes.CDLL(str(build_all([name])[name]))
        for entry, argtypes in signatures.items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = (ctypes.c_char_p if entry == error_entry
                          else ctypes.c_int)
        _libs[name] = lib
    return _libs[name]


def check(rc: int, name: str, library: str = "lda_estep") -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if rc != 0:
        error_entry = LIBRARIES[library][2]
        msg = getattr(load(library), error_entry)(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc}: {msg}")
