"""Build and load the CUDA kernels of ``csrc/`` (nvcc + ctypes).

The shared library is compiled from the package's own sources at first use
into ``graph_odenet_tpu_torch/_build/``, named by a hash of source and flags
so that an edited source is rebuilt.  It exposes a plain C interface, so the
build needs no PyTorch headers and takes seconds.  Nothing here runs when
the module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["SOURCE", "BUILD_DIR", "NVCC_FLAGS", "library_path", "build", "load_library"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "csr_spmm.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; cannot build csr_spmm")


def library_path() -> Path:
    """Where the library built from the current source and flags lives."""
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libcsr_spmm_{tag}.so"


def build() -> Path:
    """Compile ``SOURCE`` unless an up-to-date library exists; return its path.

    The compiler's register and spill report (``-Xptxas -v``) is kept beside
    the library as ``<name>.ptxas.txt``.
    """
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = BUILD_DIR / f"{lib.name}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n{proc.stderr}")
    (BUILD_DIR / f"{lib.stem}.ptxas.txt").write_text(proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent process never loads a partial file
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C signatures."""
    lib = ctypes.CDLL(str(build()))
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.gode_csr_spmm_f32.argtypes = [
        p, p, p, i64,      # seg_ptr, seg_row, seg_slot, n_seg
        p, p, i64,         # split_row, split_ptr, n_split
        p, p, p, p, p,     # col, w, x, out, partial
        i64, p,            # F, stream
    ]
    lib.gode_csr_spmm_f32.restype = ctypes.c_int
    return lib
