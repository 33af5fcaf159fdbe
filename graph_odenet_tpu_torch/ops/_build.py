"""Build and load the CUDA kernels of ``csrc/`` (nvcc + ctypes).

Each ``csrc/*.cu`` source becomes one shared library, compiled from the
package's own sources at first use into ``graph_odenet_tpu_torch/_build/``.
A library is named by a hash of its source, every ``csrc/*.cuh`` header and
the flags, so that an edited source or header is rebuilt.  ``build`` starts
one nvcc per missing library, all at once, and waits for all of them.  The
libraries expose a plain C interface, so a build needs no PyTorch headers
and takes seconds.  Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["CSRC", "SOURCES", "BUILD_DIR", "NVCC_FLAGS", "library_path", "build", "load_library"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = {path.stem: path for path in sorted(CSRC.glob("*.cu"))}
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_p, _i, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_u32, _f32 = ctypes.c_uint32, ctypes.c_float
# argtypes of every C entry point, by library.
_SIGNATURES = {
    "csr_spmm": {
        "gode_csr_spmm_f32": [
            _p, _p, _p, _i64,          # seg_ptr, seg_row, seg_slot, n_seg
            _p, _p, _i64,              # split_row, split_ptr, n_split
            _p, _p, _p, _p, _p, _p,    # col, w, alpha, x, out, partial
            _i64, _i64, _p,            # F, feat, stream
        ],
        "gode_csr_bucket_f32": [
            _p, _p, _p, _i64,          # seg_ptr, seg_row, seg_slot, n_seg
            _p, _p, _i64,              # split_row, split_ptr, n_split
            _p, _i64,                  # empty_row, n_empty
            _p, _p, _p, _p, _p, _p,    # col, w, alpha, x, out, partial
            _i64, _i64, _i, _p,        # F, feat, accumulate, stream
        ],
    },
    "gat_attn": {
        "gode_gat_fwd_f32": [
            _p, _p, _p, _i64,          # seg_ptr, seg_row, seg_slot, n_seg
            _p, _p, _i64,              # split_row, split_ptr, n_split
            _p, _p, _p,                # senders, logits, wh
            _i, _p, _u32, _u32, _f32,  # mask_mode, dmask, seed, keep24, inv_keep
            _p, _p, _p, _p, _p, _p,    # out, m, l, p_acc, p_m, p_l
            _i64, _i64, _p,            # H, F, stream
        ],
        "gode_gat_bwd_f32": [
            _i64, _p, _p,              # n_edge, senders, receivers
            _p, _p,                    # logits, wh
            _p, _p, _p, _p,            # g, m, l, beta
            _i, _p, _u32, _u32, _f32,  # mask_mode, dmask, seed, keep24, inv_keep
            _p, _p,                    # dlogits, alpha_d
            _i64, _i64, _p,            # H, F, stream
        ],
        "gode_gat_dwh_f32": [
            _p, _p, _p, _i64,          # seg_ptr, seg_row, seg_slot, n_seg
            _p, _p, _i64,              # split_row, split_ptr, n_split
            _p, _p, _p, _p, _p, _p,    # receivers, s_src, s_dst, m, l, g
            _f32,                      # slope
            _i, _u32, _u32, _f32,      # mask_mode, seed, keep24, inv_keep
            _p, _p,                    # out, partial
            _i64, _i64, _p,            # H, F, stream
        ],
    },
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; cannot build the kernels")


def library_path(name: str) -> Path:
    """Where the library built from the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [SOURCES[name], *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.name.encode() + path.read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(names=None) -> dict:
    """Compile the named sources (default: all) unless up to date.

    Returns ``{name: library path}``.  The compiler's register and spill
    report (``-Xptxas -v``) is kept beside each library as
    ``<name>.ptxas.txt``.
    """
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    BUILD_DIR.mkdir(exist_ok=True)
    procs = {}
    for n in todo:
        tmp = BUILD_DIR / f"{library_path(n).name}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{SOURCES[n].name}: nvcc exited with {proc.returncode}:\n{err}")
            continue
        lib = library_path(n)
        (BUILD_DIR / f"{lib.stem}.ptxas.txt").write_text(err)
        os.replace(tmp, lib)  # atomic: a concurrent process never loads a partial file
    if failed:
        raise RuntimeError("\n".join(failed))
    return {n: library_path(n) for n in names}


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C signatures."""
    lib = ctypes.CDLL(str(build([name])[name]))
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib
