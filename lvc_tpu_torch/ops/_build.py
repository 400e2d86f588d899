"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file (``roi_align_fwd``: K1, K2; ``roi_align_bwd``: K3;
``flash_attention_fwd``: the DINO verifier's attention) exposes a plain C
interface. It is compiled by hand
with ``nvcc`` for ``sm_90a`` into a shared library under ``build/kernels/`` at
the root of the checkout (listed in ``.gitignore``) on first use, and loaded
with ``ctypes``. That takes seconds, where ``torch.utils.cpp_extension.load``
(which compiles PyTorch's headers) takes minutes. The library's file name
carries a hash of its source, so an edited source is rebuilt.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
SOURCES = ("roi_align_fwd", "roi_align_bwd", "flash_attention_fwd")

_loaded = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
# roi_align_{band,paired}_fwd(level_ptrs, heights, widths, L, B, C, P, NR, NT,
#   n, lvl, xs, inv, rows, wy, tcol, wx, out, is_bf16, stream) -> cudaError_t
_ROI_ALIGN_ARGS = [ctypes.POINTER(_P), ctypes.POINTER(_I), ctypes.POINTER(_I)] + [_I] * 7 + [
    _P, _P, _P, _P, _P, _P, _P, _P, _I, _P,
]
# roi_align_paired_bwd(acc_ptrs, acc_rows, widths, L, C, P, NR, NT, n, lvl, xs,
#   inv, rows, wy, tcol, wx, gout, is_bf16, stream) -> cudaError_t
_ROI_ALIGN_BWD_ARGS = [ctypes.POINTER(_P), ctypes.POINTER(_I), ctypes.POINTER(_I)] + [_I] * 6 + [
    _P, _P, _P, _P, _P, _P, _P, _P, _I, _P,
]
SIGNATURES = {
    "roi_align_fwd": {
        "roi_align_band_fwd": _ROI_ALIGN_ARGS,
        "roi_align_paired_fwd": _ROI_ALIGN_ARGS,
    },
    "roi_align_bwd": {"roi_align_paired_bwd": _ROI_ALIGN_BWD_ARGS},
    # flash_attention_fwd(q, k, v, sb, sn, sh, B, N, H, d, scale, out, is_bf16,
    #   stream) -> cudaError_t
    "flash_attention_fwd": {
        "flash_attention_fwd": [_P, _P, _P] + [ctypes.c_longlong] * 3 + [_I] * 4
        + [ctypes.c_float, _P, _I, _P],
    },
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built on this machine")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library exists. Returns the
    compiler's register and shared-memory report (empty if nothing was
    built)."""
    target = library_path(name)
    if target.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, target)  # atomic: a concurrent build never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return proc.stdout + proc.stderr


def load_library(name: str = "roi_align_fwd") -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name not in _loaded:
        build(name)
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _I
        _loaded[name] = lib
    return _loaded[name]
