"""ctypes bindings for the native image-IO core (``csrc/imageio.cpp``), a
copy of ``lvc_tpu/data/native_io.py`` (the port keeps its own; the
space-to-depth entry is left out, as the port has no s2d stem).

The C entry points are GIL-free, so the loader's ThreadPoolExecutor gets
real decode/resize parallelism — the role the reference's torch DataLoader
worker processes play (SURVEY.md §3.1 "WORKER PROCESS BOUNDARY"). Falls
back cleanly when the shared library can't be built (no g++/libjpeg);
callers must check :func:`available` or use :func:`load_resize` which
raises ImportError when native IO is unavailable.
"""
from __future__ import annotations

import ctypes
import logging
import os
import threading
from typing import Tuple

import numpy as np

from lvc_tpu_torch.utils.native_build import build_shared_lib

logger = logging.getLogger(__name__)

_CSRC = os.path.join(os.path.dirname(__file__), "csrc")
_lib = None
_tried = False
_lock = threading.Lock()


def _load():
    # the loader's worker threads call this together: one builds, the others
    # wait for it (without the lock they would take PIL's path meanwhile)
    with _lock:
        return _load_locked()


def _load_locked():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    src = os.path.join(_CSRC, "imageio.cpp")
    try:
        lib_path = build_shared_lib("imageio", src, link_libs=("jpeg", "png"))
        if lib_path is None:
            raise RuntimeError("compilation failed")
        lib = ctypes.CDLL(lib_path)
        lib.lvc_load_resize.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.lvc_load_resize.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.lvc_decode.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.lvc_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.lvc_resize.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ]
        lib.lvc_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        _lib = lib
    except Exception as e:  # pragma: no cover - build-environment dependent
        logger.warning("native imageio unavailable (%s); using PIL", e)
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def load_resize(
    path: str, short_edge: int = 0, max_size: int = 1333
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Read + decode + shortest-edge resize in one native call.

    Returns (RGB8 array (H', W', 3), original (H, W)). ``short_edge == 0``
    decodes without resizing.
    """
    lib = _load()
    if lib is None:
        raise ImportError("native imageio library not available")
    h = ctypes.c_int()
    w = ctypes.c_int()
    oh = ctypes.c_int()
    ow = ctypes.c_int()
    ptr = lib.lvc_load_resize(
        path.encode(), short_edge, max_size,
        ctypes.byref(h), ctypes.byref(w), ctypes.byref(oh), ctypes.byref(ow),
    )
    if not ptr:
        raise IOError(f"native decode failed: {path}")
    try:
        arr = np.ctypeslib.as_array(ptr, shape=(h.value, w.value, 3)).copy()
    finally:
        lib.lvc_free(ptr)
    return arr, (oh.value, ow.value)


def resize(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """PIL-convention triangle-filter resize of an RGB8/gray8 array."""
    lib = _load()
    if lib is None:
        raise ImportError("native imageio library not available")
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    sh, sw, c = img.shape
    out = np.empty((dh, dw, c), np.uint8)
    lib.lvc_resize(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), sh, sw, c,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), dh, dw,
    )
    return out[..., 0] if c == 1 else out
