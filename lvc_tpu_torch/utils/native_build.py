"""Build-and-cache helper for the host-side C++ libraries (a copy of
``lvc_tpu/utils/native_build.py``; the port keeps its own).

Shared by ``data/native_io.py`` (image decode and resize) and
``evaluation/fast_eval_api.py`` (COCO matching). These are host code, not
device kernels: ``g++`` compiles each into ``build/native/`` at the root of
the checkout (listed in ``.gitignore``), never into the package or the home
directory. A library's name carries a SHA-256 of its source text, its link
flags and the host CPU's instruction-set flags (``-march=native`` code must
not reach another CPU through a copied checkout), so an edited source is
rebuilt, not loaded stale. A
build that fails returns None and the caller takes its Python path, as the
JAX package does.
"""
from __future__ import annotations

import hashlib
import logging
import os
import platform
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Sequence

logger = logging.getLogger(__name__)

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"


def _host_tag() -> str:
    tag = f"march=native|{platform.machine()}|{platform.processor()}"
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return tag + "|" + line.split(":", 1)[1].strip()
    except OSError:
        pass
    return tag


def build_shared_lib(name: str, src_path: str, link_libs: Sequence[str] = ()) -> Optional[str]:
    """Compile ``src_path`` to ``build/native/<name>-<hash>.so`` unless it
    exists; return its path, or None when the build fails (logged).

    The file is written under a temporary name and renamed into place, so
    concurrent first uses never load half a library."""
    try:
        src_bytes = Path(src_path).read_bytes()
        key = hashlib.sha256(
            src_bytes + b"\0" + " ".join(link_libs).encode() + b"\0" + _host_tag().encode()
        ).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        lib_path = BUILD_DIR / f"{name}-{key}.so"
        if lib_path.exists():
            return str(lib_path)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        base = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp, src_path]
        libs = [f"-l{lib}" for lib in link_libs]
        try:
            try:
                subprocess.run(base[:2] + ["-march=native"] + base[2:] + libs,
                               check=True, capture_output=True)
            except subprocess.CalledProcessError:
                subprocess.run(base + libs, check=True, capture_output=True)
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return str(lib_path)
    except Exception as e:  # the toolchain or a library is missing
        logger.warning("native build of %s failed (%s)", name, e)
        return None
