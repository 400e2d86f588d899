"""Path management (a copy of ``lvc_tpu/utils/file_io.py``).

Counterpart of the reference's PathManager surface
(detectron2/utils/file_io.py + lvc/checkpoint/catalog.py FsDetHandler):
a small registry of path-scheme handlers so config/tools can reference
``catalog://`` / ``lvc://`` style resources uniformly. Local paths pass
through; remote schemes resolve to a local cache path via their handler.
"""
from __future__ import annotations

import logging
import os
import shutil
import urllib.request
from typing import Callable, Dict, Optional

logger = logging.getLogger(__name__)

_CACHE_DIR = os.path.expanduser(os.getenv("LVC_TPU_CACHE", "~/.cache/lvc_tpu"))


class PathHandler:
    """Base handler: one URI prefix -> local path resolution."""

    PREFIX: str = ""

    def get_local_path(self, path: str) -> str:
        raise NotImplementedError

    def open(self, path: str, mode: str = "r"):
        return open(self.get_local_path(path), mode)


class NativePathHandler(PathHandler):
    def get_local_path(self, path: str) -> str:
        return path


class HTTPURLHandler(PathHandler):
    """Download-and-cache for http/https URLs (reference HTTPURLHandler)."""

    PREFIX = "http"

    def get_local_path(self, path: str) -> str:
        os.makedirs(_CACHE_DIR, exist_ok=True)
        fname = os.path.basename(path.split("?")[0]) or "download"
        local = os.path.join(_CACHE_DIR, fname)
        if not os.path.exists(local):
            logger.info("Downloading %s -> %s", path, local)
            with urllib.request.urlopen(path) as r, open(local + ".tmp", "wb") as f:
                shutil.copyfileobj(r, f)
            os.replace(local + ".tmp", local)
        return local


class PathManagerBase:
    """Prefix-dispatching path resolver (reference PathManagerBase)."""

    def __init__(self):
        self._handlers: Dict[str, PathHandler] = {}
        self._native = NativePathHandler()

    def register_handler(self, handler: PathHandler, prefix: Optional[str] = None):
        self._handlers[prefix or handler.PREFIX] = handler

    def _get_handler(self, path: str) -> PathHandler:
        for prefix in sorted(self._handlers, key=len, reverse=True):
            if path.startswith(prefix):
                return self._handlers[prefix]
        return self._native

    def get_local_path(self, path: str) -> str:
        return self._get_handler(path).get_local_path(path)

    def open(self, path: str, mode: str = "r"):
        return self._get_handler(path).open(path, mode)

    def exists(self, path: str) -> bool:
        try:
            return os.path.exists(self.get_local_path(path))
        except Exception:
            return False

    def isfile(self, path: str) -> bool:
        try:
            return os.path.isfile(self.get_local_path(path))
        except Exception:
            return False


PathManager = PathManagerBase()
PathManager.register_handler(HTTPURLHandler(), "http://")
PathManager.register_handler(HTTPURLHandler(), "https://")
