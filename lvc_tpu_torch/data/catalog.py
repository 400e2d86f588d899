"""Dataset and metadata catalogs (a copy of lvc_tpu/data/catalog.py, kept so
that the port never imports the JAX package)."""
from __future__ import annotations

import copy
import types
from typing import Callable, Dict


class _DatasetCatalog:
    def __init__(self):
        self._registry: Dict[str, Callable] = {}

    def register(self, name: str, func: Callable):
        assert callable(func), "must register a callable"
        if name in self._registry:
            raise KeyError(f"Dataset '{name}' already registered")
        self._registry[name] = func

    def get(self, name: str):
        if name not in self._registry:
            raise KeyError(
                f"Dataset '{name}' not registered. Available: {sorted(self._registry)[:20]}..."
            )
        return self._registry[name]()

    def list(self):
        return list(self._registry.keys())

    def remove(self, name: str):
        self._registry.pop(name)

    def __contains__(self, name: str):
        return name in self._registry

    def clear(self):
        self._registry.clear()


class Metadata(types.SimpleNamespace):
    name: str = "N/A"

    def get(self, key, default=None):
        return getattr(self, key, default)

    def set(self, **kwargs):
        for k, v in kwargs.items():
            setattr(self, k, v)
        return self

    def as_dict(self):
        return copy.copy(self.__dict__)


class _MetadataCatalog:
    def __init__(self):
        self._registry: Dict[str, Metadata] = {}

    def get(self, name: str) -> Metadata:
        assert len(name)
        if name not in self._registry:
            self._registry[name] = Metadata(name=name)
        return self._registry[name]

    def list(self):
        return list(self._registry.keys())

    def clear(self):
        self._registry.clear()


DatasetCatalog = _DatasetCatalog()
MetadataCatalog = _MetadataCatalog()
