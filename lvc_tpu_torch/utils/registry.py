"""Minimal name -> callable registry (detectron2/utils/registry.py analogue);
a copy of ``lvc_tpu/utils/registry.py``, which the port keeps its own of."""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._map: Dict[str, Any] = {}

    def register(self, obj: Optional[Any] = None, name: Optional[str] = None):
        if obj is None:

            def deco(fn_or_class):
                key = name or fn_or_class.__name__
                self._do_register(key, fn_or_class)
                return fn_or_class

            return deco
        self._do_register(name or obj.__name__, obj)
        return obj

    def _do_register(self, name: str, obj: Any):
        if name in self._map:
            raise KeyError(f"'{name}' already registered in {self._name}")
        self._map[name] = obj

    def get(self, name: str) -> Any:
        if name not in self._map:
            raise KeyError(f"'{name}' not found in {self._name} registry. "
                           f"Available: {sorted(self._map)}")
        return self._map[name]

    def __contains__(self, name: str) -> bool:
        return name in self._map

    def keys(self):
        return self._map.keys()
