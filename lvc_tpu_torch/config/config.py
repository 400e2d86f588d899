"""A self-contained yacs-style config system (a copy of
lvc_tpu/config/config.py; the port keeps its own copy so that it never
imports the JAX package).

Mirrors the public surface of the reference's config layer
(detectron2/config/config.py + lvc/config/config.py:6-95): attribute-style
nested ``CfgNode``, ``_BASE_`` YAML inheritance, dotted-path CLI overrides
via ``merge_from_list``, freeze/defrost, and the mutable ``global_cfg``
escape hatch some model code consults.
"""
from __future__ import annotations

import copy
import os
from typing import Any, List

import yaml

_BASE_KEY = "_BASE_"
_IMMUTABLE = "__immutable__"
_NEW_ALLOWED = "__new_allowed__"


class CfgNode(dict):
    """dict with attribute access, freezing, and recursive merge."""

    def __init__(self, init_dict=None, new_allowed=False):
        init_dict = {} if init_dict is None else init_dict
        super().__init__()
        self.__dict__[_IMMUTABLE] = False
        self.__dict__[_NEW_ALLOWED] = new_allowed
        for k, v in init_dict.items():
            if isinstance(v, dict) and not isinstance(v, CfgNode):
                v = CfgNode(v, new_allowed=new_allowed)
            dict.__setitem__(self, k, v)

    # -- attribute access ---------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(f"Non-existent config key: {name}")

    def __setattr__(self, name: str, value: Any) -> None:
        if self.__dict__.get(_IMMUTABLE, False):
            raise AttributeError(f"Attempted to set {name}, but CfgNode is immutable")
        self[name] = value

    def __setitem__(self, name, value):
        if self.__dict__.get(_IMMUTABLE, False):
            raise AttributeError(f"Attempted to set {name}, but CfgNode is immutable")
        dict.__setitem__(self, name, value)

    # -- freezing -----------------------------------------------------------
    def freeze(self):
        self._set_immutable(True)
        return self

    def defrost(self):
        self._set_immutable(False)
        return self

    def is_frozen(self) -> bool:
        return self.__dict__[_IMMUTABLE]

    def _set_immutable(self, value: bool):
        self.__dict__[_IMMUTABLE] = value
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_immutable(value)

    def set_new_allowed(self, value: bool):
        self.__dict__[_NEW_ALLOWED] = value
        for v in self.values():
            if isinstance(v, CfgNode):
                v.set_new_allowed(value)

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def __deepcopy__(self, memo):
        out = type(self)()  # preserve subclasses through clone()
        out.__dict__[_NEW_ALLOWED] = self.__dict__.get(_NEW_ALLOWED, False)
        for k, v in self.items():
            dict.__setitem__(out, k, copy.deepcopy(v, memo))
        return out

    # -- merging ------------------------------------------------------------
    def merge_from_other_cfg(self, other: "CfgNode"):
        _merge_a_into_b(other, self, self, [])
        return self

    def merge_from_file(self, filename: str, allow_unsafe: bool = True):
        cfg = _load_yaml_with_base(filename)
        # version compatibility (lvc/config/config.py:17-64): old YAMLs are
        # upgraded to the current schema before merging.
        if "VERSION" in self:
            from lvc_tpu_torch.config import compat

            loaded_ver = compat.guess_version(cfg, filename)
            if loaded_ver > self.VERSION:
                raise ValueError(
                    f"Config {filename} is v{loaded_ver}, newer than this "
                    f"framework's v{self.VERSION}"
                )
            if loaded_ver != self.VERSION:
                cfg.VERSION = loaded_ver
                cfg = compat.upgrade_config(cfg, to_version=self.VERSION)
        self.merge_from_other_cfg(cfg)
        return self

    def merge_from_list(self, opts: List[Any]):
        assert len(opts) % 2 == 0, f"Override list has odd length: {opts}"
        for full_key, v in zip(opts[0::2], opts[1::2]):
            d = self
            keys = full_key.split(".")
            for k in keys[:-1]:
                assert k in d, f"Non-existent key: {full_key}"
                d = d[k]
            k = keys[-1]
            assert k in d, f"Non-existent key: {full_key}"
            value = _decode_value(v)
            value = _check_and_coerce(value, d[k], full_key)
            d[k] = value
        return self

    # -- serialization ------------------------------------------------------
    def dump(self, **kwargs) -> str:
        def to_plain(cfg):
            if isinstance(cfg, CfgNode):
                return {k: to_plain(v) for k, v in cfg.items()}
            return cfg

        return yaml.safe_dump(to_plain(self), **kwargs)

    def __str__(self):
        return self.dump()

    def __repr__(self):
        return f"CfgNode({dict.__repr__(self)})"


def _decode_value(v: Any) -> Any:
    """Decode a CLI override string into a python value (yacs behavior)."""
    if not isinstance(v, str):
        return v
    try:
        v2 = yaml.safe_load(v)
        return v2
    except yaml.YAMLError:
        return v


def _check_and_coerce(value, old, full_key):
    if old is None or value is None:
        return value
    # yacs behavior: python-literal strings like "('a',)" decode to tuples
    if isinstance(value, str) and not isinstance(old, str):
        import ast

        try:
            value = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            pass
    old_type, new_type = type(old), type(value)
    if old_type == new_type:
        return value
    # yacs leniency: list<->tuple, int->float, str for everything explicit
    if isinstance(old, tuple) and isinstance(value, list):
        return tuple(value)
    if isinstance(old, list) and isinstance(value, tuple):
        return list(value)
    if isinstance(old, float) and isinstance(value, int):
        return float(value)
    raise ValueError(
        f"Type mismatch ({old_type} vs {new_type}) for config key {full_key}: {value}"
    )


def _merge_a_into_b(a: CfgNode, b: CfgNode, root: CfgNode, key_list: List[str]):
    for k, v in a.items():
        full_key = ".".join(key_list + [k])
        if k not in b:
            if b.__dict__.get(_NEW_ALLOWED, False):
                b[k] = copy.deepcopy(v)
            else:
                raise KeyError(f"Non-existent config key: {full_key}")
        elif isinstance(v, CfgNode) and isinstance(b[k], CfgNode):
            _merge_a_into_b(v, b[k], root, key_list + [k])
        else:
            b[k] = _check_and_coerce(copy.deepcopy(v), b[k], full_key)


def _load_yaml_with_base(filename: str) -> CfgNode:
    with open(filename, "r") as f:
        cfg = yaml.safe_load(f)
    if cfg is None:
        cfg = {}
    if _BASE_KEY in cfg:
        base_path = cfg.pop(_BASE_KEY)
        if not os.path.isabs(base_path):
            base_path = os.path.join(os.path.dirname(filename), base_path)
        base = _load_yaml_with_base(base_path)
        _merge_dicts(cfg, base)
        return base
    return CfgNode(cfg)


def _merge_dicts(src: dict, dst: CfgNode):
    for k, v in src.items():
        if isinstance(v, dict) and k in dst and isinstance(dst[k], CfgNode):
            _merge_dicts(v, dst[k])
        else:
            if isinstance(v, dict):
                v = CfgNode(v)
            dict.__setitem__(dst, k, v)


# Mutable global config escape hatch (lvc/config/config.py:68-95); model
# internals (e.g. the cascade QE path) consult this.
global_cfg = CfgNode()


def set_global_cfg(cfg: CfgNode) -> None:
    global global_cfg
    global_cfg.clear()
    global_cfg.update(cfg)


def get_cfg() -> CfgNode:
    from lvc_tpu_torch.config.defaults import _C

    return _C.clone()
