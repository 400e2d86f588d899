"""Config version migration (upgrade / downgrade).

Counterpart of lvc/config/compat.py: old YAMLs carrying an earlier
``VERSION`` are upgraded key-by-key to the current schema before merging,
and a current config can be downgraded for export. Converters are pure
rename tables applied in sequence; ``guess_version`` dates an unversioned
YAML by which key spellings it uses.

Schema history of *this* framework:
    v1 — pre-rename: ``MODEL.RPN_HEAD.NAME`` (detectron2-era spelling) and
         ``TEST.DETECTIONS_PER_IMG``.
    v2 — current: ``MODEL.RPN.HEAD_NAME``, ``TEST.DETECTIONS_PER_IMAGE``.
"""
from __future__ import annotations

import logging
from typing import List, Optional, Tuple

from lvc_tpu_torch.config.config import CfgNode

logger = logging.getLogger(__name__)


def upgrade_config(cfg: CfgNode, to_version: Optional[int] = None) -> CfgNode:
    """Return a clone of ``cfg`` upgraded to ``to_version`` (default:
    latest). ``cfg.VERSION`` must be <= the target."""
    from lvc_tpu_torch.config.defaults import _C

    cfg = cfg.clone()
    if to_version is None:
        to_version = _C.VERSION
    assert cfg.VERSION <= to_version, (
        f"Cannot upgrade from v{cfg.VERSION} to v{to_version}"
    )
    for k in range(cfg.VERSION, to_version):
        _CONVERTERS[k + 1].upgrade(cfg)
        cfg.VERSION = k + 1
    return cfg


def downgrade_config(cfg: CfgNode, to_version: int) -> CfgNode:
    """Return a clone downgraded to ``to_version``. Lossy in general: a
    downgrade only guarantees a later ``upgrade_config`` round-trips."""
    cfg = cfg.clone()
    assert cfg.VERSION >= to_version, (
        f"Cannot downgrade from v{cfg.VERSION} to v{to_version}"
    )
    for k in range(cfg.VERSION, to_version, -1):
        _CONVERTERS[k].downgrade(cfg)
        cfg.VERSION = k - 1
    return cfg


def guess_version(cfg: CfgNode, filename: str = "") -> int:
    """Date an unversioned (partial) config by its key spellings."""
    if "VERSION" in cfg and cfg.VERSION is not None:
        return cfg.VERSION

    def has(full_key: str) -> bool:
        d = cfg
        for part in full_key.split("."):
            if not isinstance(d, dict) or part not in d:
                return False
            d = d[part]
        return True

    if has("MODEL.RPN_HEAD.NAME") or has("TEST.DETECTIONS_PER_IMG"):
        ret = 1
    else:
        from lvc_tpu_torch.config.defaults import _C

        ret = _C.VERSION
    logger.warning("Config '%s' has no VERSION; assuming v%d.", filename, ret)
    return ret


# --------------------------------------------------------------------------


def _get(cfg: CfgNode, full_key: str):
    d = cfg
    for part in full_key.split("."):
        d = d[part]
    return d


def _set(cfg: CfgNode, full_key: str, value) -> None:
    d = cfg
    parts = full_key.split(".")
    for part in parts[:-1]:
        if part not in d:
            d[part] = CfgNode(new_allowed=True)
        d = d[part]
    d[parts[-1]] = value


def _del(cfg: CfgNode, full_key: str) -> None:
    d = cfg
    parts = full_key.split(".")
    for part in parts[:-1]:
        d = d[part]
    dict.pop(d, parts[-1], None)
    # prune now-empty intermediate nodes
    if len(parts) > 1:
        parent = cfg
        for part in parts[:-2]:
            parent = parent[part]
        if isinstance(parent.get(parts[-2]), dict) and not parent[parts[-2]]:
            dict.pop(parent, parts[-2], None)


class _RenameConverter:
    """A converter defined purely by (old_key, new_key) pairs."""

    RENAME: List[Tuple[str, str]] = []

    @classmethod
    def upgrade(cls, cfg: CfgNode) -> None:
        for old, new in cls.RENAME:
            try:
                value = _get(cfg, old)
            except KeyError:
                continue  # partial config without this key
            _del(cfg, old)
            _set(cfg, new, value)

    @classmethod
    def downgrade(cls, cfg: CfgNode) -> None:
        for old, new in cls.RENAME[::-1]:
            try:
                value = _get(cfg, new)
            except KeyError:
                continue
            _del(cfg, new)
            _set(cfg, old, value)


class ConverterV2(_RenameConverter):
    """v1 -> v2."""

    RENAME = [
        ("MODEL.RPN_HEAD.NAME", "MODEL.RPN.HEAD_NAME"),
        ("TEST.DETECTIONS_PER_IMG", "TEST.DETECTIONS_PER_IMAGE"),
    ]


_CONVERTERS = {2: ConverterV2}
