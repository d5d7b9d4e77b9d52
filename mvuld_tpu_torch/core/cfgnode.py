"""A minimal yacs-compatible configuration node.

The reference configures everything through a yacs ``CfgNode`` tree with
YAML ``BASE`` includes and ``--opts KEY VALUE`` CLI overrides
(reference: mvuld/config.py:5-400, _update_config_from_file:324-336).
yacs is not available in this environment, so this is a small, dependency-free
re-implementation of the subset the framework needs, with the same semantics:

  * attribute-style access (``cfg.TRAIN.BASE_LR``),
  * ``merge_from_file`` with recursive ``BASE`` includes,
  * ``merge_from_list([...KEY, VALUE...])`` with type coercion,
  * ``freeze()`` / ``defrost()`` immutability,
  * ``dump()`` to YAML.

The port's copy imports ``yaml`` only where a YAML file is read or written,
so the package imports on a machine without it; list overrides on the
command line parse as JSON first.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Iterable, List

_FROZEN = "__frozen__"


class CfgNode(dict):
    """Dict subclass with attribute access and freeze semantics."""

    def __init__(self, init: dict | None = None):
        super().__init__()
        object.__setattr__(self, _FROZEN, False)
        if init:
            for k, v in init.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(f"CfgNode has no attribute {name!r}")

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, _FROZEN):
            raise AttributeError(f"Cannot set {name!r}: CfgNode is frozen")
        self[name] = CfgNode(value) if isinstance(value, dict) and not isinstance(value, CfgNode) else value

    def __setitem__(self, key: str, value: Any) -> None:
        if object.__getattribute__(self, _FROZEN):
            raise AttributeError(f"Cannot set {key!r}: CfgNode is frozen")
        super().__setitem__(key, value)

    # -- freeze --------------------------------------------------------------
    def freeze(self) -> None:
        object.__setattr__(self, _FROZEN, True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()

    def defrost(self) -> None:
        object.__setattr__(self, _FROZEN, False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, _FROZEN)

    def clone(self) -> "CfgNode":
        node = CfgNode()
        for k, v in self.items():
            node[k] = v.clone() if isinstance(v, CfgNode) else copy.deepcopy(v)
        return node

    # -- merging ---------------------------------------------------------
    def merge_from_other_cfg(self, other: dict) -> None:
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(self.get(k), CfgNode):
                self[k].merge_from_other_cfg(v)
            else:
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    def merge_from_file(self, filename: str) -> None:
        """Merge a YAML file, honoring recursive ``BASE`` includes.

        Mirrors the reference's _update_config_from_file
        (mvuld/config.py:324-336): BASE files are merged first (depth-first),
        relative to the including file's directory.
        """
        import yaml
        with open(filename) as f:
            raw = yaml.safe_load(f) or {}
        for base in raw.get("BASE", ["''"]) if isinstance(raw.get("BASE"), list) else [raw.get("BASE", "")]:
            if base and base.strip("'\""):
                self.merge_from_file(os.path.join(os.path.dirname(filename), base))
        raw.pop("BASE", None)
        self.merge_from_other_cfg(raw)

    def merge_from_list(self, opts: Iterable[Any]) -> None:
        opts = list(opts)
        if len(opts) % 2 != 0:
            raise ValueError(f"Override list must have even length, got {opts}")
        for key, value in zip(opts[0::2], opts[1::2]):
            node: CfgNode = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    raise KeyError(f"Unknown config key {key!r} (no node {p!r})")
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Unknown config key {key!r}")
            node[leaf] = _coerce(value, node[leaf])

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> dict:
        return {k: (v.to_dict() if isinstance(v, CfgNode) else v) for k, v in self.items()}

    def dump(self) -> str:
        import yaml
        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"CfgNode({self.to_dict()!r})"


def _coerce(value: Any, old: Any) -> Any:
    """Coerce a CLI string to the type of the existing value, yacs-style."""
    if not isinstance(value, str) or old is None:
        return value
    if isinstance(old, bool):
        if value.lower() in ("true", "1", "yes"):
            return True
        if value.lower() in ("false", "0", "no"):
            return False
        raise ValueError(f"Cannot coerce {value!r} to bool")
    if isinstance(old, int):
        return int(value)
    if isinstance(old, float):
        return float(value)
    if isinstance(old, (list, tuple)):
        import json
        try:
            parsed = json.loads(value)
        except json.JSONDecodeError:
            import yaml
            parsed = yaml.safe_load(value)
        return type(old)(parsed)
    return value


def load_cfg(defaults: CfgNode, yaml_file: str | None = None, opts: List[Any] | None = None) -> CfgNode:
    cfg = defaults.clone()
    if yaml_file:
        cfg.merge_from_file(yaml_file)
    if opts:
        cfg.merge_from_list(opts)
    return cfg
