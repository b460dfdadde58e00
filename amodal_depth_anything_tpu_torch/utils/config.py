"""Hierarchical YAML config with `base_config` composition.

Replacement for the reference's OmegaConf-based recursive merge
(`src/util/config_util.py:7-26`): each YAML may list `base_config`
parents, which are loaded depth-first and deep-merged in order, with the
child last (its values win). Dotted attribute access is provided by
`ConfigNode` so configs read like the reference's (`cfg.model.kwargs`,
including the load-bearing misspelled key `loss_stategy`).
"""

from __future__ import annotations

import copy
import os
from typing import Any, Iterator

import yaml

__all__ = ["ConfigNode", "recursive_load_config", "load_config_dict",
           "find_value"]


class ConfigNode:
    """Dict wrapper with attribute access, `.get`, iteration, `to_dict`."""

    def __init__(self, data: dict):
        object.__setattr__(self, "_data", dict(data))

    def __getattr__(self, name: str) -> Any:
        try:
            return _wrap(self._data[name])
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self._data[name] = _unwrap(value)

    def __getitem__(self, name: str) -> Any:
        return _wrap(self._data[name])

    def __setitem__(self, name: str, value: Any) -> None:
        self._data[name] = _unwrap(value)

    def __contains__(self, name: str) -> bool:
        return name in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def get(self, name: str, default: Any = None) -> Any:
        return _wrap(self._data.get(name, default))

    def keys(self):
        return self._data.keys()

    def items(self):
        return ((k, _wrap(v)) for k, v in self._data.items())

    def to_dict(self) -> dict:
        return copy.deepcopy(self._data)

    def __repr__(self) -> str:
        return f"ConfigNode({self._data!r})"


def _wrap(v: Any) -> Any:
    return ConfigNode(v) if isinstance(v, dict) else v


def _unwrap(v: Any) -> Any:
    return v.to_dict() if isinstance(v, ConfigNode) else v


def _deep_merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def load_config_dict(path: str) -> dict:
    """Load one YAML with its `base_config` ancestry merged (parents in
    listed order, self last — reference `config_util.py:13-21`)."""
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    bases = cfg.pop("base_config", []) or []
    merged: dict = {}
    root = os.path.dirname(os.path.abspath(path))
    for base in bases:
        base_path = base if os.path.isabs(base) else _resolve(base, root)
        merged = _deep_merge(merged, load_config_dict(base_path))
    return _deep_merge(merged, cfg)


def _resolve(rel: str, start_dir: str) -> str:
    """Search upward from the config's dir for a relative base path (the
    reference uses repo-root-relative paths like `config/logging.yaml`)."""
    d = start_dir
    while True:
        cand = os.path.join(d, rel)
        if os.path.exists(cand):
            return cand
        parent = os.path.dirname(d)
        if parent == d:
            return os.path.join(start_dir, rel)  # will raise on open
        d = parent


def recursive_load_config(path: str) -> ConfigNode:
    return ConfigNode(load_config_dict(path))


def find_value(cfg, key: str, default=None):
    """Depth-first search for a key anywhere in the tree (reference
    `config_util.py:29`)."""
    data = cfg.to_dict() if isinstance(cfg, ConfigNode) else cfg
    stack = [data]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            if key in node:
                return _wrap(node[key])
            stack.extend(node.values())
    return default
