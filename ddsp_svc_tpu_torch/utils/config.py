"""YAML config <-> attribute-access dict (missing keys read as None)."""
from __future__ import annotations

from typing import Any, Mapping

import yaml


class DotDict(dict):
    """dict with attribute access; nested dicts wrap lazily, missing -> None."""

    def __getattr__(self, name: str):
        val = dict.get(self, name)
        return DotDict(val) if type(val) is dict else val

    __setattr__ = dict.__setitem__
    __delattr__ = dict.__delitem__


def load_config(path_config: str) -> DotDict:
    with open(path_config, "r") as f:
        return DotDict(yaml.safe_load(f))


def save_config(path: str, args: dict) -> None:
    """Write a config back as yaml (next to the checkpoints)."""
    with open(path, "w") as f:
        yaml.safe_dump(_plain(args), f, sort_keys=False)


def _plain(d):
    return {k: _plain(v) for k, v in d.items()} if isinstance(d, dict) else d


def deep_update(base: dict, override: Mapping[str, Any]) -> dict:
    """Recursively merge `override` into a copy of `base`."""
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, Mapping) and isinstance(out.get(k), Mapping):
            out[k] = deep_update(dict(out[k]), v)
        else:
            out[k] = v
    return out
