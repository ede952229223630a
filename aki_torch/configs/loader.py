"""YAML configs with the subset of Hydra the reference uses (counterpart of
``aki_tpu/configs/loader.py``; the same results on the same files):

- a ``defaults`` list of fragments merged in order (``sft_datasets/*.yaml``
  -> ``datasets:`` entries), ``_self_`` placing the file's own keys;
- ``${key.path}`` interpolation (e.g. ``${root}``); a value that is one
  reference keeps the referenced type;
- dotted-path overrides ``a.b=c``, each value parsed as YAML;
- :class:`Config`: a dict with attribute access.

PyYAML is imported inside the functions that parse text: importing this
module needs no ``yaml``.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any

_INTERP = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")


class Config(dict):
    """dict with attribute access, recursive."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return Config(v) if isinstance(v, dict) and not isinstance(v, Config) else v

    def get_path(self, dotted: str, default=None):
        cur: Any = self
        for part in dotted.split("."):
            if not isinstance(cur, dict) or part not in cur:
                return default
            cur = cur[part]
        return cur


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def _lookup(root: dict, dotted: str) -> Any:
    cur: Any = root
    for part in dotted.split("."):
        cur = cur[part]
    return cur


def _interpolate(node: Any, root: dict) -> Any:
    if isinstance(node, dict):
        return {k: _interpolate(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [_interpolate(v, root) for v in node]
    if isinstance(node, str):
        m = _INTERP.fullmatch(node)
        if m:
            return _lookup(root, m.group(1))
        return _INTERP.sub(lambda m: str(_lookup(root, m.group(1))), node)
    return node


def _parse_value(s: str) -> Any:
    import yaml

    return yaml.safe_load(s)


def _read(path: Path) -> dict:
    import yaml

    return yaml.safe_load(path.read_text()) or {}


def load_config(path: str | Path, overrides: list[str] | None = None) -> Config:
    path = Path(path)
    raw = _read(path)

    merged: dict = {}
    for entry in raw.pop("defaults", []):
        if entry == "_self_":
            merged = _merge(merged, raw)
            raw = {}
        elif isinstance(entry, dict):
            # {group: name} loads <group>/<name>.yaml; fragments set their
            # own top-level keys
            [(group, name)] = entry.items()
            merged = _merge(merged, _read(path.parent / group / f"{name}.yaml"))
        else:
            merged = _merge(merged, _read(path.parent / f"{entry}.yaml"))
    merged = _merge(merged, raw)

    for ov in overrides or []:
        key, _, val = ov.partition("=")
        cur = merged
        parts = key.split(".")
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = _parse_value(val)

    return Config(_interpolate(merged, merged))
