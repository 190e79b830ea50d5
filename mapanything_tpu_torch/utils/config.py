"""YAML config composition, hydra style, for the port.

Counterpart of ``mapanything_tpu/utils/config.py`` (:1-147), after the
reference's Hydra/OmegaConf tree (``configs/``): ``defaults`` lists compose
group files, dotted overrides set values, ``group=name`` overrides swap a
group, and ``${a.b.c}`` interpolations (also inside longer strings, and the
reference's ``${special_float:...}`` for +/-inf) are resolved. The files are
parsed by ``utils/yaml_subset.py`` (no PyYAML on the card's machine), which
gives what ``yaml.safe_load`` gives for them.
"""

from __future__ import annotations

import copy
import math
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

from mapanything_tpu_torch.utils.yaml_subset import load_file, loads

_INTERP_RE = re.compile(r"^\$\{([^}]+)\}$")
_EMBED_RE = re.compile(r"\$\{([^}]+)\}")
_SPECIAL_FLOAT_RE = re.compile(r"^\$\{special_float:\"?(-?inf)\"?\}$")


def deep_merge(base: Dict, override: Dict) -> Dict:
    """Recursively merge override into base (override wins)."""
    out = copy.deepcopy(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _resolve_path(cfg: Dict, dotted: str) -> Any:
    cur: Any = cfg
    for part in dotted.split("."):
        cur = cur[part]
    return cur


def resolve_interpolations(cfg: Dict, root: Optional[Dict] = None) -> Dict:
    """Resolve ${a.b.c} and ${special_float:"inf"} values."""
    root = root if root is not None else cfg

    def resolve(v):
        if isinstance(v, dict):
            return {k: resolve(x) for k, x in v.items()}
        if isinstance(v, list):
            return [resolve(x) for x in v]
        if isinstance(v, str):
            m = _SPECIAL_FLOAT_RE.match(v)
            if m:
                return -math.inf if m.group(1) == "-inf" else math.inf
            m = _INTERP_RE.match(v)
            if m and not m.group(1).startswith("special_float"):
                try:
                    return resolve(_resolve_path(root, m.group(1)))
                except (KeyError, TypeError):
                    return v
            # Embedded interpolations inside longer strings (the dataset
            # DSL): substitute each ${a.b.c} with the str() of its value
            # (OmegaConf string-interpolation semantics).
            if "${" in v:

                def sub(match):
                    expr = match.group(1)
                    if expr.startswith("special_float"):
                        return "-inf" if "-inf" in expr else "inf"
                    try:
                        val = resolve(_resolve_path(root, expr))
                    except (KeyError, TypeError):
                        return match.group(0)
                    return match.group(0) if isinstance(val, str) and "${" in val else str(val)

                return _EMBED_RE.sub(sub, v)
        return v

    # Iterate to a fixed point for chained interpolations.
    prev = None
    cur = cfg
    for _ in range(10):
        cur = resolve(cur)
        if cur == prev:
            break
        prev = cur
    return cur


def load_config(
    path: Union[str, Path],
    overrides: Optional[List[str]] = None,
    config_dir: Optional[Union[str, Path]] = None,
) -> Dict:
    """Load a YAML config, composing its ``defaults`` list.

    ``defaults`` entries: ``group: name`` loads ``<dir>/<group>/<name>.yaml``
    into key ``group``; plain ``name`` merges ``<dir>/<name>.yaml`` at the
    root (hydra semantics for the subset used by the reference configs).
    Overrides are ``a.b.c=value`` strings (YAML-parsed values, a string that
    reads as a float, such as ``5e-5``, cast to one).
    """
    path = Path(path)
    config_dir = Path(config_dir) if config_dir else path.parent

    raw = load_file(path) or {}

    cfg: Dict = {}
    for entry in raw.pop("defaults", []):
        if isinstance(entry, dict):
            for group, name in entry.items():
                if name is None or group == "_self_":
                    continue
                sub = load_config(
                    config_dir / group / f"{name}.yaml", config_dir=config_dir / group
                )
                cfg = deep_merge(cfg, {group: sub})
        elif isinstance(entry, str) and entry != "_self_":
            sub = load_config(config_dir / f"{entry}.yaml", config_dir=config_dir)
            cfg = deep_merge(cfg, sub)
    cfg = deep_merge(cfg, raw)

    for ov in overrides or []:
        key, _, val = ov.partition("=")
        # Hydra-style GROUP override: "dataset=megatrain_..." swaps the
        # whole group when <config_dir>/<key>/<val>.yaml exists.
        group_file = config_dir / key / f"{val}.yaml"
        if "." not in key and group_file.exists():
            sub = load_config(group_file, config_dir=config_dir / key)
            cfg[key] = sub
            continue
        parsed = loads(val, f"--override {ov}")
        if isinstance(parsed, str):
            # YAML 1.1 misses bare scientific notation like "5e-5".
            try:
                parsed = float(parsed)
            except ValueError:
                pass
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = parsed

    return resolve_interpolations(cfg)
