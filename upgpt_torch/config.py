"""Config system: YAML + dotlist merge + `target:`/`params:` object registry.

Port of `upgpt_tpu.config` (reference ldm/util.py:78-93
`instantiate_from_config`, main.py:572-591 merge). Configs are plain nested
dicts, merged left to right, with `a.b.c=value` dotlist overrides. Objects
are built from `{"target": "pkg.mod.Name", "params": {...}}` nodes.

The configs under `configs/` name the JAX package's builders
(`upgpt_tpu.zoo.build_latent_diffusion`). A target under `upgpt_tpu.`
resolves to the same dotted path under `upgpt_torch.`, so those files build
the port's objects unchanged; a target the port does not have raises
`ImportError` naming it. PyYAML is imported by `load_config` alone: dict
configs need no YAML.
"""

from __future__ import annotations

import ast
import copy
import importlib
from typing import Any, Mapping, Sequence

_JAX_PACKAGE = "upgpt_tpu."
_PORT_PACKAGE = "upgpt_torch."


def load_config(path: str) -> dict:
    """Load a single YAML config file into a nested dict."""
    import yaml

    with open(path, "r") as f:
        return yaml.safe_load(f) or {}


def deep_merge(base: dict, override: Mapping) -> dict:
    """Recursively merge `override` into a copy of `base` (override wins)."""
    out = copy.deepcopy(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, Mapping):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _parse_value(raw: str) -> Any:
    """Parse a dotlist value: python literal if possible, else string."""
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw


def apply_dotlist(config: dict, dotlist: Sequence[str]) -> dict:
    """Apply `key.subkey=value` CLI overrides (reference: main.py:572-576)."""
    out = copy.deepcopy(config)
    for item in dotlist:
        if "=" not in item:
            raise ValueError(f"dotlist entry {item!r} must look like key=value")
        key, raw = item.split("=", 1)
        node = out
        parts = key.strip().split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ValueError(
                    f"cannot descend into non-dict at {p!r} for {key!r}")
        node[parts[-1]] = _parse_value(raw.strip())
    return out


def merge_configs(paths: Sequence[str], dotlist: Sequence[str] = ()) -> dict:
    """Left-to-right YAML merge followed by dotlist overrides."""
    cfg: dict = {}
    for p in paths:
        cfg = deep_merge(cfg, load_config(p))
    return apply_dotlist(cfg, dotlist)


def get_obj_from_str(string: str) -> Any:
    """Import `pkg.mod.Name` (`upgpt_tpu.X` resolves to `upgpt_torch.X`)
    and return the attribute."""
    target = string
    if target.startswith(_JAX_PACKAGE):
        target = _PORT_PACKAGE + target[len(_JAX_PACKAGE):]
    module, name = target.rsplit(".", 1)
    try:
        mod = importlib.import_module(module)
    except ModuleNotFoundError as err:
        raise ImportError(
            f"config target {string!r}: the port has no module {module!r} "
            f"({err})") from err
    if not hasattr(mod, name):
        raise ImportError(
            f"config target {string!r}: the port's {module} has no {name!r}")
    return getattr(mod, name)


def instantiate_from_config(config: Mapping, **extra_kwargs) -> Any:
    """Build the object described by a `{"target", "params"}` node.

    Sentinels `__is_first_stage__` / `__is_unconditional__` are passed through
    untouched so callers can special-case them (as the reference's
    LatentDiffusion does for its cond stage, ddpm.py:745-755).
    """
    if isinstance(config, str):
        return config  # sentinel
    if "target" not in config:
        raise KeyError(
            f"Expected key `target` in config node, got keys {list(config)}")
    params = dict(config.get("params") or {})
    params.update(extra_kwargs)
    return get_obj_from_str(config["target"])(**params)
