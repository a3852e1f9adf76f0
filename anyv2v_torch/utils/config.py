"""Config system preserving the reference's OmegaConf surface (the port's own
copy of ``anyv2v_tpu/utils/config.py``).

The reference drives everything with OmegaConf in two idioms (SURVEY.md §5):

(a) template + JSON group overrides with ``${}`` interpolation —
    ``OmegaConf.merge(template, OmegaConf.create(entry))`` per video
    (``run_group_ddim_inversion.py:112``, ``template.yaml:11-12``);
(b) single YAML + CLI dotlist — ``OmegaConf.from_dotlist(argv)`` merge
    (``consisti2v/run_ddim_inversion.py:147-149``).

omegaconf is not a dependency, so this module implements the
subset the reference configs use: deep merge, ``${a.b.c}`` interpolation
(including inside strings), attribute access, dotlist overrides.
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Mapping, Optional, Sequence


_INTERP = re.compile(r"\$\{([^}]+)\}")


class ConfigNode(dict):
    """dict with attribute access; nested dicts auto-wrap."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @staticmethod
    def wrap(obj: Any) -> Any:
        if isinstance(obj, Mapping):
            return ConfigNode({k: ConfigNode.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [ConfigNode.wrap(v) for v in obj]
        return obj


def load_yaml(path: str) -> ConfigNode:
    import yaml

    with open(path) as f:
        return ConfigNode.wrap(yaml.safe_load(f) or {})


def to_yaml(cfg: Any) -> str:
    """A (possibly ConfigNode-nested) config as YAML, for provenance files."""

    def plain(obj: Any) -> Any:
        if isinstance(obj, Mapping):
            return {k: plain(v) for k, v in obj.items()}
        if isinstance(obj, list):
            return [plain(v) for v in obj]
        return obj

    import yaml

    return yaml.safe_dump(plain(cfg), sort_keys=False)


def load_json(path: str) -> Any:
    with open(path) as f:
        return ConfigNode.wrap(json.load(f))


def merge(base: Any, override: Any) -> Any:
    """OmegaConf.merge semantics: deep merge of mappings; scalars/lists in
    ``override`` replace ``base``."""
    if isinstance(base, Mapping) and isinstance(override, Mapping):
        out = ConfigNode(dict(base))
        for k, v in override.items():
            out[k] = merge(base[k], v) if k in base else ConfigNode.wrap(v)
        return out
    return ConfigNode.wrap(override)


def _lookup(root: Any, dotted: str) -> Any:
    node = root
    for part in dotted.split("."):
        node = node[part]
    return node


def resolve(cfg: Any, _root: Optional[Any] = None, _depth: int = 0) -> Any:
    """Resolve ``${a.b.c}`` interpolations against the config root.

    A lone ``${x}`` keeps the referenced value's type; embedded occurrences
    stringify (OmegaConf behavior)."""
    root = cfg if _root is None else _root
    if _depth > 32:
        raise ValueError("interpolation cycle detected")
    if isinstance(cfg, Mapping):
        return ConfigNode({k: resolve(v, root, _depth) for k, v in cfg.items()})
    if isinstance(cfg, list):
        return [resolve(v, root, _depth) for v in cfg]
    if isinstance(cfg, str):
        m = _INTERP.fullmatch(cfg)
        if m:
            return resolve(_lookup(root, m.group(1)), root, _depth + 1)

        def sub(match: re.Match) -> str:
            val = resolve(_lookup(root, match.group(1)), root, _depth + 1)
            return str(val)

        return _INTERP.sub(sub, cfg)
    return cfg


def from_dotlist(args: Sequence[str]) -> ConfigNode:
    """["a.b=1", "c=[2,3]"] -> nested config with YAML-typed values."""
    import yaml

    out: Dict[str, Any] = {}
    for arg in args:
        if "=" not in arg:
            raise ValueError(f"dotlist entry missing '=': {arg}")
        key, _, raw = arg.partition("=")
        value = yaml.safe_load(raw) if raw != "" else None
        node = out
        parts = key.strip().split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return ConfigNode.wrap(out)


def load_group_configs(template_path: str, group_json_path: str) -> List[ConfigNode]:
    """The reference's batch idiom: one resolved config per active entry
    (``run_group_ddim_inversion.py:105-122``: skip ``active: false``)."""
    template = load_yaml(template_path)
    entries = load_json(group_json_path)
    configs = []
    for entry in entries:
        if not entry.get("active", True):
            continue
        configs.append(resolve(merge(template, entry)))
    return configs

