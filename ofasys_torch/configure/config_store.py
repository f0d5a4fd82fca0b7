"""Dataclass-based config registry (counterpart of
ofasys_tpu/configure/config_store.py).

Components self-register a config dataclass under a dotted group (e.g.
``ofasys.task``, ``ofasys.preprocess``) with :func:`register_config`; the
store activates nodes, applies dotted-path overrides, serializes the active
nodes into checkpoints and builds the registered target class from its
config. The groups and names are ofasys_tpu's, so a store's
``state_dict`` reads the same on both sides.
"""

from __future__ import annotations

import copy
import dataclasses
import importlib
import pkgutil
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Dict, List, Optional, Type


@dataclass
class ConfigNode:
    group: str
    name: str
    config_cls: Type
    target_cls: Optional[Type] = None
    active: bool = False
    # The live config instance (created lazily).
    _config: Any = None

    @property
    def config(self):
        if self._config is None:
            self._config = self.config_cls()
        return self._config

    def build(self, *args, **kwargs):
        if self.target_cls is None:
            raise ValueError(f"config node {self.group}.{self.name} has no target class")
        return self.target_cls(self.config, *args, **kwargs)


class ConfigStore:
    """Process-wide registry singleton.

    Usage::

        @register_config("ofasys.task", "caption", CaptionTaskConfig)
        class CaptionTask(Task): ...

        node = ConfigStore().get("ofasys.task", "caption")
        task = node.build()
    """

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
            cls._instance._nodes = {}
        return cls._instance

    # ------------------------------------------------------------------ CRUD
    def store(self, group: str, name: str, config_cls: Type, target_cls: Optional[Type] = None):
        key = (group, name)
        self._nodes[key] = ConfigNode(group=group, name=name, config_cls=config_cls, target_cls=target_cls)
        return self._nodes[key]

    def get(self, group: str, name: str) -> ConfigNode:
        try:
            return self._nodes[(group, name)]
        except KeyError:
            avail = sorted(n for g, n in self._nodes if g == group)
            raise KeyError(f"no config registered as {group}.{name}; available in {group}: {avail}")

    def contains(self, group: str, name: str) -> bool:
        return (group, name) in self._nodes

    def get_dict(self, group: str) -> Dict[str, ConfigNode]:
        return {n: node for (g, n), node in self._nodes.items() if g == group}

    def names(self, group: str) -> List[str]:
        return sorted(n for (g, n) in self._nodes if g == group)

    def groups(self) -> List[str]:
        return sorted({g for (g, _) in self._nodes})

    # ------------------------------------------------------------ activation
    def set_active(self, group: str, names, active: bool = True):
        if isinstance(names, str):
            names = [s for s in names.split(",") if s]
        for name in names:
            self.get(group, name).active = active

    def active_nodes(self, group: str) -> List[ConfigNode]:
        return [node for (g, _), node in sorted(self._nodes.items()) if g == group and node.active]

    def build(self, group: str, *args, **kwargs):
        """Build every active node of a group -> {name: instance}."""
        return {node.name: node.build(*args, **kwargs) for node in self.active_nodes(group)}

    # ------------------------------------------------------------- overrides
    def import_args(self, overrides: Dict[str, Any]):
        """Apply dotted-path overrides like
        ``{"ofasys.task.caption.dataset.batch_size": 8}``.

        The longest registered ``group.name`` prefix wins; the remainder is a
        field path into the config dataclass tree.
        """
        for dotted, value in overrides.items():
            self.override(dotted, value)

    def override(self, dotted: str, value: Any):
        parts = dotted.split(".")
        # Longest matching (group, name) prefix.
        node = None
        rest: List[str] = []
        for i in range(len(parts) - 1, 0, -1):
            group, name = ".".join(parts[: i - 1]), parts[i - 1]
            if (group, name) in self._nodes:
                node = self._nodes[(group, name)]
                rest = parts[i:]
                break
        if node is None:
            raise KeyError(f"no registered config matches override path {dotted!r}")
        if not rest:
            raise ValueError(f"override path {dotted!r} does not name a field")
        _set_dotted(node.config, rest, value)

    # --------------------------------------------------------- serialization
    def state_dict(self, groups: Optional[List[str]] = None) -> Dict[str, Any]:
        """Serialize active nodes' configs (for embedding into checkpoints)."""
        out: Dict[str, Any] = {}
        for (g, n), node in sorted(self._nodes.items()):
            if groups is not None and g not in groups:
                continue
            if not node.active:
                continue
            out.setdefault(g, {})[n] = to_dict(node.config)
        return out

    def load_state_dict(self, state: Dict[str, Any], activate: bool = True):
        for g, by_name in state.items():
            for n, cfg_dict in by_name.items():
                if (g, n) not in self._nodes:
                    continue
                node = self._nodes[(g, n)]
                node._config = from_dict(node.config_cls, cfg_dict)
                if activate:
                    node.active = True

    def reset(self):
        """Reset live config instances + activation (for tests)."""
        for node in self._nodes.values():
            node._config = None
            node.active = False


def register_config(group: str, name: str, config_cls: Type):
    """Class decorator: register ``config_cls`` under ``group.name`` with the
    decorated class as build target."""

    def wrapper(target_cls):
        ConfigStore().store(group, name, config_cls, target_cls)
        target_cls.registry_group = group
        target_cls.registry_name = name
        return target_cls

    return wrapper


# ------------------------------------------------------------------ helpers

_MISSING = object()


def _field_types(cls: Type) -> Dict[str, Any]:
    """Resolved field annotations (handles `from __future__ import annotations`
    stringized types); cached per class."""
    cache = _field_types.__dict__.setdefault("_cache", {})
    if cls not in cache:
        import typing

        try:
            cache[cls] = typing.get_type_hints(cls)
        except Exception:
            cache[cls] = {f.name: f.type for f in fields(cls)}
    return cache[cls]


def _coerce(value: Any, typ: Any) -> Any:
    """Best-effort coercion of a string/primitive override to the field type."""
    if typ in (Any, None) or value is None:
        return value
    origin = getattr(typ, "__origin__", None)
    if origin is not None:
        args = getattr(typ, "__args__", ())
        if origin is type(Optional[int]) or str(origin) == "typing.Union" or origin is __import__("typing").Union:
            for a in args:
                if a is type(None):
                    continue
                try:
                    return _coerce(value, a)
                except (TypeError, ValueError):
                    continue
            return value
        if origin in (list, tuple):
            if isinstance(value, str):
                value = [v for v in value.split(",") if v]
            inner = args[0] if args else Any
            seq = [_coerce(v, inner) for v in value]
            return tuple(seq) if origin is tuple else seq
        return value
    if is_dataclass(typ) and isinstance(value, dict):
        return from_dict(typ, value)
    if typ is bool and isinstance(value, str):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(typ, type):
        if isinstance(value, typ):
            return value
        try:
            return typ(value)
        except (TypeError, ValueError):
            return value
    return value


def _set_dotted(cfg: Any, path: List[str], value: Any):
    obj = cfg
    for p in path[:-1]:
        if not hasattr(obj, p):
            raise AttributeError(f"config {type(obj).__name__} has no field {p!r} (path {'.'.join(path)})")
        obj = getattr(obj, p)
    leaf = path[-1]
    if not hasattr(obj, leaf):
        raise AttributeError(f"config {type(obj).__name__} has no field {leaf!r} (path {'.'.join(path)})")
    ftype = _field_types(type(obj)).get(leaf) if is_dataclass(obj) else None
    setattr(obj, leaf, _coerce(value, ftype))


def to_dict(cfg: Any) -> Any:
    """Dataclass tree -> plain dict (json/msgpack-safe)."""
    if is_dataclass(cfg) and not isinstance(cfg, type):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    if isinstance(cfg, dict):
        return {k: to_dict(v) for k, v in cfg.items()}
    import enum

    if isinstance(cfg, enum.Enum):
        return cfg.name
    return cfg


def from_dict(cls: Type, data: Dict[str, Any]):
    """Plain dict -> dataclass instance (recursive, tolerant to extra keys)."""
    if not is_dataclass(cls):
        return data
    types = _field_types(cls)
    kwargs = {}
    for f in fields(cls):
        if f.name not in data:
            continue
        kwargs[f.name] = _coerce(data[f.name], types.get(f.name, f.type))
    return cls(**kwargs)


def update_config(cfg: Any, **kwargs):
    """Flat kwargs update with dotted-key support."""
    for k, v in kwargs.items():
        _set_dotted(cfg, k.split("."), v)
    return cfg


def auto_import(package_name: str):
    """Import every sibling module of a package so @register_config side
    effects fire."""
    pkg = importlib.import_module(package_name)
    for mod in pkgutil.iter_modules(pkg.__path__):
        if mod.name.startswith("_"):
            continue
        importlib.import_module(f"{package_name}.{mod.name}")
