"""Config-file launcher (counterpart of ofasys_tpu/launch.py).

``python -m ofasys_torch.launch cfg.yaml|cfg.json [--set a.b.c=v ...] [--device cpu]``

The config is one dict, merged from its ``_include`` parents (deep merge,
the child wins) with ``${var}`` substitution from its ``env`` block and the
environment::

    _include: base.yaml          # optional parent
    env: {name: value}           # ${name} substitutions
    model: {arch: base, ...}     # GeneralistModelConfig fields
    trainer: {...}               # TrainerConfig fields
    tasks:
      caption:
        task: caption            # registry name (default: "default")
        instruction: {template: '[IMAGE:img] ... -> [TEXT:cap]'}
        dataset: {train_data: path.tsv, batch_size: 8}

Files and ``--set`` values are read with ``yaml.safe_load``, as ofasys_tpu
reads them (YAML 1.1: ``1e-4`` is a string, ``1.0e-4`` a float). A ``.json``
config is YAML too. The port trains on one device (``--device``, cuda unless
cpu is asked for): nothing is spawned.
"""

from __future__ import annotations

import os
import re
import sys
from typing import Any, Dict, List, Optional, Tuple

_VAR_RE = re.compile(r"\$\{([A-Za-z_][A-Za-z0-9_]*)\}")


def _deep_merge(base: Dict, override: Dict) -> Dict:
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _substitute(obj: Any, env: Dict[str, str]) -> Any:
    if isinstance(obj, str):
        return _VAR_RE.sub(lambda m: str(env.get(m.group(1), os.environ.get(m.group(1), m.group(0)))), obj)
    if isinstance(obj, dict):
        return {k: _substitute(v, env) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_substitute(v, env) for v in obj]
    return obj


def load_yaml_config(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    include = data.pop("_include", None)
    if include:
        parent = load_yaml_config(os.path.join(os.path.dirname(path), include))
        data = _deep_merge(parent, data)
    env = data.pop("env", {}) or {}
    return _substitute(data, env)


def apply_overrides(data: Dict[str, Any], sets: List[str]) -> Dict[str, Any]:
    import yaml

    for item in sets:
        key, _, val = item.partition("=")
        node = data
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = yaml.safe_load(val)
    return data


def build_from_config(data: Dict[str, Any], device: Optional[str] = None):
    """Config dict -> (trainer, model, tasks), the trainer on ``device``
    (cuda when None)."""
    import copy

    import ofasys_torch.task  # noqa: F401  (registers the task zoo)
    from ofasys_torch.configure import ConfigStore, TrainerConfig, from_dict
    from ofasys_torch.engine.trainer import Trainer
    from ofasys_torch.model.ofa import GeneralistModel

    trainer_cfg = from_dict(TrainerConfig, data.get("trainer", {}))
    if trainer_cfg.common.user_dir:
        import_user_dir(trainer_cfg.common.user_dir)
    model_kwargs = dict(data.get("model", {}))
    arch = model_kwargs.pop("arch", None)
    model = GeneralistModel(arch=arch)
    if model_kwargs:
        model.cfg.update(**_flatten(model_kwargs))

    tasks = []
    for name, tcfg in (data.get("tasks", {}) or {}).items():
        registry_name = tcfg.pop("task", "default") if isinstance(tcfg, dict) else "default"
        node = ConfigStore().get("ofasys.task", registry_name)
        # overrides go into the config before construction: the task's
        # __init__ derives its template and metrics from config fields
        cfg = copy.deepcopy(node.config)
        crit_args = None
        if isinstance(tcfg, dict):
            if isinstance(tcfg.get("criterion"), dict):
                # `criterion: {name: ..., label_smoothing: 0.2, ...}`: the
                # registry name apart from the field overrides, which win
                # over an explicit criterion_args mapping
                c = dict(tcfg["criterion"])
                tcfg["criterion"] = c.pop("name", cfg.criterion)
                tcfg["criterion_args"] = {**(tcfg.get("criterion_args") or {}), **c}
            # the args stay one dict value (a dotted update would descend into it)
            crit_args = tcfg.pop("criterion_args", None)
        if tcfg:
            cfg.update(**_flatten(tcfg))
        if crit_args:
            cfg.criterion_args = dict(crit_args)
        tasks.append(node.target_cls(cfg, name=name))

    return Trainer(trainer_cfg, device=device or "cuda"), model, tasks


def import_user_dir(path: str):
    """Import every module in ``path`` so that its ``register_config``
    side effects run before the tasks are built (``common.user_dir``)."""
    import importlib.util

    path = os.path.abspath(os.path.expanduser(path))
    if not os.path.isdir(path):
        raise FileNotFoundError(f"user_dir {path!r} is not a directory")
    for fname in sorted(os.listdir(path)):
        if not fname.endswith(".py") or fname.startswith("_"):
            continue
        mod_name = f"ofasys_user_{fname[:-3]}"
        spec = importlib.util.spec_from_file_location(mod_name, os.path.join(path, fname))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)


def _flatten(d: Dict, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in d.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def parse_launch_args(argv: List[str], options: Tuple[str, ...] = ()):
    """(config path, --set items, {option: value}) of a command line: the
    ``--set`` items in order, and the values of ``--device`` and of the
    ``--<option>`` flags named in ``options``, under their names."""
    path, sets, opts = argv[0], [], {}
    names = ("device",) + tuple(options)
    i = 1
    while i < len(argv):
        if argv[i] == "--set":
            sets.append(argv[i + 1])
            i += 2
        elif argv[i][2:] in names and argv[i].startswith("--"):
            opts[argv[i][2:]] = argv[i + 1]
            i += 2
        else:
            i += 1
    return path, sets, opts


def main(argv: Optional[List[str]] = None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    path, sets, opts = parse_launch_args(argv)
    data = apply_overrides(load_yaml_config(path), sets)
    # several ranks: the process group from the environment (torchrun's or
    # OFASYS_*), before the trainer builds its mesh
    from ofasys_torch.parallel.distributed import distributed_init

    distributed_init()
    trainer, model, tasks = build_from_config(data, opts.get("device"))
    trainer.fit(model, tasks)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
