"""fairseq-style flags (counterpart of ofasys_tpu/configure/options.py):
the second way to configure a run, beside a config file.

Flag grammar (values YAML-parsed)::

    --ofasys.task=caption,text_infilling        activate task nodes
    --ofasys.task.caption.dataset.batch_size=8  per-task override
    --ofasys.model.arch=base                    model override
    --ofasys.optimization.lr=[0.0001]           trainer override
    --ofasys.checkpoint.save_dir=/tmp/ck        trainer override

``parse_flags`` turns a flag list into the same config dict the launcher
reads, so both ways share one build path (launch.build_from_config)."""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Dict, List, Optional, Tuple


def parse_flags(argv: List[str]) -> Tuple[Dict[str, Any], List[str]]:
    """Returns (config data dict, leftover argv)."""
    import yaml

    data: Dict[str, Any] = {"trainer": {}, "model": {}, "tasks": {}}
    rest: List[str] = []
    i = 0
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("--ofasys."):
            rest.append(tok)
            i += 1
            continue
        key = tok[len("--ofasys."):]
        if "=" in key:
            key, _, raw = key.partition("=")
        else:
            i += 1
            if i >= len(argv):
                raise ValueError(f"flag {tok} expects a value")
            raw = argv[i]
        try:
            val = yaml.safe_load(raw)
        except Exception:
            val = raw  # raw strings (instruction templates) are not YAML
        parts = key.split(".")
        if parts[0] == "task" and len(parts) == 1:
            # activation list: --ofasys.task=caption,gigaword
            for name in str(raw).split(","):
                name = name.strip()
                if name:
                    data["tasks"].setdefault(name, {})["task"] = name
        elif parts[0] == "task":
            name = parts[1]
            node = data["tasks"].setdefault(name, {})
            node.setdefault("task", name)
            _assign(node, parts[2:], val)
        elif parts[0] == "model":
            _assign(data["model"], parts[1:], val)
        else:
            _assign(data["trainer"], parts, val)
        i += 1
    return data, rest


def _assign(node: Dict[str, Any], parts: List[str], val: Any):
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = val


def _add_dataclass_args(parser: argparse.ArgumentParser, obj, prefix: str):
    for f in dataclasses.fields(obj):
        val = getattr(obj, f.name)
        if dataclasses.is_dataclass(val):
            _add_dataclass_args(parser, val, f"{prefix}.{f.name}" if prefix else f.name)
        else:
            try:
                parser.add_argument(
                    f"--ofasys.{prefix}.{f.name}" if prefix else f"--ofasys.{f.name}",
                    default=None, help=f"(default: {val!r})",
                )
            except argparse.ArgumentError:
                pass


def get_training_parser() -> argparse.ArgumentParser:
    """Argparse view of the config tree, for --help; parsing itself goes
    through parse_flags so that task nodes registered at run time work."""
    from ofasys_torch.configure.configs import TrainerConfig

    parser = argparse.ArgumentParser(
        "ofasys_torch.cli.train",
        description="Train via fairseq-style flags (--ofasys.*) or a config file.",
    )
    parser.add_argument("config", nargs="?", help="optional config path (.yaml or .json)")
    parser.add_argument("--ofasys.task", dest="_task", default=None,
                        help="comma list of task nodes to activate")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    _add_dataclass_args(parser, TrainerConfig(), "")
    return parser


def parse_args_and_build(argv: List[str], device: Optional[str] = None):
    """Flags -> (trainer, model, tasks) through the launcher's build path;
    a positional config path merges under the flags (the flags win)."""
    from ofasys_torch.launch import _deep_merge, build_from_config, load_yaml_config

    data, rest = parse_flags(argv)
    paths = [a for a in rest if not a.startswith("-")]
    if paths:
        base = load_yaml_config(paths[0])
        data = _deep_merge(base, {k: v for k, v in data.items() if v})
    return build_from_config(data, device)
