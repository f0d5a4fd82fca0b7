"""Evaluation CLI (counterpart of ofasys_tpu/cli/evaluate.py):

    python -m ofasys_torch.cli.evaluate cfg.yaml|cfg.json --ckpt <path> [--split test] \\
        [--set a.b=v] [--device cpu]

Builds the config's tasks and model as training builds them
(``Trainer.init_model``), on the device (cuda unless cpu is asked for),
loads the checkpoint's parameters, runs each task's ``evaluate`` over the
split and prints one JSON dict of each task's metrics.
"""

import json
import sys

from ofasys_torch.launch import apply_overrides, build_from_config, load_yaml_config, parse_launch_args


def evaluate(argv):
    """The metrics of each task of the config, by task name."""
    from ofasys_torch.utils import checkpoint_utils
    from ofasys_torch.utils.jax_params import load_jax_params

    path, sets, opts = parse_launch_args(argv, options=("ckpt", "split"))
    data = apply_overrides(load_yaml_config(path), sets)
    trainer, model, tasks = build_from_config(data, opts.get("device"))
    raw, _ = checkpoint_utils.load_checkpoint(opts.get("ckpt"))
    params = raw["params"] if isinstance(raw, dict) and "params" in raw else raw
    trainer.init_model(model, tasks, params=params)
    load_jax_params(model.net, params)
    split = opts.get("split", "test")
    return {task.name: task.evaluate(model, None, split=split) for task in tasks}


def main(argv):
    if not argv:
        print(__doc__)
        return 2
    print(json.dumps(evaluate(argv)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
