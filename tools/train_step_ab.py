"""Time the port's base training update in two checkouts of this repo on
one CUDA card, each run in a process of its own, in the order A B B A.

    python tools/train_step_ab.py DIR_A DIR_B [--updates 10]

Each run imports the checkout's chip_smoke.py and builds its kernels
(``phase_build``), then builds the base model (``build_train_model``, bf16,
dropout 0.1) and chip_smoke's two-task train mix (``make_train_batches``,
``make_criteria``) and times ``--updates`` summed multi-task updates
(``make_multitask_train_step``, Adam) after one warm-up update, each by
the host clock ending in a synchronize. It prints one JSON line a run
and, last, one JSON line with each checkout's update times and their
median over its two runs, beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

CHILD = r"""
import json, statistics, sys, time
sys.path.insert(0, {root!r})
import torch
import chip_smoke as cs
from ofasys_torch.configure.configs import OptimizationConfig
from ofasys_torch.engine.optim import build_optimizer
from ofasys_torch.engine.train_step import TrainState, make_multitask_train_step
from ofasys_torch.utils.pytree import sample_to_device

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cs.phase_build()
hub = cs.build_base_hub()
d, gp = hub.global_dict, hub.general_preprocess
del hub
model = cs.build_train_model(d, "cuda")
batches = cs.make_train_batches(gp)
dev = {{n: sample_to_device(b, "cuda") for n, b in batches.items()}}
crit = cs.make_criteria(batches, d.pad())
opt = build_optimizer(OptimizationConfig(lr=(cs.TRAIN_LR,)))
state = TrainState.create(model.net, opt)
step = make_multitask_train_step(model, crit, opt)
state, _ = step(state, dev, cs.SEED)
torch.cuda.synchronize()
ms = []
for i in range({updates}):
    t0 = time.perf_counter()
    state, out = step(state, dev, cs.SEED + 1 + i)
    torch.cuda.synchronize()
    ms.append((time.perf_counter() - t0) * 1e3)
print(json.dumps({{"root": {root!r}, "update_ms": ms, "median_ms": statistics.median(ms)}}))
"""


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _run(root: str, updates: int) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD.format(root=root, updates=updates)], cwd=root,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"train_step_ab: the run in {root} failed ({proc.returncode})")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--updates", type=int, default=10)
    args = ap.parse_args(argv)
    roots = {"a": os.path.abspath(args.a), "b": os.path.abspath(args.b)}
    card = _card()
    runs = {"a": [], "b": []}
    for which in ("a", "b", "b", "a"):
        res = _run(roots[which], args.updates)
        runs[which].append(res["update_ms"])
        print(json.dumps({"checkout": which, **res, "card": card}), flush=True)
    print(json.dumps({"card": card, "updates": args.updates, **{
        which: {"root": roots[which], "median_ms": [statistics.median(r) for r in runs[which]],
                "median_of_both_ms": statistics.median(runs[which][0] + runs[which][1])}
        for which in ("a", "b")}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
