"""The controls of the comparison that decides ``correct``: the port's own
lower-precision paths (int8 serving through kernel B7; int8 quantized
training) and the faults a cell can have, each planted in the program
underneath a run. The benchmark's own runs never use them.

    python3 portbench/controls.py --workload <name> --control <control> --seeds 1,2,3 --seconds 5

runs the cell once for each seed in one process with the control applied
and prints each run's compared numbers; ``--control none`` gives sound
runs. It exits non-zero without a card. Section "How correct is decided"
of PERF.md holds the readings.
"""

import dataclasses
import json
import os
import sys
import time

T_START = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402


def int8_serving(hub):
    """The hub switched to int8 serving (w8a8, kernel B7)."""
    hub.quantize()


def token_altered(hub):
    """At the second decode step a token's logit is raised far above the
    rest, so that token is produced."""
    net = hub.model.net
    step = net.decode_step

    def altered(tokens, i, *a, **k):
        out, extra, cache = step(tokens, i, *a, **k)
        if i == 1:
            out = out.clone()
            out[..., 5] += 30.0
        return out, extra, cache

    net.decode_step = altered


def int8_training(model, crit, opt):
    """The stacks' projections through int8 quantized training (B7)."""
    model.cfg.quant_training = "fwd"
    return crit


def state_unchanged(model, crit, opt):
    """The optimizer returns its state and the parameters unchanged."""
    opt.step = lambda params, grads, state, g_norm=None: state
    return crit


def half_batch(model, crit, opt):
    """The loss over the first half of each batch's rows, the mean taken
    over them."""
    def wrapped(m, sample, generator=None, train=True):
        B = sample["target"].shape[0]

        def cut(v):
            return v[:B // 2] if torch.is_tensor(v) and v.dim() > 0 and v.shape[0] == B else v

        slots = [dataclasses.replace(s, value={k: cut(v) for k, v in s.value.items()})
                 for s in sample["net_input"]["slots"]]
        return crit(m, {**sample, "target": cut(sample["target"]),
                        "net_input": {**sample["net_input"], "slots": slots}}, generator, train)

    return wrapped


CONTROLS = {"none": None, "int8_serving": int8_serving, "token_altered": token_altered,
            "int8_training": int8_training, "state_unchanged": state_unchanged, "half_batch": half_batch}


def main(argv=None) -> int:
    import argparse

    from portbench import harness
    from portbench.run import log, run_cell

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control", choices=sorted(CONTROLS), required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    harness.cache_env()
    bench = harness.load_benchmark()
    cell = harness.cell_of(bench, args.workload)
    if not torch.cuda.is_available():
        log("needs a CUDA device: the readings set the limits of the card's runs")
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        result, compared = run_cell(bench, cell, seed, args.seconds, False, "cuda", time.perf_counter(),
                                    hook=CONTROLS[args.control])
        print(json.dumps({"workload": args.workload, "control": args.control, "seed": seed,
                          "correct": result["correct"],
                          "compared": {k: v["value"] for k, v in compared.items()}}), flush=True)
        log(f"{args.control} seed {seed}: {compared}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
