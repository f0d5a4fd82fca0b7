"""The benchmark of the port (``ofasys_torch``) on one NVIDIA H100.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

runs the cell ``<name>`` of ``BENCHMARK.json`` from the root of a checkout:
set-up (imports, CUDA, the kernels' build, weights and inputs from the seed,
warm-up), a measured window of ``--seconds``, then the comparison with the
float32 reference that decides ``correct``. The last line of standard
output is one JSON object: the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics read from a profiled sub-window. It
exits non-zero, printing no result, without a card, or when JAX or the JAX
package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def log(msg: str) -> None:
    print(f"[portbench {time.perf_counter() - T_START:8.2f} s] {msg}", file=sys.stderr, flush=True)


def run_cell(bench, cell, seed: int, seconds: float, trace: bool, device, t_start: float, root: str = ROOT,
             hook=None):
    """One run of ``cell``: (result without its compared numbers, compared)."""
    from portbench import harness

    phases = harness.Phases(t_start)
    cfg = harness.config_of(bench, cell, root)
    traffic = harness.traffic_of(cell, root)
    import torch

    phases.mark("imports")
    if torch.device(device).type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=device)
        phases.mark("CUDA init")
        from ofasys_torch.ops import cuda_build

        cuda_build.build(sorted(p.stem for p in cuda_build.CSRC.glob("*.cu")))
        phases.mark("extension build and load")
    runner = harness.kind_of(traffic["kind"], root)
    out = runner.run(cfg, traffic, seed, seconds, trace, device, phases, log, hook)
    log(phases.line())
    result = {"correct": bool(out["correct"]), "attempted": int(out["attempted"]),
              "failed": int(out["failed"])}
    dev = harness.device_record(device, out["peak"], cell["chips"])
    wanted = harness.cell_metrics(bench, cell, trace)
    metrics = {}
    if trace:
        metrics = harness.read_per_layer(wanted, out["ctx"], root)
        tw = out["ctx"].get("trace")
        if tw is not None:
            dev["busy_s"] = tw["busy_s"]
            dev["window_s"] = tw["wall_s"]
            result["breakdown"] = {"device_ops": tw["device_ops"], "idle_gaps": tw["idle_gaps"]}
    else:
        for m in wanted:
            v = out["e2e"].get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = dev
    limit = harness.power_limit() if torch.device(device).type == "cuda" else None
    if limit:
        log(f"card: {limit}")
    return result, out["compared"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    harness.cache_env(ROOT)
    bench = harness.load_benchmark(ROOT)
    cell = harness.cell_of(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"needs {cell['chips']} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    result, compared = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    bad = harness.forbidden_modules()
    if bad:
        log(f"modules that no run may load were loaded: {bad}")
        return 4
    harness.emit(result, compared, log)
    return 0


if __name__ == "__main__":
    sys.exit(main())
