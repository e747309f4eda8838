"""The benchmark of image_segmentation_tpu_torch on one NVIDIA card.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

runs one cell of BENCHMARK.json: set-up (weights and data from the seed,
the cell's shapes warmed up), a measured window of `--seconds`, then the
check against the plain reference. The last line of standard output is
the result as one JSON object; the numbers the check compared, each with
its limit, are the last lines of standard error and the result's last key.
With `--trace 1` the metrics are the cell's per-layer ones, read from
spans, counters and a torch.profiler slice of the window.

    python3 perfbench/run.py --workload <serve cell> --seed <n> --sweep 40,60,80 --seconds 8

runs the cell's open loop at each rate in turn instead and prints the
completed rate and the backlog of each: the sweep that finds a serve
cell's knee.

Exits non-zero with no result when there is no CUDA card, fewer than the
cell asks for, or when JAX or the JAX package is loaded once the window
has closed. Build and kernel caches stay inside the checkout.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "build", "perfbench_cache")


def _environment(workload: str, bench_path: str = os.path.join(ROOT, "BENCHMARK.json")) -> None:
    """Fixed cache directories inside the checkout; no JAX through a library;
    the host's OpenMP threads a process as the cell's traffic states them
    (`omp_threads`), set before torch loads the OpenMP runtime."""
    try:
        with open(bench_path) as f:
            entry = next(w for w in json.load(f)["workloads"] if w["name"] == workload)
        with open(os.path.join(ROOT, "perfbench", "traffic", entry["traffic"] + ".json")) as f:
            threads = json.load(f).get("omp_threads")
    except (OSError, ValueError, KeyError, StopIteration):
        threads = None  # the cell's loading reports what is missing
    if threads:
        os.environ["OMP_NUM_THREADS"] = str(int(threads))
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
        sys.path[0] = ROOT
    elif ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--sweep", default="", help="comma-separated rates: the knee sweep")
    args = p.parse_args(argv)
    _environment(args.workload)

    import torch

    from perfbench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    print(f"perfbench: card {_card()}", file=sys.stderr)
    if args.sweep:
        rates = [float(r) for r in args.sweep.split(",")]
        cell.kind.sweep(cell, args.seed, rates, args.seconds, "cuda")
        return 0

    trace = bool(args.trace)
    outcome = cell.kind.run(cell, args.seed, args.seconds, trace, "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": outcome.memory_peak_bytes}
    if trace:
        device["busy_s"] = outcome.reading.busy_s()
        device["window_s"] = outcome.reading.slice.window_s
    line = harness.result_line(cell, outcome, trace, device)
    sys.stdout.flush()
    if outcome.detail:
        print(f"perfbench: {json.dumps(outcome.detail)}", file=sys.stderr)
    for c in outcome.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
