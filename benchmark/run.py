"""Run one cell once:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. Prints one JSON object as the last line of standard output (README.md
has the contract) and the numbers compared, each beside its limit, as the
last lines of standard error. Exits non-zero, printing no result, without a
CUDA card, or if JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()  # the process's start, as near as Python gets

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

# Whole top-level module names that must not be loaded: the port's name
# begins with the JAX package's, so names are compared whole.
BANNED = frozenset({"jax", "jaxlib", "flax", "mpc_iris_tpu", "bench"})


def banned_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & BANNED)


def check_lines(checks: dict) -> list[str]:
    return [f"check {k}: {v['value']!r} (limit {v['limit']!r})" for k, v in checks.items()]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness
    from benchmark import manifest as mf
    from benchmark.peaks import card_line

    manifest = mf.load_manifest()
    cell = mf.cell(manifest, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    run = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                           T0, manifest=manifest)
    found = banned_modules()
    if found:
        print(f"loaded in the measuring process: {', '.join(found)}", file=sys.stderr)
        return 3

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(cell["chips"]), "memory_peak_bytes": int(run.memory_peak_bytes)}
    result = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
              "metrics": run.metrics, "device": device}
    if run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = run.checks
    print(f"card: {card_line()}; setup_s {run.setup_s!r}; peak device memory "
          f"{run.memory_peak_bytes} bytes (max_memory_allocated, the fullest card)",
          file=sys.stderr)
    for note in run.notes:
        print(note, file=sys.stderr)
    for err in run.errors:
        print(f"failed request: {err}", file=sys.stderr)
    print("\n".join(check_lines(run.checks)), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
