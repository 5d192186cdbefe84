"""The control of a cell's check, on the card at the cell's own size: the
plain reference in a lower precision than the configuration states answers
in the program's place, and the cell's own check judges it. Every seed must
come out not correct. The benchmark's runs never run this.

    python3 -m benchmark.control --workload <name> --seeds 1,2,3

Prints a JSON line a seed with the numbers compared.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def control_run(workload: str, seed: int, device, **kw):
    """One seed: the control answers the traffic's ``control_requests``
    requests, as many answers as a run checks."""
    from benchmark import harness
    from benchmark import manifest as mf

    manifest = kw.pop("manifest", None) or mf.load_manifest()
    cell = mf.cell(manifest, workload)
    traffic = {**mf.traffic(cell["traffic"]), **kw.get("overrides", {}).get("traffic", {})}
    return harness.run_cell(workload, seed, 0.0, False, device, time.perf_counter(),
                            control=True, max_requests=int(traffic["control_requests"]),
                            manifest=manifest, **kw)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    failed_all = True
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        run = control_run(args.workload, seed, "cuda")
        failed_all &= not run.correct
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": run.correct,
                          "attempted": run.attempted, "checks": run.checks,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
