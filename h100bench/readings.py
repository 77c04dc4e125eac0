#!/usr/bin/env python3
"""The readings that the check's limits are set from, on the card.

    python3 h100bench/readings.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--control-rhs N]

In one process, for one cell at its own size: the hierarchy once; then for
each seed its pool of right-hand sides, each solved once by the window's
entry (a run's sample can only hold these answers: a right-hand side's
solves repeat), with the compared numbers of each answer, its iterations
and seconds; and for each control seed the control (``check.control``: the
reference in the program's place, in the lower precision the cell's limits
file names) over the same pool, or its first ``--control-rhs``.  One JSON line per answer, then a summary
line: per compared number the largest reading of the program (the lower
reading) and the smallest of the control (the upper).  The benchmark's own
runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(1, str(ROOT))

import torch  # noqa: E402

import check  # noqa: E402
import harness  # noqa: E402


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def collect(cell, program_seeds, control_seeds, device,
            control_rhs=None) -> dict:
    """Print the readings of ``cell`` and return the summary."""
    config, traffic, limits = cell.config, cell.traffic, cell.limits
    names = list(limits["compare"])
    entry = harness.load_module(harness.BENCH / "entries"
                                / f"{traffic['entry']}.py")
    hier, cfg = harness.build_system(config, device)
    n = config["levels"][0][0]
    ref64 = check.reference(config, torch.float64, device)
    lower = {k: 0.0 for k in names}
    upper = {k: float("inf") for k in names}
    iters = []
    for seed in program_seeds:
        pool = harness.make_pool(seed, config, traffic, device)
        for j, b in enumerate(pool):
            harness.sync(device)
            t0 = time.perf_counter()
            out = entry.solve(hier, cfg, b, traffic)
            harness.sync(device)
            secs = time.perf_counter() - t0
            got = check.measure(ref64, traffic, names, check.nodes(b, n),
                                [check.nodes(u, n) for u in out["u"]])
            for k, v in got.items():
                lower[k] = max(lower[k], v)
            iters.append(out["iterations"])
            print(json.dumps({"side": "program", "seed": seed, "rhs": j,
                              "iterations": out["iterations"],
                              "converged": out["converged"],
                              "seconds": secs, **got,
                              "computed": out.get("computed")}), flush=True)
            del out
        del pool
    for seed in control_seeds:
        pool = harness.make_pool(seed, config, traffic, device)
        for j, b in enumerate(pool[:control_rhs]):
            got = check.control(config, traffic, limits, b, device)
            for k, v in got.items():
                upper[k] = min(upper[k], v)
            print(json.dumps({"side": "control", "seed": seed, "rhs": j,
                              **got}), flush=True)
        del pool
    summary = {"summary": cell.name, "lower": lower, "upper": upper,
               "iterations": sorted(set(iters))}
    print(json.dumps(summary), flush=True)
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, default=[])
    p.add_argument("--control-seeds", type=seeds, default=[])
    p.add_argument("--control-rhs", type=int, default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings.py: no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    collect(harness.load_cell(ROOT, args.workload), args.seeds,
            args.control_seeds, "cuda", args.control_rhs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
