#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell is an entry of ``workloads`` in
``BENCHMARK.json``.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``checks``: each compared number
with its limit); the last lines of standard error are the same checks.
With ``--trace 0`` the metrics are the cell's end-to-end ones, with
``--trace 1`` its per-layer ones, read from a torch.profiler trace of the
window.  Exits non-zero, printing no result, without a CUDA card or with
fewer than the cell asks for, or when JAX or the JAX package was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# The program under test is the checkout's own package.
sys.path.insert(1, str(ROOT))

import torch  # noqa: E402

import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    if args.workload not in chips:
        print(f"run.py: no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("run.py: no CUDA device; the benchmark runs on the card only",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < chips[args.workload]:
        print(f"run.py: the cell needs {chips[args.workload]} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    result, checks = harness.run_cell(ROOT, args.workload, args.seed,
                                      args.seconds, bool(args.trace),
                                      T_PROCESS)
    found = harness.forbidden_modules()
    if found:
        print(f"run.py: the run loaded {found}: the benchmark may load "
              f"neither JAX nor the JAX package", file=sys.stderr)
        return 4
    print(json.dumps(result))
    sys.stdout.flush()
    for line in checks:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
