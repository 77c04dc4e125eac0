"""Run one cell of the benchmark once: set-up, the measured window, the check.

Everything that belongs to one configuration, traffic mix, entry or metric
sits in a file of its own, found by the names in ``BENCHMARK.json``:

* ``configs/<config>.json``: the deployment (sizes, schedule, the program's
  problem class and padding, the system that builds it, the reference that
  checks it);
* ``systems/<system>.py``: ``build(config, device)``, the program's
  hierarchy and schedule, and ``rhs(f, n)``, the problem's rule from the
  forcing's node values to the right-hand side;
* ``traffic/<traffic>.json``: the entry the window drives, its arguments,
  the pool of right-hand sides and their forcing;
* ``entries/<entry>.py``: ``solve(hier, cfg, b, traffic)``, one request;
* ``metrics/<metric>.py``: ``read(run)``, one metric, or None where the run
  has nothing for it to read;
* ``references/<reference>.py``: the plain reference the check runs;
* ``limits/<cell>.json``: each number the check compares, with its limit
  and the readings it was set from.

The caller is one closed loop: each request is sent when the one before has
returned and the card has finished it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import List, Optional

import torch

import check
import devtrace
import forcing

BENCH = Path(__file__).resolve().parent
# Top-level modules that no run may load: the reference package and JAX.
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_multigrid")
# Solves of the window the check compares, drawn from the seed.
SAMPLE = 8


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """Import a file of the benchmark by its path (names may hold dots)."""
    name = "h100bench_" + "_".join(path.relative_to(BENCH).with_suffix("")
                                   .parts).replace(".", "_").replace("-", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with the files it names."""

    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, workload: str) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                         f"(there are {sorted(cells)})")
    w = cells[workload]
    return Cell(
        name=workload,
        config=load_json(BENCH / "configs" / f"{w['config']}.json"),
        traffic=load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(BENCH / "limits" / f"{workload}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, workload)])


# ---------------------------------------------------------------------------
# The system under test
# ---------------------------------------------------------------------------

def system(config: dict):
    """The configuration's ``systems/<system>.py``."""
    return load_module(BENCH / "systems" / f"{config['system']}.py")


def build_system(config: dict, device):
    """The program's hierarchy and schedule, built by the configuration's
    system; refused where its levels differ from those the configuration
    states."""
    hier, cfg = system(config).build(config, device)
    got = [[op.n, list(getattr(op, "grid_shape", (op.S, op.S)))]
           for op in hier.levels]
    if got != config["levels"]:
        raise RuntimeError(f"the program built levels {got}, the "
                           f"configuration states {config['levels']}")
    return hier, cfg


def make_pool(seed: int, config: dict, traffic: dict, device):
    """The cell's right-hand sides from the seed, by the system's rule."""
    n, shape = config["levels"][0]
    return forcing.pool(seed, traffic, n, shape,
                        getattr(torch, config["multigrid"]["dtype"]), device,
                        system(config).rhs)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# The sample of solves the check compares
# ---------------------------------------------------------------------------

class Sample:
    """A uniform sample of ``k`` of the window's solves, drawn from the seed
    as the solves complete (reservoir sampling); each chosen solve's output
    is copied into buffers made in set-up, so the window allocates
    nothing."""

    def __init__(self, k: int, seed: int, like):
        self.k = k
        self.rng = forcing.rng(seed, 1)
        self.buffers = [[torch.empty_like(t) for t in like] for _ in range(k)]
        self.which = [None] * k

    def offer(self, i: int, j: int, outputs) -> None:
        slot = i if i < self.k else int(self.rng.integers(0, i + 1))
        if slot < self.k:
            for buf, t in zip(self.buffers[slot], outputs):
                buf.copy_(t)
            self.which[slot] = (i, j)

    def items(self):
        """(solve index, pool index, outputs) of each solve in the sample."""
        return [(w[0], w[1], b) for w, b in zip(self.which, self.buffers)
                if w is not None]


# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Run:
    """What the metric readers take from one run."""

    setup_s: float
    window_s: float
    solve_s: List[float]
    solves: List[dict]
    peak_bytes: int
    held_bytes: int
    trace: Optional[devtrace.Trace]
    config: dict


def window(entry, hier, cfg, pool, traffic, seconds, device, sample,
           traced: bool):
    """The closed loop: requests back to back over the pool, each timed from
    the call until it returns and the card is done; the window ends at the
    first completion at or after ``seconds``."""
    solve_s, solves = [], []
    span = (torch.profiler.record_function if traced
            else contextlib.nullcontext)
    t_start = time.perf_counter()
    i = 0
    while True:
        j = i % len(pool)
        t0 = time.perf_counter()
        with span(devtrace.SPAN_PREFIX + "solve"):
            out = entry.solve(hier, cfg, pool[j], traffic)
            sync(device)
        t1 = time.perf_counter()
        solve_s.append(t1 - t0)
        solves.append({k: out[k] for k in ("iterations", "cycles",
                                           "converged")})
        sample.offer(i, j, out["u"])
        del out
        i += 1
        if t1 - t_start >= seconds:
            return t_start, t1 - t_start, solve_s, solves


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, t_process: float, device="cuda",
             cell: Optional[Cell] = None):
    """Set-up, the window and the check of one cell; returns the result
    line's object and the checks' lines for standard error.  ``cell``
    replaces the files (tests run a cell at a small size on the CPU)."""
    from tpu_multigrid_torch import kernels

    cell = cell or load_cell(root, workload)
    config, traffic = cell.config, cell.traffic
    entry = load_module(BENCH / "entries" / f"{traffic['entry']}.py")
    readers = {m["name"]: load_module(BENCH / "metrics" / f"{m['name']}.py")
               for m in (cell.per_layer if trace else cell.end_to_end)}
    units = {m["name"]: m["unit"]
             for m in cell.per_layer + cell.end_to_end}

    # Set-up: the hierarchy, the pool, one warm-up solve.  ``held`` counts
    # the bytes the harness keeps on the card through the window (the pool
    # and the sample's buffers), which the program's peak leaves out.
    cuda = torch.device(device).type == "cuda"
    allocated = torch.cuda.memory_allocated if cuda else (lambda: 0)
    marks = [("imports", time.perf_counter())]
    hier, cfg = build_system(config, device)
    marks.append(("hierarchy", time.perf_counter()))
    held = -allocated()
    pool = make_pool(seed, config, traffic, device)
    sync(device)
    held += allocated()
    marks.append(("pool", time.perf_counter()))
    warm = entry.solve(hier, cfg, pool[0], traffic)
    sync(device)
    marks.append(("warm-up solve", time.perf_counter()))
    held -= allocated()
    sample = Sample(SAMPLE, seed, warm["u"])
    held += allocated()
    del warm
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    before = kernels.launch_counts()
    prof = contextlib.nullcontext()
    if trace:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
    with prof:
        with (torch.profiler.record_function(devtrace.SPAN_PREFIX + "window")
              if trace else contextlib.nullcontext()):
            t_start, window_s, solve_s, solves = window(
                entry, hier, cfg, pool, traffic, seconds, device, sample,
                trace)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
    traced = None
    if trace:
        after = kernels.launch_counts()
        dev, host = devtrace.events(prof)
        del prof
        traced = devtrace.Trace(
            device=dev, host=host, window_s=window_s,
            launches={k: after[k] - before.get(k, 0) for k in after})
    run = Run(setup_s=t_start - t_process, window_s=window_s,
              solve_s=solve_s, solves=solves, peak_bytes=peak,
              held_bytes=held, trace=traced,
              config=config)
    metrics = {}
    for name, reader in readers.items():
        value = reader.read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": units[name]}

    # The check, once the program's state is freed.
    del hier, cfg
    if cuda:
        torch.cuda.empty_cache()
    numbers = check.compare(config, traffic, cell.limits, pool,
                            sample.items(), device)
    failed = sum(1 for s in solves if not s["converged"])
    numbers["failed_solves"] = {"value": failed, "limit": 0}
    correct = all(v["value"] <= v["limit"] for v in numbers.values())

    result = {"correct": correct, "attempted": len(solves), "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": (torch.cuda.get_device_name()
                                  if cuda else "cpu"),
                         "count": 1, "memory_peak_bytes": peak}}
    if traced is not None:
        result["device"]["busy_s"] = traced.busy_s
        result["device"]["window_s"] = window_s
        result["breakdown"] = devtrace.breakdown(traced)
    result["checks"] = numbers
    starts = [t_process] + [t for _, t in marks]
    lines = ["setup: " + ", ".join(f"{name} {t - t0:.3f} s" for (name, t), t0
                                   in zip(marks, starts))]
    lines += [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
              for k, v in numbers.items()]
    return result, lines


def forbidden_modules():
    """Loaded modules whose whole top-level name is JAX's or the reference
    package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))
