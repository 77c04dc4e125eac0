#!/usr/bin/env python3
"""Where the time of one V-cycle of tpu_multigrid_torch goes, on one GPU.

Run from the root of a checkout:  python3 profile_vcycle.py [--level 13]

It builds the hierarchy that ``solve_poisson`` builds for the kernel path
(levels --level..5, every level padded to a multiple of 256, Chebyshev-Jacobi
(3, 2), dense coarse inverse) and prints:

1. ``[device]``: the card's name and power limit, as nvidia-smi gives them.
2. ``[vcycle]``: the device time of one V-cycle (CUDA events, median of 7
   after warm-up) and the host time to issue it (host clock from a
   synchronised start until ``cycle`` returns; nothing inside synchronises).
3. ``[trace]``: torch.profiler over --cycles V-cycles: device time per kernel
   name, the device's busy time (the union of kernel intervals), the wall
   time of the profiled region on the host clock, and the idle share
   1 - busy / wall.  The profiler slows the host, so the script also prints
   the idle share against the event-timed V-cycle: 1 - busy per cycle /
   V-cycle time.
4. ``[launch]``: for each level pair, per K1 and per K2 launch: the device
   time (CUDA events over 20 launches queued behind a sleep kernel, so that
   no host time is in it), the time of one launch timed alone (CUDA events
   from a synchronised start, median of 7: the device waits for the host
   there), the wrapper's host time, and the host time of its C entry alone
   with the outputs allocated beforehand (host clock over --launches calls
   issued back to back, per call).  Where a wrapper's host time exceeds its
   device time, issuing that level takes longer than running it.

The last line is one JSON object with every number above.  Exits non-zero
when no CUDA device is present.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

from chip_smoke import cuda_ms, interior_randn

# ~25 ms at the H100's clock: longer than the host takes to queue the calls
# of one device_us reading.
SLEEP_CYCLES = 50_000_000


def device_us(fn, calls, reps=3):
    """Device time per call of ``calls`` calls run back to back, in us
    (median of ``reps``).  A sleep kernel holds the device while the host
    queues the calls, so the host's issue time stays out of the reading."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / calls)
    return statistics.median(times)


def host_us(fn, calls):
    """Host time per call of ``calls`` calls issued back to back, in us."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs / calls * 1e6


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def short_name(name):
    """A kernel's name without its return type and argument list."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0][:80]


def phase_vcycle(tmg, hier, cfg, u, b, out):
    ms = cuda_ms(lambda: tmg.cycle(hier, cfg, u, b))
    issue = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tmg.cycle(hier, cfg, u, b)
        issue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    out["vcycle_ms"] = ms
    out["vcycle_issue_ms"] = statistics.median(issue)
    print(f"[vcycle] device {ms:.3f} ms per V-cycle; host issue "
          f"{out['vcycle_issue_ms']:.3f} ms (median of 7)")


def phase_trace(tmg, hier, cfg, u, b, cycles, out):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tmg.cycle(hier, cfg, u, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(cycles):
            tmg.cycle(hier, cfg, u, b)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        print("[trace] the profiler recorded no device events: not measured")
        out["trace"] = None
        return
    per_name = {}
    for e in events:
        key = short_name(e.name)
        t, c = per_name.get(key, (0.0, 0))
        per_name[key] = (t + e.time_range.end - e.time_range.start, c + 1)
    for key, (t, c) in sorted(per_name.items(), key=lambda kv: -kv[1][0]):
        print(f"[trace] {key:60s} {c:4d} launches {t / 1e3:9.3f} ms")
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in events])
    idle = 1.0 - busy / wall
    idle_events = 1.0 - busy / cycles / 1e3 / out["vcycle_ms"]
    print(f"[trace] {cycles} V-cycles: device busy {busy / 1e3:.3f} ms, "
          f"profiled wall {wall / 1e3:.3f} ms, idle share {idle:.4f}; "
          f"against the event-timed V-cycle, idle share {idle_events:.4f}")
    out["trace"] = {"cycles": cycles, "busy_ms": busy / 1e3,
                    "wall_ms": wall / 1e3, "idle_share": idle,
                    "idle_share_vs_events": idle_events,
                    "per_kernel_ms": {k: t / 1e3
                                      for k, (t, _) in per_name.items()}}


def phase_launch(hier, cfg, launches, out):
    from tpu_multigrid_torch.core import ops
    from tpu_multigrid_torch.core.grids import coarse_solve
    from tpu_multigrid_torch.kernels import _build, transfer

    lib = _build.lib()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    om1 = ops.chebyshev_omegas(cfg.nu1, cfg.cheb_lo)
    om2 = ops.chebyshev_omegas(cfg.nu2, cfg.cheb_lo)
    w1, w2 = transfer._weights(om1), transfer._weights(om2)
    rows = []
    for k in range(hier.num_levels - 1):
        op, opc = hier.levels[k], hier.levels[k + 1]
        S, Sc, n = op.S, opc.S, op.n
        u, b = interior_randn(S, n, gen), interior_randn(S, n, gen)
        ec = interior_randn(Sc, n // 2, gen)
        u_out = torch.empty_like(u)
        rc = torch.empty((Sc, Sc), dtype=u.dtype, device=u.device)
        stream = torch.cuda.current_stream().cuda_stream

        def k1():
            return transfer.smooth_restrict(u, b, n, Sc, cfg.nu1, "jacobi",
                                            om1)

        def k2():
            return transfer.prolong_smooth(u, b, ec, n, cfg.nu2, "jacobi",
                                           om2)

        def k1_c():
            lib.tmt_smooth_restrict(
                u.data_ptr(), b.data_ptr(), u_out.data_ptr(), rc.data_ptr(),
                S, Sc, n, cfg.nu1, 0, w1.ctypes.data, w1.size // 2, stream)

        def k2_c():
            lib.tmt_prolong_smooth(
                u.data_ptr(), b.data_ptr(), ec.data_ptr(), u_out.data_ptr(),
                None, None, S, Sc, n, cfg.nu2, 0, w2.ctypes.data,
                w2.size // 2, stream)

        row = {"S": S, "Sc": Sc, "n": n,
               "k1_device_us": device_us(k1, 20),
               "k1_alone_us": cuda_ms(k1) * 1e3,
               "k1_host_us": host_us(k1, launches),
               "k1_entry_host_us": host_us(k1_c, launches),
               "k2_device_us": device_us(k2, 20),
               "k2_alone_us": cuda_ms(k2) * 1e3,
               "k2_host_us": host_us(k2, launches),
               "k2_entry_host_us": host_us(k2_c, launches)}
        rows.append(row)
        for kk in ("k1", "k2"):
            print(f"[launch] S={S:5d} Sc={Sc:5d} {kk.upper()}: device "
                  f"{row[kk + '_device_us']:8.1f} us, timed alone "
                  f"{row[kk + '_alone_us']:8.1f} us; host "
                  f"{row[kk + '_host_us']:5.1f} us, of it the C entry "
                  f"{row[kk + '_entry_host_us']:5.1f} us")
        del u, b, ec, u_out, rc
    opk = hier.levels[-1]
    bk = interior_randn(opk.S, opk.n, gen)

    def coarse():
        return coarse_solve(opk, hier.coarse_inv, bk)

    out["coarse"] = {"S": opk.S, "device_us": device_us(coarse, 20),
                     "host_us": host_us(coarse, launches)}
    print(f"[launch] coarse solve S={opk.S}: device "
          f"{out['coarse']['device_us']:.1f} us, host "
          f"{out['coarse']['host_us']:.1f} us")
    out["levels"] = rows
    torch.cuda.empty_cache()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--level", type=int, default=13)
    p.add_argument("--cycles", type=int, default=5)
    p.add_argument("--launches", type=int, default=50)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_vcycle: no CUDA device", file=sys.stderr)
        return 2
    import tpu_multigrid_torch as tmg

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "not read"
    print(f"[device] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tmg.MultigridConfig(finest_level=args.level, coarsest_level=5,
                              nu1=3, nu2=2, smoother="chebyshev",
                              use_kernels=True)
    prob = tmg.PoissonProblem(cfg, device="cuda", align=256, min_pad_level=0)
    b = prob.rhs()
    u = torch.zeros_like(b)
    out = {"card": card, "level": args.level}
    phase_vcycle(tmg, prob.hierarchy, cfg, u, b, out)
    phase_trace(tmg, prob.hierarchy, cfg, u, b, args.cycles, out)
    del b, u
    torch.cuda.empty_cache()
    phase_launch(prob.hierarchy, cfg, args.launches, out)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
