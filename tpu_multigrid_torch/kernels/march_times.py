#!/usr/bin/env python3
"""Times the streaming smoother (``stencil``'s five entries) and K1v_3
(``vartransfer3d.var_smooth_restrict3`` and its ext form) of any checkout of
this repository on one GPU, at the shapes and settings of ``chip_smoke.py``'s
``phase_times`` (``PERF.md`` section 6, rows 7 and 15), so that two versions
of the kernels compare on one card in one call.

Run from the root of a checkout:

    python3 tpu_multigrid_torch/kernels/march_times.py [--tree DIR]
        [--only streamed|k1v3]

``--tree`` names the root of the checkout whose ``tpu_multigrid_torch`` is
imported and timed (default: this file's own); each checkout builds its
kernels into its own ``build/``.  ``--only`` times one of the two kernels.  Prints the card's name and power limit as
``nvidia-smi`` gives them, one line per case (CUDA events, median of 7
after 2 warm-up calls, as ``chip_smoke.py``'s ``cuda_ms``), the compiler's
register, shared-memory and spill lines of the timed kernels, and, as the
last line, one JSON object of the times.  Exits non-zero without a CUDA
device.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

# The timed kernels in the compiler's output (-Xptxas=-v), old and new: the
# parts of a mangled name that pick each out.
KERNELS = (("15streamed_kernel",), ("row_march_kernel",),
           ("smooth_restrict3_kernel", "VarOp3"))


def cuda_ms(torch, fn, reps=7, warmup=2):
    """Median device time of one call, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def interior(torch, shape, n, gen):
    """Zero but for N(0, 1) values on the interior 1..n-1 of every axis."""
    a = torch.zeros(shape, device="cuda")
    a[(slice(1, n),) * len(shape)] = torch.randn(
        (n - 1,) * len(shape), generator=gen, device="cuda")
    return a


def streamed_cases(torch, ops, stencil, gen):
    """The five entries at S = 16640 (n = 16384): Chebyshev 3 + residual,
    Chebyshev 2, RB-GS 2 + residual, RB-GS 2, the residual alone."""
    S, n = 16640, 16384
    u, b = interior(torch, (S, S), n, gen), interior(torch, (S, S), n, gen)
    om3, om2 = ops.chebyshev_omegas(3, 0.4), ops.chebyshev_omegas(2, 0.4)
    return {
        "jacobi_sweeps_residual": lambda: stencil.jacobi_sweeps_residual(
            u, b, n, om3, 3),
        "jacobi_sweeps": lambda: stencil.jacobi_sweeps(u, b, n, om2, 2),
        "rbgs_sweeps_residual": lambda: stencil.rbgs_sweeps_residual(
            u, b, n, 2),
        "rbgs_sweeps": lambda: stencil.rbgs_sweeps(u, b, n, 2),
        "residual": lambda: stencil.residual(u, b, n)}


def k1v3_cases(torch, ops, VT3, gen):
    """K1v_3 at (528, 528, 640) / (272, 272, 384) with Chebyshev 3 on 3 and
    4 seeded planes, at (272, 272, 384) / (144, 144, 256) with RB-GS 2 on 6;
    K1v_3-ext at the (1, 1) level-9 block (576, 576, 640) / (304, 304, 384),
    origin (-16, -16), Chebyshev 3 on 3, 4 and 6 planes."""
    om3 = ops.chebyshev_omegas(3, 0.4)
    out = {}
    for shape, shape_c, n, nplanes, sm, om, sw in [
            ((528, 528, 640), (272, 272, 384), 512, 3, "jacobi", om3, 3),
            ((528, 528, 640), (272, 272, 384), 512, 4, "jacobi", om3, 3),
            ((272, 272, 384), (144, 144, 256), 256, 6, "rbgs", 1.0, 2)]:
        u, b = interior(torch, shape, n, gen), interior(torch, shape, n, gen)
        coef = 0.5 + torch.rand((nplanes,) + shape, generator=gen,
                                device="cuda")
        out[f"var_smooth_restrict3_{nplanes}"] = (
            lambda u=u, b=b, coef=coef, n=n, shape_c=shape_c, sw=sw, sm=sm,
            om=om: VT3.var_smooth_restrict3(u, b, coef, n, shape_c, sw, sm,
                                            om))
    shape, shape_c, n = (576, 576, 640), (304, 304, 384), 512
    u = torch.randn(shape, generator=gen, device="cuda")
    b = torch.randn(shape, generator=gen, device="cuda")
    for nplanes in (3, 4, 6):
        coef = 0.5 + torch.rand((nplanes,) + shape, generator=gen,
                                device="cuda")
        out[f"var_smooth_restrict_ext3_{nplanes}"] = (
            lambda coef=coef: VT3.var_smooth_restrict_ext3(
                u, b, coef, (-16, -16), n, shape_c, 3, "jacobi", om3))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=None,
                    help="root of the checkout to time (default: this one)")
    ap.add_argument("--only", choices=("streamed", "k1v3"), default=None,
                    help="time one kernel's cases only")
    args = ap.parse_args()
    root = (Path(args.tree) if args.tree
            else Path(__file__).resolve().parents[2]).resolve()
    sys.path[0] = str(root)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from tpu_multigrid_torch.core import ops
    from tpu_multigrid_torch.kernels import _build, stencil
    from tpu_multigrid_torch.kernels import vartransfer3d as VT3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "?"
    print(card)
    _build.lib()
    log = _build.build_dir() / "build.log"
    entry = None
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line if any(all(k in line for k in ks)
                                for ks in KERNELS) else None
        elif entry is not None and ("Used" in line or "spill" in line):
            print(f"[ptxas] {entry.split(chr(39))[1]}: {line.strip()}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    times = {}
    makers = {"streamed": lambda: streamed_cases(torch, ops, stencil, gen),
              "k1v3": lambda: k1v3_cases(torch, ops, VT3, gen)}
    for key, make in makers.items():
        if args.only not in (None, key):
            continue
        cases = make()
        for name, fn in cases.items():
            times[name] = cuda_ms(torch, fn)
            print(f"[march] {name:32s} {times[name]:.3f} ms  ({card}; "
                  f"{root.name})")
        del cases
        torch.cuda.empty_cache()
    print(json.dumps({"tree": str(root), "card": card, "times": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
