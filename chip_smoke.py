#!/usr/bin/env python3
"""Smoke test of tpu_multigrid_torch on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing its own lines:

1. Device: the card's name and power limit (nvidia-smi), the CUDA version,
   TF32 switched off for matrix products and convolutions.
2. Build: compiles the CUDA kernels from ``tpu_multigrid_torch/kernels/
   csrc`` and prints how long that took and what ptxas reported.
3. Kernels against their plain torch versions on the card, at the level
   shapes the 8193^2 solve gives them: K1 and K2 to 1e-5 * max|plain| +
   1e-6 (resnorm to 1e-4 relative), the ds/ts residuals bitwise.
4. The slice: the front door's default refined solve at level 13
   (8193^2 nodes, Chebyshev (3, 2), coarsest level 5) to tol 1e-7 with the
   kernels and with the plain path, then 3 plain-iterate cycles; launch
   counts are checked exactly; a level-6 solve is checked against a dense
   float64 solve.
5. Times: ms per V-cycle and DOF/s at 8193^2 on both paths, and each
   kernel beside its plain version, with CUDA events (median of 7 after
   warm-up).

Then one JSON line of kernel records and, last, the device JSON line.
Any failed check raises, so the script exits non-zero and prints no result;
it also exits non-zero when no CUDA device is present.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import tpu_multigrid_torch  # noqa: F401  (fails early outside a checkout)

DEVICE = "cuda"
LEVEL = 13
TOL = 1e-7
# (S, Sc, n) level pairs of the padded hierarchy: the bottom, a middle and
# the finest pair of the 8193^2 solve.
PAIRS = [(256, 256, 64), (768, 512, 512), (8448, 4352, 8192)]
REPLACES = {
    "smooth_restrict": "tpu_multigrid/kernels/transfer.py:307",
    "prolong_smooth": "tpu_multigrid/kernels/transfer.py:461",
    "prolong_smooth_resnorm": "tpu_multigrid/kernels/transfer.py:461",
    "ds_residual": "tpu_multigrid/kernels/compres.py:87",
    "ts_residual": "tpu_multigrid/kernels/compres.py:87",
}
SOURCES = {
    "smooth_restrict": "tpu_multigrid_torch/kernels/csrc/transfer.cu",
    "prolong_smooth": "tpu_multigrid_torch/kernels/csrc/transfer.cu",
    "prolong_smooth_resnorm": "tpu_multigrid_torch/kernels/csrc/transfer.cu",
    "ds_residual": "tpu_multigrid_torch/kernels/csrc/compres.cu",
    "ts_residual": "tpu_multigrid_torch/kernels/csrc/compres.cu",
}
# The kernels of the main path, the front door's default refined solve.
# prolong_smooth_resnorm (only the plain-iterate drivers call it) and
# ts_residual are ported and checked, and reported on lines of their own.
PATH_KERNELS = ["smooth_restrict", "prolong_smooth", "ds_residual"]


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"FAILED: {msg}")


def cuda_ms(fn, reps=7, warmup=2):
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


def interior_randn(S, n, gen, scale=1.0):
    a = torch.zeros((S, S), dtype=torch.float32, device=DEVICE)
    a[1:n, 1:n] = scale * torch.randn((n - 1, n - 1), generator=gen,
                                      device=DEVICE)
    return a


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {torch.cuda.get_device_name(0)}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}; allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}")
    return card


def phase_build():
    from tpu_multigrid_torch.kernels import _build
    t0 = time.perf_counter()
    _build.lib()
    secs = time.perf_counter() - t0
    print(f"[build] kernels built and loaded in {secs:.1f} s "
          f"({_build.build_dir().name})")
    log = (_build.build_dir() / "build.log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "Used" in line or "Compiling entry" in line:
                print("[build]  " + line.strip())


def rel_err_bound(got, want):
    err = float((got - want).abs().max())
    bound = 1e-5 * float(want.abs().max()) + 1e-6
    return err, bound


def phase_kernels(errs):
    from tpu_multigrid_torch import precision
    from tpu_multigrid_torch.core import ops
    from tpu_multigrid_torch.kernels import compres, transfer
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    smoothers = [("chebyshev", "jacobi", 3, 2), ("rbgs", "rbgs", 2, 2)]
    for S, Sc, n in PAIRS:
        u = interior_randn(S, n, gen)
        b = interior_randn(S, n, gen)
        ec = interior_randn(Sc, n // 2, gen)
        for label, sm, nu1, nu2 in smoothers:
            om1 = ops.chebyshev_omegas(nu1, 0.4) if label == "chebyshev" \
                else 2.0 / 3.0
            om2 = ops.chebyshev_omegas(nu2, 0.4) if label == "chebyshev" \
                else 2.0 / 3.0
            ku, krc = transfer.smooth_restrict(u, b, n, Sc, nu1, sm, om1)
            pu, prc = transfer.smooth_restrict_plain(u, b, n, Sc, nu1, sm, om1)
            e1, b1 = rel_err_bound(ku, pu)
            e2, b2 = rel_err_bound(krc, prc)
            check(e1 <= b1 and e2 <= b2,
                  f"K1 {label} {(S, Sc, n)}: u' err {e1} (<= {b1}), "
                  f"rc err {e2} (<= {b2})")
            k2 = transfer.prolong_smooth(u, b, ec, n, nu2, sm, om2)
            p2 = transfer.prolong_smooth_plain(u, b, ec, n, nu2, sm, om2)
            e3, b3 = rel_err_bound(k2, p2)
            check(e3 <= b3, f"K2 {label} {(S, Sc, n)}: err {e3} (<= {b3})")
            k2r, knorm = transfer.prolong_smooth_resnorm(u, b, ec, n, nu2, sm,
                                                         om2)
            p2r, pnorm = transfer.prolong_smooth_resnorm_plain(u, b, ec, n,
                                                               nu2, sm, om2)
            e4, b4 = rel_err_bound(k2r, p2r)
            rn = abs(float(knorm) - float(pnorm)) / float(pnorm)
            check(e4 <= b4 and rn <= 1e-4,
                  f"K2-resnorm {label} {(S, Sc, n)}: u' err {e4} (<= {b4}),"
                  f" norm rel err {rn} (<= 1e-4)")
            print(f"[kernels] {label:9s} S={S:5d} Sc={Sc:5d} n={n:5d}: "
                  f"K1 u' {e1:.3g} rc {e2:.3g}; K2 {e3:.3g}; "
                  f"K2-resnorm u' {e4:.3g} norm rel {rn:.3g}")
            if (S, label) == (PAIRS[-1][0], "chebyshev"):
                errs["smooth_restrict"] = max(e1, e2)
                errs["prolong_smooth"] = e3
                errs["prolong_smooth_resnorm"] = max(
                    e4, abs(float(knorm) - float(pnorm)))
    S, n = PAIRS[-1][0], PAIRS[-1][2]
    bb = interior_randn(S, n, gen, 1.0 / n ** 2)
    uh = interior_randn(S, n, gen)
    um = interior_randn(S, n, gen, 1e-7)
    ul = interior_randn(S, n, gen, 1e-14)
    ds_k = compres.ds_residual(bb, uh, um, n)
    ds_p = precision.ds_residual(bb, uh, um, n)
    ts_k = compres.ts_residual(bb, uh, um, ul, n)
    ts_p = precision.ts_residual(bb, uh, um, ul, n)
    check(torch.equal(ds_k, ds_p), "ds_residual differs from its plain "
          f"version: max err {float((ds_k - ds_p).abs().max())}")
    check(torch.equal(ts_k, ts_p), "ts_residual differs from its plain "
          f"version: max err {float((ts_k - ts_p).abs().max())}")
    errs["ds_residual"] = 0.0
    errs["ts_residual"] = 0.0
    print(f"[kernels] ds/ts residual S={S} n={n}: bitwise equal")
    torch.cuda.synchronize()


def hist_str(res):
    h = res.res_history[:res.iterations + 1]
    return "[" + ", ".join(f"{float(x):.4e}" for x in h) + "]"


def phase_slice():
    import dataclasses

    import tpu_multigrid_torch as tmg
    from tpu_multigrid_torch import kernels
    from tpu_multigrid_torch.core.grids import dense_poisson_matrix, round_up

    cfg = tmg.MultigridConfig(finest_level=LEVEL, coarsest_level=5, nu1=3,
                              nu2=2, smoother="chebyshev", use_kernels=True)
    plain = dataclasses.replace(cfg, use_kernels=False)
    nl = cfg.num_levels - 1

    # Main path: every count starts at 0 here and is read right after the
    # refined solve; comparison and timing launches are outside this window.
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = tmg.solve_poisson(LEVEL, config=cfg, tol=TOL, device=DEVICE)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    c1 = kernels.launch_counts()
    # The plain-iterate driver, in a window of its own: it is the only
    # caller of K2-resnorm.
    kernels.reset_launch_counts()
    fixed = tmg.solve_poisson(LEVEL, config=cfg, num_cycles=3, refined=False,
                              device=DEVICE)
    torch.cuda.synchronize()
    c2 = kernels.launch_counts()

    it = res.iterations
    print(f"[slice] kernels: converged={res.converged} iterations={it} "
          f"history={hist_str(res)}")
    check(res.converged and it <= 10,
          f"level-{LEVEL} refined solve: converged={res.converged} in {it}")
    u = tmg.extract_solution(res.u, 2 ** LEVEL)
    S = round_up(2 ** LEVEL + 1, 256)
    check(tuple(res.u.shape) == (S, S) and bool(torch.isfinite(u).all()),
          "solution shape/finiteness")
    want1 = {"smooth_restrict": nl * it, "prolong_smooth": nl * it,
             "prolong_smooth_resnorm": 0, "ds_residual": it, "ts_residual": 0}
    check(c1 == want1, f"refined-solve launches {c1}, expected {want1}")
    want2 = {"smooth_restrict": 3 * nl, "prolong_smooth": 3 * (nl - 1),
             "prolong_smooth_resnorm": 3, "ds_residual": 0, "ts_residual": 0}
    check(c2 == want2, f"fixed-cycle launches {c2}, expected {want2}")
    print(f"[slice] launches: refined solve {c1}; 3 fixed cycles {c2}")

    t0 = time.perf_counter()
    res_p = tmg.solve_poisson(LEVEL, config=plain, tol=TOL, device=DEVICE)
    torch.cuda.synchronize()
    secs_p = time.perf_counter() - t0
    print(f"[slice] time to tol {TOL:g} at {2 ** LEVEL + 1}^2 (one call, "
          f"set-up included): kernels {secs:.3f} s, plain {secs_p:.3f} s")
    fixed_p = tmg.solve_poisson(LEVEL, config=plain, num_cycles=3,
                                refined=False, device=DEVICE)
    torch.cuda.synchronize()
    check(kernels.launch_counts() == c2, "the plain path launched kernels")
    print(f"[slice] plain:   converged={res_p.converged} "
          f"iterations={res_p.iterations} history={hist_str(res_p)}")
    check(res_p.converged and abs(res_p.iterations - it) <= 1,
          f"plain path: converged={res_p.converged} in {res_p.iterations}, "
          f"kernel path in {it}")
    up = tmg.extract_solution(res_p.u, 2 ** LEVEL)
    du = float((u - up).abs().max()) / float(up.abs().max())
    print(f"[slice] max |u_kernels - u_plain| / max|u_plain| = {du:.3e}")
    hk = fixed.res_history.numpy()
    hp = fixed_p.res_history.numpy()
    print(f"[slice] 3 fixed cycles: kernels {hist_str(fixed)} "
          f"plain {hist_str(fixed_p)}")
    check(np.allclose(hk, hp, rtol=1e-3, atol=0),
          "fixed-cycle histories differ beyond rtol 1e-3")

    # Small input against a dense float64 solve of the same system.
    small = dataclasses.replace(cfg, finest_level=6)
    rs = tmg.solve_poisson(6, config=small, tol=TOL, device=DEVICE)
    n = 64
    bvec = np.full((n - 1) ** 2, 4.0 / n ** 2)
    ref = np.linalg.solve(dense_poisson_matrix(n), bvec).reshape(n - 1, n - 1)
    got = rs.u[1:n, 1:n].double().cpu().numpy()
    err = np.abs(got - ref).max() / np.abs(ref).max()
    print(f"[slice] level 6 vs dense float64 solve: rel err {err:.3e} "
          f"({rs.iterations} iterations)")
    check(rs.converged and err <= 1e-5, f"level-6 solve rel err {err}")
    return c1, c2


def phase_times(card):
    import tpu_multigrid_torch as tmg
    from tpu_multigrid_torch import precision
    from tpu_multigrid_torch.core import ops
    from tpu_multigrid_torch.kernels import compres, transfer

    times = {}
    dof = (2 ** LEVEL - 1) ** 2
    for use in (True, False):
        cfg = tmg.MultigridConfig(finest_level=LEVEL, coarsest_level=5, nu1=3,
                                  nu2=2, smoother="chebyshev",
                                  use_kernels=use)
        prob = tmg.PoissonProblem(cfg, device=DEVICE,
                                  **({"align": 256, "min_pad_level": 0}
                                     if use else {}))
        b = prob.rhs()
        u = torch.zeros_like(b)
        ms = cuda_ms(lambda: tmg.cycle(prob.hierarchy, cfg, u, b))
        times["vcycle" if use else "vcycle_plain"] = ms
        print(f"[times] V-cycle at {2 ** LEVEL + 1}^2, "
              f"{'kernels' if use else 'plain  '}: {ms:.3f} ms, "
              f"{dof / (ms * 1e-3):.4g} DOF/s  ({card})")
        del prob, b, u
        torch.cuda.empty_cache()

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1)
    S, Sc, n = PAIRS[-1]
    u = interior_randn(S, n, gen)
    b = interior_randn(S, n, gen)
    ec = interior_randn(Sc, n // 2, gen)
    lo = interior_randn(S, n, gen, 1e-7)
    om3, om2 = ops.chebyshev_omegas(3, 0.4), ops.chebyshev_omegas(2, 0.4)
    cases = {
        "smooth_restrict": (
            lambda: transfer.smooth_restrict(u, b, n, Sc, 3, "jacobi", om3),
            lambda: transfer.smooth_restrict_plain(u, b, n, Sc, 3, "jacobi",
                                                   om3)),
        "prolong_smooth": (
            lambda: transfer.prolong_smooth(u, b, ec, n, 2, "jacobi", om2),
            lambda: transfer.prolong_smooth_plain(u, b, ec, n, 2, "jacobi",
                                                  om2)),
        "prolong_smooth_resnorm": (
            lambda: transfer.prolong_smooth_resnorm(u, b, ec, n, 2, "jacobi",
                                                    om2),
            lambda: transfer.prolong_smooth_resnorm_plain(u, b, ec, n, 2,
                                                          "jacobi", om2)),
        "ds_residual": (
            lambda: compres.ds_residual(b, u, lo, n),
            lambda: precision.ds_residual(b, u, lo, n)),
        "ts_residual": (
            lambda: compres.ts_residual(b, u, lo, lo, n),
            lambda: precision.ts_residual(b, u, lo, lo, n)),
    }
    for name, (kern, plain) in cases.items():
        times[name] = (cuda_ms(kern), cuda_ms(plain))
        k, p = times[name]
        print(f"[times] {name:23s} S={S}: kernel {k:.3f} ms, plain {p:.3f} ms"
              f"  ({card})")
    return times


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = phase_device()
    phase_build()
    errs = {}
    phase_kernels(errs)
    counts, fixed_counts = phase_slice()
    times = phase_times(card)
    for name in PATH_KERNELS:
        check(counts[name] > 0, f"{name} was not launched on the main path")
    resnorm_runs = fixed_counts["prolong_smooth_resnorm"]
    for name, where in (("prolong_smooth_resnorm",
                         f"{resnorm_runs} launches in 3 fixed cycles"),
                        ("ts_residual", "off the solve path")):
        print(f"[{name}] not on the main path ({where}): max_abs_err "
              f"{errs[name]}, kernel {times[name][0]:.3f} ms, "
              f"plain {times[name][1]:.3f} ms")
    records = [{"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": counts[name],
                "max_abs_err": errs[name], "ms": times[name][0],
                "plain_ms": times[name][1]} for name in PATH_KERNELS]
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
