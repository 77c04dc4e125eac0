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
   1e-6 (resnorm to 1e-4 relative), the ds/ts residuals bitwise.  Then the
   streaming smoother and the three standalone transfers, bitwise, at
   S = 256, 1280 and 16640 for Chebyshev (3, 2) and RB-GS 2, with deep
   smoothing split into launches at S = 256 (10 and 20 sweeps); the
   exact-pair prolongation's hi + err against the float64 prolongation.
4. The slice: the front door's default refined solve at level 13
   (8193^2 nodes, Chebyshev (3, 2), coarsest level 5) to tol 1e-7 with the
   kernels and with the plain path, then 3 plain-iterate cycles; launch
   counts are checked exactly; a level-6 solve is checked against a dense
   float64 solve.
4b. The convergence record: triple-single refinement over the
   double-single cycle (ds_levels 3) at level 14 (16385^2), tol 1e-8, on
   both paths: iterations, history, seconds with set-up, peak device
   memory, an independent float64 residual, exact launch counts.
4c. FMG: solve_poisson(13, use_fmg=True, tol=1e-7) on both paths, with
   exact launch counts; the plain path launches nothing.
4d. Deep smoothing: RB-GS (10, 10) at level 12, 3 cycles, where the
   finest levels are too deep for K1/K2 and run the streaming smoother
   (split into launches), the residual and the standalone transfers.
5. Times: ms per V-cycle and DOF/s at 8193^2 on both paths, one ts
   iteration at 16385^2 on both paths, and each kernel beside its plain
   version (K1/K2/ds/ts at S = 8448, the others at 16640), with CUDA events
   (median of 7 after warm-up).

Every path of phase 4 is driven with all launch counts set to 0 just
before it and read just after.  Then one JSON line of kernel records, with
each entry's launches summed over those path runs, and, last, the device
JSON line.
Any failed check raises, so the script exits non-zero and prints no result;
it also exits non-zero when no CUDA device is present.
"""

import dataclasses
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
RECORD_LEVEL = 14
RECORD_TOL = 1e-8
# (S, Sc, n) for the streaming smoother and the standalone transfers: the
# bottom of the hierarchy, a mid level, and the record's finest level.
NEW_SIZES = [(256, 256, 64), (1280, 768, 1024), (16640, 8448, 16384)]
_T = "tpu_multigrid/kernels/transfer.py"
_S = "tpu_multigrid/kernels/stencil.py:210"
REPLACES = {
    "smooth_restrict": f"{_T}:307",
    "prolong_smooth": f"{_T}:461",
    "prolong_smooth_resnorm": f"{_T}:461",
    "restrict_fw": f"{_T}:699",
    "prolong_add": f"{_T}:789",
    "prolong_comp": f"{_T}:943",
    "jacobi_sweeps": _S,
    "jacobi_sweeps_residual": _S,
    "rbgs_sweeps": _S,
    "rbgs_sweeps_residual": _S,
    "residual": _S,
    "ds_residual": "tpu_multigrid/kernels/compres.py:87",
    "ts_residual": "tpu_multigrid/kernels/compres.py:87",
}
_CSRC = "tpu_multigrid_torch/kernels/csrc/"
SOURCES = {name: _CSRC + ("compres.cu" if "_residual" in name
                          and name.startswith(("ds", "ts"))
                          else "stencil.cu" if REPLACES[name] == _S
                          else "transfer.cu") for name in REPLACES}
# Launch counts of each path run of phase 4, by path.
PATH_COUNTS = {}


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


def drive(path, fn):
    """Run one path with every launch count set to 0 just before it; keep
    the counts read just after."""
    from tpu_multigrid_torch import kernels
    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    PATH_COUNTS[path] = kernels.launch_counts()
    return out


def expect(**counts):
    """A full launch-count dict: the given entries, every other one 0."""
    from tpu_multigrid_torch import kernels
    want = dict.fromkeys(kernels.launch_counts(), 0)
    want.update(counts)
    return want


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


def track(errs, name, got, want):
    """Check a kernel result bitwise against its plain version; keep the
    largest absolute difference seen."""
    err = float((got - want).abs().max())
    check(torch.equal(got, want),
          f"{name} differs from its plain version: max err {err}")
    errs[name] = max(errs.get(name, 0.0), err)


def phase_new_kernels(errs):
    from tpu_multigrid_torch import kernels
    from tpu_multigrid_torch.core import ops
    from tpu_multigrid_torch.kernels import _build, stencil, transfer
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(2)
    chunk = _build.lib().stencil_max_steps   # steps per launch
    for S, Sc, n in NEW_SIZES:
        u, b = interior_randn(S, n, gen), interior_randn(S, n, gen)
        ec = interior_randn(Sc, n // 2, gen)
        cases = [("jacobi", ops.chebyshev_omegas(3, 0.4), 3),
                 ("jacobi", ops.chebyshev_omegas(2, 0.4), 2),
                 ("rbgs", None, 2)]
        if S == 256:   # deep smoothing, split into launches
            cases += [("rbgs", None, 10),
                      ("jacobi", ops.chebyshev_omegas(10, 0.4), 10),
                      ("jacobi", ops.chebyshev_omegas(20, 0.4), 20)]
        splits = []
        for sm, om, sweeps in cases:
            steps = 2 * sweeps if sm == "rbgs" else sweeps
            kernels.reset_launch_counts()
            if sm == "rbgs":
                kr = stencil.rbgs_sweeps_residual(u, b, n, sweeps)
                pr = stencil.rbgs_sweeps_residual_plain(u, b, n, sweeps)
                k = stencil.rbgs_sweeps(u, b, n, sweeps)
                p = stencil.rbgs_sweeps_plain(u, b, n, sweeps)
            else:
                kr = stencil.jacobi_sweeps_residual(u, b, n, om, sweeps)
                pr = stencil.jacobi_sweeps_residual_plain(u, b, n, om, sweeps)
                k = stencil.jacobi_sweeps(u, b, n, om, sweeps)
                p = stencil.jacobi_sweeps_plain(u, b, n, om, sweeps)
            launches = kernels.launch_counts()[f"{sm}_sweeps"]
            check(launches == -(-steps // chunk),
                  f"{sm} {sweeps} sweeps at S={S}: {launches} launches")
            splits.append(f"{sm}{sweeps}:{launches}")
            for name, got, want in ((f"{sm}_sweeps_residual", kr[0], pr[0]),
                                    (f"{sm}_sweeps_residual", kr[1], pr[1]),
                                    (f"{sm}_sweeps", k, p)):
                track(errs, name, got, want)
        track(errs, "residual", stencil.residual(u, b, n),
              stencil.residual_plain(u, b, n))
        track(errs, "restrict_fw", transfer.restrict_fw(b, n, Sc),
              transfer.restrict_fw_plain(b, n, Sc))
        track(errs, "prolong_add", transfer.prolong_add(u, ec, n),
              transfer.prolong_add_plain(u, ec, n))
        hi, err = transfer.prolong_comp(ec, n, S)
        phi, perr = transfer.prolong_comp_plain(ec, n, S)
        track(errs, "prolong_comp", hi, phi)
        track(errs, "prolong_comp", err, perr)
        del phi, perr, kr, pr, k, p, hi, err
        # Exactness needs a float64 prolongation that is exact itself: with
        # 16-bit significands its 4-term sums round in float64 only across
        # exponent gaps over 2^35, while the kernel's float32 neighbour sums
        # round across gaps over 2^7.
        m, ex = torch.frexp(ec)
        ec16 = torch.ldexp(torch.round(m * 65536) / 65536, ex)
        hi, err = transfer.prolong_comp(ec16, n, S)
        exact = ops.prolong(ec16.double(), n // 2, S)
        pair = hi.double() + err.double()
        rounded = int(torch.count_nonzero(err))
        check(torch.equal(pair, exact) and rounded > 0,
              "prolong_comp: hi + err differs from the f64 prolongation by "
              f"{float((pair - exact).abs().max())} ({rounded} nonzero err)")
        print(f"[kernels] S={S:5d} Sc={Sc:5d} n={n:5d}: streaming smoother "
              f"(Chebyshev 3/2, RB-GS 2{', deep' if S == 256 else ''}), "
              f"residual, restriction, prolong-add, prolong-comp: bitwise "
              f"equal; hi + err == f64 P ec exactly ({rounded} nodes with "
              f"err != 0); launches per call {' '.join(splits)}")
        del u, b, ec, ec16, m, ex, hi, err, exact, pair
        torch.cuda.empty_cache()
    torch.cuda.synchronize()


def hist_str(res):
    h = res.res_history[:res.iterations + 1]
    return "[" + ", ".join(f"{float(x):.4e}" for x in h) + "]"


def phase_slice():
    import tpu_multigrid_torch as tmg
    from tpu_multigrid_torch import kernels
    from tpu_multigrid_torch.core.grids import dense_poisson_matrix, round_up

    cfg = tmg.MultigridConfig(finest_level=LEVEL, coarsest_level=5, nu1=3,
                              nu2=2, smoother="chebyshev", use_kernels=True)
    plain = dataclasses.replace(cfg, use_kernels=False)
    nl = cfg.num_levels - 1

    # Main path: every count starts at 0 here and is read right after the
    # refined solve; comparison and timing launches are outside this window.
    t0 = time.perf_counter()
    res = drive("refined-13", lambda: tmg.solve_poisson(
        LEVEL, config=cfg, tol=TOL, device=DEVICE))
    secs = time.perf_counter() - t0
    c1 = PATH_COUNTS["refined-13"]
    # The plain-iterate driver, in a window of its own: it is the only
    # caller of K2-resnorm.
    fixed = drive("fixed-13", lambda: tmg.solve_poisson(
        LEVEL, config=cfg, num_cycles=3, refined=False, device=DEVICE))
    c2 = PATH_COUNTS["fixed-13"]

    it = res.iterations
    print(f"[slice] kernels: converged={res.converged} iterations={it} "
          f"history={hist_str(res)}")
    check(res.converged and it <= 10,
          f"level-{LEVEL} refined solve: converged={res.converged} in {it}")
    u = tmg.extract_solution(res.u, 2 ** LEVEL)
    S = round_up(2 ** LEVEL + 1, 256)
    check(tuple(res.u.shape) == (S, S) and bool(torch.isfinite(u).all()),
          "solution shape/finiteness")
    want1 = expect(smooth_restrict=nl * it, prolong_smooth=nl * it,
                   ds_residual=it)
    check(c1 == want1, f"refined-solve launches {c1}, expected {want1}")
    want2 = expect(smooth_restrict=3 * nl, prolong_smooth=3 * (nl - 1),
                   prolong_smooth_resnorm=3)
    check(c2 == want2, f"fixed-cycle launches {c2}, expected {want2}")
    print(f"[slice] launches: refined solve {nonzero(c1)}; 3 fixed cycles "
          f"{nonzero(c2)}")

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
    del res, res_p, fixed, fixed_p, u, up
    torch.cuda.empty_cache()

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


def nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def f64_rel_residual(b, comps, n):
    """||b - A(sum of comps)|| / ||b|| in float64 on the card."""
    from tpu_multigrid_torch.core import ops
    u = comps[0].double()
    for c in comps[1:]:
        u = u + c.double()
    b64 = b.double()
    r = ops.mask_interior(b64 - 4.0 * u + ops.neighbor_sum(u), n)
    return float(torch.sqrt(torch.sum(r * r)) / torch.sqrt(torch.sum(b64 * b64)))


def record_config(use_kernels, level=RECORD_LEVEL):
    import tpu_multigrid_torch as tmg
    return tmg.MultigridConfig(finest_level=level, coarsest_level=5, nu1=3,
                               nu2=2, smoother="chebyshev",
                               use_kernels=use_kernels)


def run_record(use_kernels, level=RECORD_LEVEL):
    """The record as bench.py takes it: solve_refined_ts(tol=1e-8,
    max_iters=30, ds_levels=3) on a 256-aligned hierarchy, from set-up to
    the end of the solve.  (outputs, seconds, peak bytes, f64 residual)."""
    import tpu_multigrid_torch as tmg
    from tpu_multigrid_torch import precision
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = record_config(use_kernels, level)
    prob = tmg.PoissonProblem(cfg, device=DEVICE, align=256, min_pad_level=0)
    b = prob.rhs()
    out = precision.solve_refined_ts(prob.hierarchy, cfg, b, tol=RECORD_TOL,
                                     max_iters=30, ds_levels=3)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    return out, secs, peak, f64_rel_residual(b, out[:3], 2 ** level)


def record_line(label, level, out, secs, peak, rel):
    it = out[4]
    h = out[3][:it + 1]
    print(f"[record] {label} at {2 ** level + 1}^2: converged={out[5]} "
          f"iterations={it} history=[{', '.join(f'{float(x):.4e}' for x in h)}]"
          f" seconds (one call, set-up included) {secs:.3f}, "
          f"max_memory_allocated {peak / 2 ** 30:.2f} GiB, f64 relative "
          f"residual of u_hi + u_mid + u_lo {rel:.3e}")


def phase_record():
    from tpu_multigrid_torch import kernels
    nl = record_config(True).num_levels
    ds = 3
    out, secs, peak, rel = drive("record-14", lambda: run_record(True))
    it = out[4]
    record_line("kernels", RECORD_LEVEL, out, secs, peak, rel)
    check(out[5] and it <= 12, f"record: converged={out[5]} in {it}")
    check(rel <= 2e-8, f"record: f64 relative residual {rel}")
    check(tuple(out[0].shape) == (2 ** RECORD_LEVEL + 256,) * 2
          and all(bool(torch.isfinite(c).all()) for c in out[:3]),
          "record: shape/finiteness of the triple")
    want = expect(jacobi_sweeps_residual=ds * it, jacobi_sweeps=ds * it,
                  restrict_fw=ds * it, prolong_comp=ds * it,
                  prolong_add=ds * it, ds_residual=ds * it, ts_residual=it,
                  smooth_restrict=(nl - 1 - ds) * it,
                  prolong_smooth=(nl - 1 - ds) * it)
    got = PATH_COUNTS["record-14"]
    check(got == want, f"record launches {got}, expected {want}")
    print(f"[record] launches over {it} iterations: {nonzero(got)}")
    del out
    kernels.reset_launch_counts()
    level = RECORD_LEVEL
    try:
        out_p, secs_p, peak_p, rel_p = run_record(False)
        note = ""
    except torch.cuda.OutOfMemoryError as e:
        level = RECORD_LEVEL - 1
        note = f" (level {RECORD_LEVEL} did not fit: {str(e)[:120]})"
        out_p, secs_p, peak_p, rel_p = run_record(False, level)
    record_line("plain" + note, level, out_p, secs_p, peak_p, rel_p)
    check(set(kernels.launch_counts().values()) == {0},
          "the plain path launched kernels")
    check(out_p[5], "record, plain path: not converged")
    if level == RECORD_LEVEL:
        check(abs(out_p[4] - it) <= 1,
              f"record: plain path in {out_p[4]}, kernel path in {it}")
    del out_p
    torch.cuda.empty_cache()
    return {"iterations": it, "seconds": secs, "peak_gib": peak / 2 ** 30,
            "f64_rel_residual": rel}


def phase_fmg():
    import tpu_multigrid_torch as tmg
    from tpu_multigrid_torch import kernels
    cfg = record_config(True, LEVEL)
    res = drive("fmg-13", lambda: tmg.solve_poisson(
        LEVEL, config=cfg, use_fmg=True, tol=TOL, device=DEVICE))
    it = res.iterations
    nl = cfg.num_levels - 1
    cycle_pairs = nl * (nl + 1) // 2      # one V-cycle from each finer level
    want = expect(restrict_fw=nl, prolong_add=nl,
                  smooth_restrict=cycle_pairs + nl * it,
                  prolong_smooth=cycle_pairs + nl * it, ds_residual=it + 1)
    got = PATH_COUNTS["fmg-13"]
    check(res.converged, f"FMG + refined solve: converged={res.converged}")
    check(got == want, f"FMG launches {got}, expected {want}")
    kernels.reset_launch_counts()
    res_p = tmg.solve_poisson(LEVEL, config=dataclasses.replace(
        cfg, use_kernels=False), use_fmg=True, tol=TOL, device=DEVICE)
    torch.cuda.synchronize()
    check(set(kernels.launch_counts().values()) == {0},
          "the plain FMG path launched kernels")
    check(res_p.converged and abs(res_p.iterations - it) <= 1,
          f"FMG plain path in {res_p.iterations}, kernel path in {it}")
    u = tmg.extract_solution(res.u, 2 ** LEVEL)
    up = tmg.extract_solution(res_p.u, 2 ** LEVEL)
    du = float((u - up).abs().max()) / float(up.abs().max())
    print(f"[fmg] solve_poisson({LEVEL}, use_fmg=True, tol={TOL:g}): kernels "
          f"{it} refined iterations after FMG, plain {res_p.iterations}; "
          f"max |u_kernels - u_plain| / max|u_plain| = {du:.3e}; launches "
          f"{nonzero(got)} (FMG: {nl} restrictions, {nl} prolong-adds)")
    del res, res_p, u, up
    torch.cuda.empty_cache()


def phase_deep():
    import tpu_multigrid_torch as tmg
    from tpu_multigrid_torch import kernels
    level, cycles = 12, 3
    cfg = tmg.MultigridConfig(finest_level=level, coarsest_level=5, nu1=10,
                              nu2=10, smoother="rbgs", use_kernels=True)
    res = drive("rbgs-12", lambda: tmg.solve_poisson(
        level, config=cfg, num_cycles=cycles, refined=False, device=DEVICE))
    # Levels 12..8 (S >= 512) are too deep for K1/K2 (20 half-steps); the
    # S = 256 pairs below are not row-tiled and take K1/K2.  Each pre- and
    # post-smoothing splits into 16 + 4 half-steps: two launches.
    unfused, fused = 5, 2
    want = expect(rbgs_sweeps_residual=2 * unfused * cycles,
                  rbgs_sweeps=2 * unfused * cycles,
                  restrict_fw=unfused * cycles, prolong_add=unfused * cycles,
                  residual=cycles, smooth_restrict=fused * cycles,
                  prolong_smooth=fused * cycles)
    got = PATH_COUNTS["rbgs-12"]
    check(got == want, f"deep-smoothing launches {got}, expected {want}")
    # The plain path on the same 256-aligned hierarchy, so that the two
    # histories compare at the kernels' bitwise agreement.
    kernels.reset_launch_counts()
    plain = dataclasses.replace(cfg, use_kernels=False)
    prob = tmg.PoissonProblem(plain, device=DEVICE, align=256,
                              min_pad_level=0)
    res_p = tmg.solve_fixed(prob.hierarchy, plain, prob.rhs(), cycles)
    torch.cuda.synchronize()
    check(set(kernels.launch_counts().values()) == {0},
          "the plain deep-smoothing path launched kernels")
    hk, hp = res.res_history.numpy(), res_p.res_history.numpy()
    print(f"[deep] RB-GS (10, 10) at {2 ** level + 1}^2, {cycles} cycles: "
          f"kernels {hist_str(res)} plain {hist_str(res_p)}; launches "
          f"{nonzero(got)}")
    # One cycle reaches the f32 residual floor at 4097^2 (~3e-3 relative).
    check(np.allclose(hk, hp, rtol=1e-5, atol=0) and hk[1] < 1e-2 * hk[0],
          "deep-smoothing histories differ beyond rtol 1e-5 or did not fall")
    del res, res_p
    torch.cuda.empty_cache()


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
    del u, b, ec, lo, cases
    torch.cuda.empty_cache()

    from tpu_multigrid_torch.kernels import stencil
    S, Sc, n = NEW_SIZES[-1]
    u = interior_randn(S, n, gen)
    b = interior_randn(S, n, gen)
    ec = interior_randn(Sc, n // 2, gen)
    cases = {
        "jacobi_sweeps_residual": (
            lambda: stencil.jacobi_sweeps_residual(u, b, n, om3, 3),
            lambda: stencil.jacobi_sweeps_residual_plain(u, b, n, om3, 3)),
        "jacobi_sweeps": (
            lambda: stencil.jacobi_sweeps(u, b, n, om2, 2),
            lambda: stencil.jacobi_sweeps_plain(u, b, n, om2, 2)),
        "rbgs_sweeps_residual": (
            lambda: stencil.rbgs_sweeps_residual(u, b, n, 2),
            lambda: stencil.rbgs_sweeps_residual_plain(u, b, n, 2)),
        "rbgs_sweeps": (
            lambda: stencil.rbgs_sweeps(u, b, n, 2),
            lambda: stencil.rbgs_sweeps_plain(u, b, n, 2)),
        "residual": (lambda: stencil.residual(u, b, n),
                     lambda: stencil.residual_plain(u, b, n)),
        "restrict_fw": (lambda: transfer.restrict_fw(b, n, Sc),
                        lambda: transfer.restrict_fw_plain(b, n, Sc)),
        "prolong_add": (lambda: transfer.prolong_add(u, ec, n),
                        lambda: transfer.prolong_add_plain(u, ec, n)),
        "prolong_comp": (lambda: transfer.prolong_comp(ec, n, S),
                         lambda: transfer.prolong_comp_plain(ec, n, S)),
    }
    for name, (kern, plain) in cases.items():
        times[name] = (cuda_ms(kern), cuda_ms(plain))
        k, p = times[name]
        print(f"[times] {name:23s} S={S}: kernel {k:.3f} ms, plain {p:.3f} ms"
              f"  ({card})")
    # The compensated adds of the refinement loop stay plain torch on both
    # paths (cycle_ds runs ds_add twice per ds level, the ts loop ts_add
    # twice per iteration).
    for name, fn in (("ds_add", lambda: precision.ds_add(u, b, u)),
                     ("ts_add", lambda: precision.ts_add(u, b, b, u))):
        times[name] = cuda_ms(fn)
        print(f"[times] {name:23s} S={S}: plain torch only "
              f"{times[name]:.3f} ms  ({card})")
    del u, b, ec, cases
    torch.cuda.empty_cache()

    for use in (True, False):
        cfg = record_config(use)
        prob = tmg.PoissonProblem(cfg, device=DEVICE, align=256,
                                  min_pad_level=0)
        b = prob.rhs()
        ms = cuda_ms(lambda: precision.solve_refined_ts(
            prob.hierarchy, cfg, b, num_cycles=1, tol=None, ds_levels=3),
            reps=3, warmup=1)
        times["ts_iteration" if use else "ts_iteration_plain"] = ms
        print(f"[times] one ts iteration (ds_levels 3) at "
              f"{2 ** RECORD_LEVEL + 1}^2, {'kernels' if use else 'plain  '}: "
              f"{ms:.3f} ms  ({card})")
        del prob, b
        torch.cuda.empty_cache()
    return times


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = phase_device()
    phase_build()
    errs = {}
    phase_kernels(errs)
    phase_new_kernels(errs)
    phase_slice()
    record = phase_record()
    phase_fmg()
    phase_deep()
    times = phase_times(card)
    launches = {name: sum(c[name] for c in PATH_COUNTS.values())
                for name in REPLACES}
    for name, n in launches.items():
        check(n > 0, f"{name} was launched on none of the paths")
    print(f"[record] summary: {json.dumps(record)}")
    records = [{"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": errs[name], "ms": times[name][0],
                "plain_ms": times[name][1]} for name in REPLACES]
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
