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
4e. The variable-coefficient slice at BASELINE config 4's size, 4097^2,
   levels 12 -> 5, RB-GS (1, 1), coefficient 1 + 10 exp(-20 |x - (0.4,
   0.6)|^2) (benchmarks/bench_var.py): the var kernels against their plain
   versions at the finest pair (S = 4352, Sc = 2304) on the flux operator,
   on the Galerkin level-11 operator and on a 9-plane nonsymmetric operator
   from a seed, bitwise (K2v-resnorm's norm to 1e-4); solve_diffusion(12,
   tol=1e-5) on the kernels with exact launch counts, and the same solve on
   the plain path over the same hierarchy; 10 fixed cycles from a seeded
   random right-hand side on both paths; solve_helmholtz(12); the unfused
   var level visit (injection restriction) and the var smoother on a
   smoothed coarsest level, each with exact launch counts; level 6 against
   a dense float64 solve of the same flux system.
4f. The 3D constant-coefficient slice (solve_poisson3d) at 513^3 (level 9,
   padded (528, 528, 640), the JAX package's own 3D benchmark size): the 3D
   kernels against their plain versions, bitwise, at (528, 528, 640) /
   (272, 272, 384) and (48, 48, 128) / (32, 32, 128), Chebyshev (3, 2) and
   RB-GS (1, 1), 7-point and 19-point weights (K2_3-resnorm's norm to
   1e-4); then six paths, each with exact launch counts: the default
   solve_poisson3d(9) (it stops at the f32 floor) on both paths; the
   refined solve to 1e-8 on both paths (iterations, seconds with set-up,
   peak device memory, an independent float64 residual of u_hi + u_lo);
   RB-GS (1, 1), 3 fixed cycles from a seeded random right-hand side on
   both paths; solve_poisson3d(6, num_cycles=3), whose finest level takes
   the residual kernel; solve_poisson3d(9, order=4) on the 19-point weights
   against the plain path; a refined level-5 solve to 1e-10 against a
   scipy sparse float64 direct solve.
5. Times: ms per V-cycle and DOF/s at 8193^2, at 4097^2 (var) and at 513^3
   on both paths, one ts iteration at 16385^2 on both paths, and each kernel
   beside its plain version (K1/K2/ds/ts at S = 8448, the var kernels at
   4352, the 3D ones at (528, 528, 640), the others at 16640), with CUDA
   events (median of 7 after warm-up), and the one PyTorch call that
   computes the same function where there is one.

Every path of phase 4 is driven with all launch counts set to 0 just
before it and read just after.  Then one JSON line of kernel records, with
each entry's launches summed over those path runs and its bound (the bytes
it must move over 3.35 TB/s or its float32 operations over 67 TFLOP/s,
whichever is larger), and, last, the device JSON line.
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
VAR_LEVEL = 12
VAR_TOL = 1e-5
_T = "tpu_multigrid/kernels/transfer.py"
_S = "tpu_multigrid/kernels/stencil.py:210"
_VS = "tpu_multigrid/kernels/varstencil.py:149"
_VT = "tpu_multigrid/kernels/vartransfer.py"
_S3 = "tpu_multigrid/kernels/stencil3d.py:240"
_T3 = "tpu_multigrid/kernels/transfer3d.py"
_VT3 = "tpu_multigrid/kernels/vartransfer3d.py"
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
    "var_smooth": _VS,
    "var_smooth_residual": _VS,
    "var_smooth_restrict_fused": f"{_VT}:76",
    "var_prolong_smooth_fused": f"{_VT}:222",
    "var_prolong_smooth_resnorm": f"{_VT}:222",
    "jacobi_sweeps3": _S3,
    "jacobi_sweeps_residual3": _S3,
    "rbgs_sweeps3": _S3,
    "rbgs_sweeps_residual3": _S3,
    "residual3": _S3,
    "smooth_restrict3": f"{_T3}:279",
    "prolong_smooth3": f"{_T3}:501",
    "prolong_smooth_resnorm3": f"{_T3}:501",
    "var_smooth_restrict3": f"{_VT3}:214",
    "var_prolong_smooth3": f"{_VT3}:385",
    "var_prolong_smooth_resnorm3": f"{_VT3}:385",
}
_CSRC = "tpu_multigrid_torch/kernels/csrc/"
SOURCES = {name: _CSRC + ("compres.cu" if name in ("ds_residual",
                                                   "ts_residual")
                          else "vartransfer3d.cu" if REPLACES[name]
                          .startswith(_VT3)
                          else "stencil3d.cu" if REPLACES[name] == _S3
                          else "transfer3d.cu" if REPLACES[name].startswith(
                              _T3)
                          else "stencil.cu" if REPLACES[name] == _S
                          else "varstencil.cu" if REPLACES[name] == _VS
                          else "vartransfer.cu" if name.startswith("var_")
                          else "transfer.cu") for name in REPLACES}
# The card's published peaks (H100 SXM, NVIDIA's data sheet): device memory
# bandwidth, and float32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
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
            if any(k in line for k in ("Used", "Compiling entry", "spill")):
                print("[build]  " + line.strip())


def phase_kernels(errs):
    """K1, K2 and K2-resnorm at the Poisson solve's level pairs, bitwise
    (the norm to 1e-4); the ds/ts residuals bitwise."""
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
            track(errs, "smooth_restrict", ku, pu)
            track(errs, "smooth_restrict", krc, prc)
            k2 = transfer.prolong_smooth(u, b, ec, n, nu2, sm, om2)
            p2 = transfer.prolong_smooth_plain(u, b, ec, n, nu2, sm, om2)
            track(errs, "prolong_smooth", k2, p2)
            k2r, knorm = transfer.prolong_smooth_resnorm(u, b, ec, n, nu2, sm,
                                                         om2)
            p2r, pnorm = transfer.prolong_smooth_resnorm_plain(u, b, ec, n,
                                                               nu2, sm, om2)
            track(errs, "prolong_smooth_resnorm", k2r, p2r)
            rn = track_norm(errs, "prolong_smooth_resnorm", knorm, pnorm)
            print(f"[kernels] {label:9s} S={S:5d} Sc={Sc:5d} n={n:5d}: "
                  f"K1 u' and rc, K2, K2-resnorm u' bitwise equal; "
                  f"K2-resnorm norm rel {rn:.3g}")
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


def track_norm(errs, name, got, want):
    """Check a fused residual norm against its plain version to 1e-4
    relative (the two sum in different orders); keep the largest absolute
    difference seen.  Returns the relative difference."""
    diff = abs(float(got) - float(want))
    rel = diff / float(want)
    check(rel <= 1e-4, f"{name}: norm rel err {rel} (<= 1e-4)")
    errs[name] = max(errs.get(name, 0.0), diff)
    return rel


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


def bench_coefficient(x, y):
    """benchmarks/bench_var.py's coefficient: 1 + 10 exp(-20 |(x, y) -
    (0.4, 0.6)|^2), evaluated on torch tensors."""
    return 1.0 + 10.0 * torch.exp(-((x - 0.4) ** 2 + (y - 0.6) ** 2) * 20)


def var_config(use_kernels, **kw):
    """BASELINE config 4 as benchmarks/bench_var.py runs it: 4097^2, levels
    12 -> 5, RB-GS (1, 1), a dense coarse inverse at 33^2."""
    import tpu_multigrid_torch as tmg
    fields = dict(finest_level=VAR_LEVEL, coarsest_level=5, nu1=1, nu2=1,
                  smoother="rbgs", use_kernels=use_kernels)
    fields.update(kw)
    return tmg.MultigridConfig(**fields)


def var_setup():
    """The 4097^2 Galerkin hierarchy, built once on the host (with the
    kernels' coefficient planes) and uploaded; shared by the kernel checks,
    the plain-path runs and the times.  (problem, seconds)."""
    import tpu_multigrid_torch as tmg
    t0 = time.perf_counter()
    prob = tmg.DiffusionProblem(var_config(True),
                                coefficient=bench_coefficient, device=DEVICE,
                                align=256, min_pad_level=0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    print(f"[var] set-up of the {2 ** VAR_LEVEL + 1}^2 Galerkin hierarchy "
          f"(host build + one upload): {secs:.3f} s; levels (n, S) "
          f"{[(op.n, op.S) for op in prob.hierarchy.levels]}")
    return prob, secs


def seeded_nonsym_planes(S, n, gen):
    """(9, S, S) planes of a nonsymmetric 9-point operator from a seed:
    off-diagonals in (-1.25, -0.25], diagonal in [8, 9), zero outside the
    interior."""
    from tpu_multigrid_torch.core import ops
    c = -0.25 - torch.rand((9, S, S), generator=gen, device=DEVICE)
    c[0] = 8.0 + torch.rand((S, S), generator=gen, device=DEVICE)
    return torch.where(ops.interior_mask(S, n, c.device), c, 0.0)


def phase_var_kernels(errs, prob):
    """The var kernels at the finest pair of the 4097^2 hierarchy on its flux
    operator, at the next pair on its Galerkin level-11 operator, and on a
    9-plane nonsymmetric operator: bitwise, the resnorm's norm to 1e-4."""
    from tpu_multigrid_torch.core import ops
    from tpu_multigrid_torch.kernels import varstencil as V
    from tpu_multigrid_torch.kernels import vartransfer as VT
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(3)
    f, g, c = prob.hierarchy.levels[:3]
    cases = [("flux", f.coef_sym, f.S, g.S, f.n),
             ("galerkin-11", g.coef_sym, g.S, c.S, g.n),
             ("nonsym-9", seeded_nonsym_planes(f.S, f.n, gen), f.S, g.S,
              f.n)]
    for label, coef, S, Sc, n in cases:
        u, b = interior_randn(S, n, gen), interior_randn(S, n, gen)
        ec = interior_randn(Sc, n // 2, gen)
        rels = []
        for sm, om, sweeps in (("jacobi", ops.chebyshev_omegas(3, 0.4), 3),
                               ("rbgs", 2.0 / 3.0, 1)):
            a = (u, b, coef, n, sweeps, sm, om)
            track(errs, "var_smooth", V.var_smooth(*a), V.var_smooth_plain(*a))
            for got, want in zip(V.var_smooth_residual(*a),
                                 V.var_smooth_residual_plain(*a)):
                track(errs, "var_smooth_residual", got, want)
            a = (u, b, coef, n, Sc, sweeps, sm, om)
            for got, want in zip(VT.var_smooth_restrict_fused(*a),
                                 VT.var_smooth_restrict_plain(*a)):
                track(errs, "var_smooth_restrict_fused", got, want)
            a = (u, b, ec, coef, n, sweeps, sm, om)
            track(errs, "var_prolong_smooth_fused",
                  VT.var_prolong_smooth_fused(*a),
                  VT.var_prolong_smooth_plain(*a))
            ku, knorm = VT.var_prolong_smooth_resnorm(*a)
            pu, pnorm = VT.var_prolong_smooth_resnorm_plain(*a)
            track(errs, "var_prolong_smooth_resnorm", ku, pu)
            rels.append(track_norm(errs, "var_prolong_smooth_resnorm", knorm,
                                   pnorm))
        print(f"[var-kernels] {label:11s} ({coef.shape[0]} planes) S={S:5d} "
              f"Sc={Sc:5d} n={n:5d}, Chebyshev 3 and RB-GS 1: var smoother "
              f"(+ residual), K1v, K2v, K2v-resnorm bitwise equal; resnorm "
              f"norm rel {max(rels):.3g}")
        del u, b, ec, coef
    torch.cuda.empty_cache()
    torch.cuda.synchronize()


def var_state(res):
    if res.converged:
        return "converged"
    return "stalled" if res.stalled else "cycle budget spent"


def var_counts(cycles, pairs):
    """Launches of ``cycles`` cycles of the fused var path over ``pairs``
    level pairs: K1v on each, K2v on each but the finest, whose K2v fuses
    the residual norm."""
    return expect(var_smooth_restrict_fused=cycles * pairs,
                  var_prolong_smooth_fused=cycles * (pairs - 1),
                  var_prolong_smooth_resnorm=cycles)


def phase_var_slice(prob, setup_secs):
    import tpu_multigrid_torch as tmg
    from tpu_multigrid_torch import kernels
    from tpu_multigrid_torch.core.grids import coarse_dense_inverse
    cfg, plain = var_config(True), var_config(False)
    pairs = cfg.num_levels - 1
    hier = prob.hierarchy

    # Main path: the front door, counts set to 0 just before, read after.
    t0 = time.perf_counter()
    res = drive("diffusion-12", lambda: tmg.solve_diffusion(
        VAR_LEVEL, coefficient=bench_coefficient, config=cfg, tol=VAR_TOL,
        device=DEVICE))
    secs = time.perf_counter() - t0
    it = res.iterations
    got = PATH_COUNTS["diffusion-12"]
    check(got == var_counts(it, pairs),
          f"solve_diffusion launches {got}, expected {var_counts(it, pairs)}")
    u = tmg.extract_solution(res.u, 2 ** VAR_LEVEL)
    check(tuple(res.u.shape) == (hier.levels[0].S,) * 2
          and bool(torch.isfinite(u).all()) and (res.converged or res.stalled),
          f"solve_diffusion: shape {tuple(res.u.shape)}, {var_state(res)}")
    # The same solve over the shared hierarchy: kernels, then plain.
    b = prob.rhs()
    t0 = time.perf_counter()
    rk = tmg.solve_until_tol(hier, cfg, b, tol=VAR_TOL)
    torch.cuda.synchronize()
    secs_k = time.perf_counter() - t0
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rp = tmg.solve_until_tol(hier, plain, b, tol=VAR_TOL)
    torch.cuda.synchronize()
    secs_p = time.perf_counter() - t0
    check(set(kernels.launch_counts().values()) == {0},
          "the plain var path launched kernels")
    check(np.array_equal(rk.res_history.numpy(), res.res_history.numpy(),
                         equal_nan=True),
          "the front door and the shared hierarchy gave different histories")
    print(f"[var] solve_diffusion({VAR_LEVEL}, tol={VAR_TOL:g}) kernels: "
          f"{var_state(res)} after {it} iterations, history {hist_str(res)}; "
          f"launches {nonzero(got)}")
    print(f"[var] plain:   {var_state(rp)} after {rp.iterations} iterations, "
          f"history {hist_str(rp)}")
    print(f"[var] seconds for one call: front door with kernels {secs:.3f} "
          f"(set-up included); set-up alone {setup_secs:.3f}; solve alone on "
          f"the built hierarchy: kernels {secs_k:.3f}, plain {secs_p:.3f}")
    check(abs(rp.iterations - it) <= 1 and (rp.converged or rp.stalled)
          and float(rp.res_history[0]) == float(res.res_history[0]),
          f"plain var path: {var_state(rp)} in {rp.iterations}, kernels {it}")
    del res, rk, rp, u

    # 10 fixed cycles from a seeded random right-hand side, far above the
    # float32 floor for the first cycles.
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(4)
    f = hier.levels[0]
    br = interior_randn(f.S, f.n, gen)
    fk = drive("diffusion-12-fixed", lambda: tmg.solve_fixed(hier, cfg, br,
                                                             10))
    got = PATH_COUNTS["diffusion-12-fixed"]
    check(got == var_counts(10, pairs),
          f"fixed-cycle launches {got}, expected {var_counts(10, pairs)}")
    fp = tmg.solve_fixed(hier, plain, br, 10)
    hk, hp = fk.res_history.numpy(), fp.res_history.numpy()
    rate_k = float(hk[3] / hk[0]) ** (1 / 3)
    rate_p = float(hp[3] / hp[0]) ** (1 / 3)
    print(f"[var] 10 fixed cycles, random rhs: kernels {hist_str(fk)}; plain "
          f"{hist_str(fp)}; mean reduction per cycle over cycles 1-3: "
          f"kernels {rate_k:.4f}, plain {rate_p:.4f}")
    check(np.allclose(hk[:4], hp[:4], rtol=1e-3, atol=0) and rate_k < 0.2,
          "random-rhs histories differ beyond rtol 1e-3 or did not fall")

    # Shifted Poisson on the same kernels (a re-discretized hierarchy).
    rh = drive("helmholtz-12", lambda: tmg.solve_helmholtz(
        VAR_LEVEL, shift=lambda x, y: 100.0 * (1.0 + x * y), config=cfg,
        tol=VAR_TOL, device=DEVICE))
    got = PATH_COUNTS["helmholtz-12"]
    check(got == var_counts(rh.iterations, pairs)
          and bool(torch.isfinite(rh.u).all())
          and (rh.converged or rh.stalled),
          f"solve_helmholtz: {var_state(rh)}, launches {got}")
    print(f"[var] solve_helmholtz({VAR_LEVEL}, shift=100 (1 + x y), "
          f"tol={VAR_TOL:g}) kernels: {var_state(rh)} after {rh.iterations} "
          f"iterations, history {hist_str(rh)}; launches {nonzero(got)}")
    del rh

    # The unfused var level visit, and the var smoother on the coarsest
    # level, from the random right-hand side; 2 cycles each.
    inj = var_config(True, restriction="injection")
    ri = drive("injection-12", lambda: tmg.solve_fixed(hier, inj, br, 2))
    got = PATH_COUNTS["injection-12"]
    want = expect(var_smooth_residual=2 * pairs, prolong_add=2 * pairs,
                  var_smooth=2 * pairs)
    check(got == want, f"injection launches {got}, expected {want}")
    rip = tmg.solve_fixed(hier, dataclasses.replace(inj, use_kernels=False),
                          br, 2)
    js = var_config(True, smoother="jacobi", nu1=2, nu2=2,
                    coarse_solver="smooth", coarse_smooth_sweeps=6)
    rj = drive("smoothed-coarsest-12", lambda: tmg.solve_fixed(hier, js, br,
                                                               2))
    got_j = PATH_COUNTS["smoothed-coarsest-12"]
    want_j = var_counts(2, pairs)
    want_j["var_smooth"] = 2
    check(got_j == want_j, f"smoothed-coarsest launches {got_j}, "
          f"expected {want_j}")
    rjp = tmg.solve_fixed(hier, dataclasses.replace(js, use_kernels=False),
                          br, 2)
    # Injection is not a variational transfer for these operators and may
    # not reduce the residual; it is checked finite and against the plain
    # path, the smoothed coarsest level also for a falling residual.
    for label, k, p, falls in (("injection", ri, rip, False),
                               ("smoothed coarsest", rj, rjp, True)):
        hk, hp = k.res_history.numpy(), p.res_history.numpy()
        print(f"[var] {label}, 2 cycles: kernels {hist_str(k)}, plain "
              f"{hist_str(p)}")
        check(np.allclose(hk, hp, rtol=1e-3, atol=0)
              and np.isfinite(hk).all() and (hk[2] < hk[0] or not falls),
              f"{label}: histories differ beyond rtol 1e-3, or are not "
              "finite, or did not fall")
    print(f"[var] launches: injection {nonzero(got)}; smoothed coarsest "
          f"{nonzero(got_j)}")
    del fk, fp, ri, rip, rj, rjp, br
    torch.cuda.empty_cache()

    # Level 6 against a dense float64 solve of the same flux system.
    small = dataclasses.replace(cfg, finest_level=6)
    r6 = tmg.solve_diffusion(6, coefficient=bench_coefficient, config=small,
                             tol=VAR_TOL, device=DEVICE)
    p6 = tmg.DiffusionProblem(small, coefficient=bench_coefficient,
                              device="cpu", align=256, min_pad_level=0)
    n = 64
    inv = coarse_dense_inverse(p6.finest, dtype=torch.float64)
    ref = (inv @ p6.rhs().double()[1:n, 1:n].reshape(-1)).reshape(n - 1,
                                                                   n - 1)
    got6 = r6.u[1:n, 1:n].double().cpu()
    err = float((got6 - ref).abs().max() / ref.abs().max())
    print(f"[var] level 6 vs dense float64 solve: rel err {err:.3e} "
          f"({var_state(r6)} after {r6.iterations} iterations)")
    check(err <= 1e-5, f"level-6 diffusion solve rel err {err}")


# ---------------------------------------------------------------------------
# 4f. The 3D constant-coefficient slice
# ---------------------------------------------------------------------------

LEVEL3 = 9
TOL3 = 1e-8
# (fine shape, coarse shape, n): K1_3 / K2_3 at every pair the 513^3 solve
# fuses (levels 9 -> 8, 8 -> 7, 7 -> 6), and at the pair of levels 5 -> 4
# (one window's worth of tiles).
PAIRS3 = [((528, 528, 640), (272, 272, 384), 512),
          ((272, 272, 384), (144, 144, 256), 256),
          ((144, 144, 256), (80, 80, 128), 128),
          ((48, 48, 128), (32, 32, 128), 32)]
# (shape, n): the streaming smoother at the finest level and at each level
# the 513^3 solve smooths on it (6, 5, 4).
SMOOTH3 = [((528, 528, 640), 512), ((80, 80, 128), 64), ((48, 48, 128), 32),
           ((32, 32, 128), 16)]
# (smoother, omega, sweeps) deeper than one K1_3 window: RB-GS (5, 5) and
# Chebyshev 10 split K1_3, RB-GS 6 and Chebyshev 14 split K2_3 as well.
DEEP3 = [("rbgs", 5), ("jacobi", 10), ("rbgs", 6), ("jacobi", 14)]


def deep_omega(sm, sweeps):
    """The weights of a DEEP3 entry: Chebyshev's for Jacobi."""
    from tpu_multigrid_torch.core import ops
    return ops.chebyshev_omegas(sweeps, 0.4) if sm == "jacobi" else 1.0


def interior_randn3(shape, n, gen, scale=1.0):
    a = torch.zeros(shape, dtype=torch.float32, device=DEVICE)
    a[1:n, 1:n, 1:n] = scale * torch.randn((n - 1,) * 3, generator=gen,
                                           device=DEVICE)
    return a


def config3(use_kernels, level=LEVEL3, **kw):
    """solve_poisson3d's default schedule: Chebyshev (3, 2), coarsest level
    3 (a 343-unknown dense coarse solve)."""
    import tpu_multigrid_torch as tmg
    fields = dict(finest_level=level, smoother="chebyshev", nu1=3, nu2=2,
                  use_kernels=use_kernels)
    fields.update(kw)
    return tmg.MultigridConfig(**fields)


def problem3(cfg, order=2):
    """The front door's padded level layout (S = round_up(n+1, 16), Sx =
    round_up(n+1, 128)) on the card."""
    import tpu_multigrid_torch as tmg
    cls = tmg.Poisson4_3DProblem if order == 4 else tmg.Poisson3DProblem
    return cls(cfg, align=16, min_pad_level=0, lane_align=128, device=DEVICE)


def phase_kernels3d(errs):
    """The 3D kernels against their plain versions: the streaming smoother
    (Chebyshev 3 and 2, RB-GS 1, with and without the residual, the residual
    alone) at each shape of ``SMOOTH3``, and K1_3 / K2_3 / K2_3-resnorm on
    the 7-point stencil and the 19-point weights at each pair of ``PAIRS3``,
    bitwise; the norm to 1e-4."""
    from tpu_multigrid_torch.core import ops
    from tpu_multigrid_torch.core.operators import Const19Op
    from tpu_multigrid_torch.kernels import stencil3d as K3
    from tpu_multigrid_torch.kernels import transfer3d as T3
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(6)
    om3, om2 = ops.chebyshev_omegas(3, 0.4), ops.chebyshev_omegas(2, 0.4)
    for shape, n in SMOOTH3:
        u, b = interior_randn3(shape, n, gen), interior_randn3(shape, n, gen)
        for name, args in (("jacobi_sweeps3", (u, b, n, om2, 2)),
                           ("jacobi_sweeps_residual3", (u, b, n, om3, 3)),
                           ("rbgs_sweeps3", (u, b, n, 1)),
                           ("rbgs_sweeps_residual3", (u, b, n, 1)),
                           ("residual3", (u, b, n))):
            got = getattr(K3, name)(*args)
            want = getattr(K3, name + "_plain")(*args)
            for g, w in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                track(errs, name, g, w)
        print(f"[kernels3d] {shape} n={n}: streaming smoother (Chebyshev "
              f"3/2, RB-GS 1, residual) bitwise equal")
        del u, b
    for shape, shape_c, n in PAIRS3:
        u, b = interior_randn3(shape, n, gen), interior_randn3(shape, n, gen)
        ec = interior_randn3(shape_c, n // 2, gen)
        rels = []
        for st in (None, Const19Op.STENCIL27):
            for sm, o1, s1, o2, s2 in (("jacobi", om3, 3, om2, 2),
                                       ("rbgs", 1.0, 1, 1.0, 1)):
                for g, w in zip(
                        T3.smooth_restrict3(u, b, n, shape_c, s1, sm, o1, st),
                        T3.smooth_restrict3_plain(u, b, n, shape_c, s1, sm,
                                                  o1, st)):
                    track(errs, "smooth_restrict3", g, w)
                a = (u, b, ec, n, s2, sm, o2, st)
                track(errs, "prolong_smooth3", T3.prolong_smooth3(*a),
                      T3.prolong_smooth3_plain(*a))
                ku, knorm = T3.prolong_smooth_resnorm3(*a)
                pu, pnorm = T3.prolong_smooth_resnorm3_plain(*a)
                track(errs, "prolong_smooth_resnorm3", ku, pu)
                rels.append(track_norm(errs, "prolong_smooth_resnorm3",
                                       knorm, pnorm))
                del ku, pu
        print(f"[kernels3d] {shape} / {shape_c} n={n}: K1_3, K2_3, "
              f"K2_3-resnorm (Chebyshev 3/2, RB-GS 1; 7-point and 19-point) "
              f"bitwise equal; resnorm norm rel {max(rels):.3g}")
        del u, b, ec
        torch.cuda.empty_cache()
    # Depths whose halo outgrows the window, split into launches with the
    # step index carried: RB-GS (5, 5) and Chebyshev 10 split K1_3, RB-GS 6
    # and Chebyshev 14 K2_3 too.
    from tpu_multigrid_torch import kernels
    for shape, shape_c, n in (PAIRS3[0], PAIRS3[2]):
        u, b = interior_randn3(shape, n, gen), interior_randn3(shape, n, gen)
        ec = interior_randn3(shape_c, n // 2, gen)
        rels, plans = [], set()
        for st in (None, Const19Op.STENCIL27):
            for sm, sweeps in DEEP3:
                om = deep_omega(sm, sweeps)
                kernels.reset_launch_counts()
                for g, w in zip(
                        T3.smooth_restrict3(u, b, n, shape_c, sweeps, sm, om,
                                            st),
                        T3.smooth_restrict3_plain(u, b, n, shape_c, sweeps,
                                                  sm, om, st)):
                    track(errs, "smooth_restrict3", g, w)
                a = (u, b, ec, n, sweeps, sm, om, st)
                track(errs, "prolong_smooth3", T3.prolong_smooth3(*a),
                      T3.prolong_smooth3_plain(*a))
                ku, knorm = T3.prolong_smooth_resnorm3(*a)
                pu, pnorm = T3.prolong_smooth_resnorm3_plain(*a)
                track(errs, "prolong_smooth_resnorm3", ku, pu)
                rels.append(track_norm(errs, "prolong_smooth_resnorm3",
                                       knorm, pnorm))
                c = kernels.launch_counts()
                plans.add((sm, sweeps, c["smooth_restrict3"],
                           c["prolong_smooth3"], c["prolong_smooth_resnorm3"]))
                del ku, pu
        print(f"[kernels3d] deep: {shape} / {shape_c} n={n}: K1_3, K2_3, "
              f"K2_3-resnorm at RB-GS 5 and 6, Chebyshev 10 and 14 (7- and "
              f"19-point) bitwise equal, split as (smoother, sweeps, K1_3, "
              f"K2_3, K2_3-resnorm launches) {sorted(plans)}; resnorm norm "
              f"rel {max(rels):.3g}")
        del u, b, ec
        torch.cuda.empty_cache()
    torch.cuda.synchronize()


def counts3(cycles, *, fused=3, unfused=3, resnorm=True, smoother="jacobi"):
    """Launches of ``cycles`` cycles of the 3D kernel path: K1_3 on each of
    ``fused`` level pairs, K2_3 on each (the finest one's with the norm when
    ``resnorm``), and the fused smoother + residual and the smoother on
    each of ``unfused`` levels."""
    want = {"smooth_restrict3": cycles * fused,
            "prolong_smooth3": cycles * (fused - (1 if resnorm else 0)),
            "prolong_smooth_resnorm3": cycles if resnorm else 0,
            f"{smoother}_sweeps_residual3": cycles * unfused,
            f"{smoother}_sweeps3": cycles * unfused}
    return expect(**{k: v for k, v in want.items() if v})


def f64_rel_residual3(b, comps, n):
    """||b - A(sum of comps)|| / ||b|| in float64 on the card, 7-point."""
    from tpu_multigrid_torch.core import ops3d
    u = comps[0].double()
    for c in comps[1:]:
        u = u + c.double()
    b64 = b.double()
    r = ops3d.mask_interior3(b64 - 6.0 * u + ops3d.neighbor_sum3(u), n)
    return float(torch.sqrt(torch.sum(r * r))
                 / torch.sqrt(torch.sum(b64 * b64)))


def run_refined3(use_kernels, level=LEVEL3, tol=TOL3):
    """The refined 3D solve from set-up to the end: (u_hi, u_lo, hist,
    iterations, converged), seconds, peak bytes, float64 residual."""
    from tpu_multigrid_torch import precision
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = config3(use_kernels, level)
    prob = problem3(cfg)
    b = prob.rhs()
    out = precision.solve_refined_ds(prob.hierarchy, cfg, b, tol=tol,
                                     max_iters=40)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    return out, secs, peak, f64_rel_residual3(b, out[:2], 2 ** level)


def phase_slice3d():
    import tpu_multigrid_torch as tmg
    from tpu_multigrid_torch import kernels
    n9 = 2 ** LEVEL3
    shape9 = (528, 528, 640)

    # 1. The default front door: Chebyshev (3, 2), tol 1e-8 unrefined: it
    # stops at the f32 floor.
    res = drive("poisson3d-9", lambda: tmg.solve_poisson3d(LEVEL3,
                                                           device=DEVICE))
    it = res.iterations
    got = PATH_COUNTS["poisson3d-9"]
    check(got == counts3(it), f"solve_poisson3d({LEVEL3}) launches {got}, "
          f"expected {counts3(it)}")
    check(tuple(res.u.shape) == shape9
          and bool(torch.isfinite(res.u).all()) and (res.converged
                                                     or res.stalled),
          f"solve_poisson3d({LEVEL3}): shape {tuple(res.u.shape)}, "
          f"{var_state(res)}")
    prob_p = problem3(config3(False))
    rp = tmg.solve_until_tol(prob_p.hierarchy, config3(False), prob_p.rhs(),
                             tol=TOL3)
    torch.cuda.synchronize()
    check(kernels.launch_counts() == got, "the plain 3D path launched kernels")
    floor_k = float(res.res_history[it] / res.res_history[0])
    floor_p = float(rp.res_history[rp.iterations] / rp.res_history[0])
    print(f"[slice3d] solve_poisson3d({LEVEL3}) defaults, kernels: "
          f"{var_state(res)} after {it} iterations at {floor_k:.3e} of r0, "
          f"history {hist_str(res)}; launches {nonzero(got)}")
    print(f"[slice3d] plain: {var_state(rp)} after {rp.iterations} "
          f"iterations at {floor_p:.3e} of r0, history {hist_str(rp)}")
    check(abs(rp.iterations - it) <= 1 and (rp.converged or rp.stalled)
          and floor_k < 1e-2 and floor_p < 1e-2,
          f"default 3D solve: kernels {it} to {floor_k}, plain "
          f"{rp.iterations} to {floor_p}")
    ut = tmg.extract_solution(res.u, n9)
    up = tmg.extract_solution(rp.u, n9)
    du = float((ut - up).abs().max()) / float(up.abs().max())
    print(f"[slice3d] max |u_kernels - u_plain| / max|u_plain| = {du:.3e}")
    del res, rp, ut, up, prob_p
    torch.cuda.empty_cache()

    # 2. Refined to 1e-8 on both paths.
    out, secs, peak, rel = drive("refined3d-9", lambda: run_refined3(True))
    it = out[3]
    got = PATH_COUNTS["refined3d-9"]
    want = counts3(it, resnorm=False)
    check(got == want, f"refined 3D launches {got}, expected {want}")
    summary = {"iterations": it, "seconds": secs, "peak_gib": peak / 2 ** 30,
               "f64_rel_residual": rel}
    hist = ", ".join(f"{float(x):.4e}" for x in out[2][:it + 1])
    print(f"[refined3d] kernels at {n9 + 1}^3 tol {TOL3:g}: converged="
          f"{out[4]} iterations={it} history=[{hist}] seconds (one call, "
          f"set-up included) {secs:.3f}, max_memory_allocated "
          f"{peak / 2 ** 30:.2f} GiB, f64 relative residual of u_hi + u_lo "
          f"{rel:.3e}")
    check(out[4] and rel <= 2e-8, f"refined 3D: converged={out[4]} in {it}, "
          f"f64 residual {rel}")
    del out
    kernels.reset_launch_counts()
    out_p, secs_p, peak_p, rel_p = run_refined3(False)
    check(set(kernels.launch_counts().values()) == {0},
          "the plain refined 3D path launched kernels")
    print(f"[refined3d] plain at {n9 + 1}^3 tol {TOL3:g}: converged="
          f"{out_p[4]} iterations={out_p[3]} seconds (one call, set-up "
          f"included) {secs_p:.3f}, max_memory_allocated "
          f"{peak_p / 2 ** 30:.2f} GiB, f64 relative residual {rel_p:.3e}; "
          f"launches (kernels) {nonzero(got)}")
    check(out_p[4] and abs(out_p[3] - it) <= 1 and rel_p <= 2e-8,
          f"refined 3D plain path in {out_p[3]} (kernels {it}), f64 {rel_p}")
    summary.update(plain_iterations=out_p[3], plain_seconds=secs_p,
                   plain_peak_gib=peak_p / 2 ** 30)
    del out_p
    torch.cuda.empty_cache()

    # 3. RB-GS (1, 1), 3 fixed cycles from a seeded random right-hand side
    # (far above the f32 floor), both paths on one hierarchy.
    rb = config3(True, smoother="rbgs", nu1=1, nu2=1)
    prob = problem3(rb)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(7)
    br = interior_randn3(shape9, n9, gen)
    rk = drive("rbgs3d-9", lambda: tmg.solve_fixed(prob.hierarchy, rb, br, 3))
    got = PATH_COUNTS["rbgs3d-9"]
    want = counts3(3, smoother="rbgs")
    check(got == want, f"RB-GS 3D launches {got}, expected {want}")
    rpl = tmg.solve_fixed(prob.hierarchy, dataclasses.replace(
        rb, use_kernels=False), br, 3)
    hk, hp = rk.res_history.numpy(), rpl.res_history.numpy()
    print(f"[slice3d] RB-GS (1, 1), 3 cycles, random rhs at {n9 + 1}^3: "
          f"kernels {hist_str(rk)} plain {hist_str(rpl)}; launches "
          f"{nonzero(got)}")
    check(np.allclose(hk, hp, rtol=1e-3, atol=0) and hk[3] < 1e-2 * hk[0],
          "RB-GS 3D histories differ beyond rtol 1e-3 or did not fall")
    del prob, br, rk, rpl
    torch.cuda.empty_cache()

    # 4. Level 6: too narrow for K1_3 (Sx = 128); the norm takes residual3.
    r6 = drive("poisson3d-6", lambda: tmg.solve_poisson3d(
        6, num_cycles=3, device=DEVICE))
    got = PATH_COUNTS["poisson3d-6"]
    want = counts3(3, fused=0, resnorm=False)
    want["residual3"] = 3
    check(got == want, f"solve_poisson3d(6) launches {got}, expected {want}")
    r6p = tmg.solve_poisson3d(6, config=config3(False, 6), num_cycles=3,
                              device=DEVICE)
    h6, h6p = r6.res_history.numpy(), r6p.res_history.numpy()
    print(f"[slice3d] solve_poisson3d(6, num_cycles=3): kernels "
          f"{hist_str(r6)} plain {hist_str(r6p)}; launches {nonzero(got)}")
    check(np.allclose(h6[:3], h6p[:3], rtol=1e-2, atol=0)
          and h6[3] < 1e-2 * h6[0], "level-6 3D histories differ or stall")

    # 5. The 19-point Mehrstellen operator on K1_3 / K2_3's static weights.
    r4 = drive("order4-9", lambda: tmg.solve_poisson3d(LEVEL3, order=4,
                                                       device=DEVICE))
    it4 = r4.iterations
    got = PATH_COUNTS["order4-9"]
    want = counts3(it4, unfused=0)
    check(got == want, f"order=4 launches {got}, expected {want}")
    p4 = problem3(config3(False), order=4)
    r4p = tmg.solve_until_tol(p4.hierarchy, config3(False), p4.rhs(),
                              tol=TOL3)
    torch.cuda.synchronize()
    print(f"[slice3d] solve_poisson3d({LEVEL3}, order=4) kernels: "
          f"{var_state(r4)} after {it4} iterations, history {hist_str(r4)}; "
          f"plain {var_state(r4p)} after {r4p.iterations}, history "
          f"{hist_str(r4p)}; launches {nonzero(got)}")
    check((r4.converged or r4.stalled) and abs(r4p.iterations - it4) <= 1
          and bool(torch.isfinite(r4.u).all()),
          f"order=4: kernels {it4}, plain {r4p.iterations}")
    del r4, r4p, p4
    torch.cuda.empty_cache()

    # 6. A refined level-5 solve against scipy's sparse float64 direct solve
    # of the same 7-point system (29791 unknowns).
    import scipy.sparse as sp
    import scipy.sparse.linalg as spl
    out5, _, _, rel5 = drive("refined3d-5", lambda: run_refined3(True, 5,
                                                                1e-10))
    got = PATH_COUNTS["refined3d-5"]
    want = counts3(out5[3], fused=0, unfused=2, resnorm=False)
    check(got == want, f"refined level-5 launches {got}, expected {want}")
    m = 31
    one = sp.identity(m)
    t = sp.diags([-np.ones(m - 1), 2 * np.ones(m), -np.ones(m - 1)],
                 [-1, 0, 1])
    a = (sp.kron(sp.kron(t, one), one) + sp.kron(sp.kron(one, t), one)
         + sp.kron(sp.kron(one, one), t)).tocsc()
    b5 = problem3(config3(True, 5)).rhs()
    ref = spl.spsolve(a, b5[1:32, 1:32, 1:32].double().cpu().reshape(-1)
                      .numpy())
    sol = (out5[0].double() + out5[1].double())[1:32, 1:32, 1:32]
    err = float(np.abs(sol.cpu().reshape(-1).numpy() - ref).max()
                / np.abs(ref).max())
    print(f"[slice3d] refined level 5 (tol 1e-10, {out5[3]} iterations) vs "
          f"scipy sparse float64 direct solve: rel err {err:.3e}; f64 "
          f"residual {rel5:.3e}; launches {nonzero(got)}")
    check(out5[4] and err <= 1e-7, f"level-5 refined rel err {err}")

    # 7. RB-GS (5, 5) at level 7: 10 half-steps, deeper than one K1_3
    # window (10 + 2 layers): K1_3 runs in two launches, the streaming
    # smoother on levels 6-4 in launches of its own step limit.
    from tpu_multigrid_torch.kernels import _build, stencil, transfer3d
    lib = _build.lib()
    deep = config3(True, 7, smoother="rbgs", nu1=5, nu2=5)
    r7 = drive("rbgs55-3d-7", lambda: tmg.solve_poisson3d(
        7, config=deep, num_cycles=3, device=DEVICE))
    got = PATH_COUNTS["rbgs55-3d-7"]
    per = len(stencil.launch_plan(10, lib.stencil3d_max_steps, (1.0,)))
    want = expect(
        smooth_restrict3=3 * len(transfer3d.split_plan(
            10, 2, lib.window3_max_halo, (1.0,))),
        prolong_smooth_resnorm3=3 * len(transfer3d.split_plan(
            10, 1, lib.window3_max_halo, (1.0,))),
        rbgs_sweeps_residual3=9 * per, rbgs_sweeps3=9 * per)
    check(got == want, f"RB-GS (5, 5) 3D launches {got}, expected {want}")
    r7p = tmg.solve_poisson3d(7, config=dataclasses.replace(
        deep, use_kernels=False), num_cycles=3, device=DEVICE)
    h7, h7p = r7.res_history.numpy(), r7p.res_history.numpy()
    print(f"[slice3d] solve_poisson3d(7), RB-GS (5, 5), 3 cycles: kernels "
          f"{hist_str(r7)} plain {hist_str(r7p)}; launches {nonzero(got)}")
    check(np.allclose(h7[:3], h7p[:3], rtol=1e-3, atol=0)
          and np.isfinite(h7).all() and h7[2] < 1e-2 * h7[0],
          "RB-GS (5, 5) 3D histories differ beyond rtol 1e-3 or stall")
    return summary


# ---------------------------------------------------------------------------
# 4g. The 3D variable-coefficient slice
# ---------------------------------------------------------------------------

VAR3_LEVEL = 9
CONV3_LEVEL = 8


def var3_coefficient(x, y, z):
    """benchmarks/bench_var3.py's coefficient, a = 1 + x + 2y + z."""
    return 1.0 + x + 2.0 * y + z


def var3_shift(x, y, z):
    return 100.0 * (1.0 + x * y * z)


# benchmarks/bench_dir3.py's recirculating winds, on torch tensors.
WINDS3 = dict(bx=lambda x, y, z: torch.sin(2 * np.pi * x) * (0.5 + z),
              by=lambda x, y, z: torch.cos(2 * np.pi * y) - 0.3,
              bz=lambda x, y, z: x - y)


def var3_config(use_kernels, level=None, **kw):
    """bench_var3.py's schedule: Chebyshev (3, 2), coarsest level 3, at
    ``VAR3_LEVEL`` unless another level is given."""
    return config3(use_kernels, VAR3_LEVEL if level is None else level, **kw)


def conv3_config(use_kernels):
    """bench_dir3.py's schedule: RB-GS (2, 2), coarsest level 3."""
    return config3(use_kernels, CONV3_LEVEL, smoother="rbgs", nu1=2, nu2=2)


class HostSetup:
    """Times every call of a module's hierarchy builder while in use (the
    host part of a front door's set-up)."""

    def __init__(self, module, name):
        import importlib
        self.module = importlib.import_module(module)
        self.name, self.seconds = name, 0.0

    def __enter__(self):
        fn = self.fn = getattr(self.module, self.name)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.seconds += time.perf_counter() - t0
        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def diffusion3d_setup():
    return HostSetup("tpu_multigrid_torch.problems.diffusion3d",
                     "build_diffusion3d_hierarchy")


def convection3d_setup():
    return HostSetup("tpu_multigrid_torch.problems.convection3d",
                     "build_convection3d_hierarchy")


def var3_setup():
    """The 513^3 diffusion hierarchy, built once on the host and uploaded;
    shared by the kernel checks, the plain path, the fixed cycles and the
    times.  (problem, host seconds, seconds with the upload)."""
    import tpu_multigrid_torch as tmg
    with diffusion3d_setup() as host:
        t0 = time.perf_counter()
        prob = tmg.Diffusion3DProblem(var3_config(True),
                                      coefficient=var3_coefficient,
                                      device=DEVICE)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    print(f"[var3d] set-up of the {2 ** VAR3_LEVEL + 1}^3 hierarchy: host "
          f"build {host.seconds:.3f} s, with the upload {secs:.3f} s; levels "
          f"{[op.grid_shape for op in prob.hierarchy.levels]}")
    return prob, host.seconds, secs


def seeded_planes3(nplanes, shape, gen):
    """Positive coefficient planes in [0.5, 1.5) from a seed."""
    return 0.5 + torch.rand((nplanes,) + tuple(shape), generator=gen,
                            device=DEVICE)


def phase_var_kernels3d(errs, prob):
    """K1v_3, K2v_3 and K2v_3-resnorm against their plain versions at every
    pair the 513^3 solve fuses (9 -> 8, 8 -> 7, 7 -> 6), on the hierarchy's
    own 3 planes and on seeded 4 and 6 planes, Chebyshev (3, 2) and RB-GS
    (1, 1); then depths past one window (Chebyshev 14, RB-GS 6) at 7 -> 6:
    bitwise, the resnorm's norm to 1e-4."""
    from tpu_multigrid_torch.core import ops
    from tpu_multigrid_torch.kernels import vartransfer3d as VT3
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(9)
    om3, om2 = ops.chebyshev_omegas(3, 0.4), ops.chebyshev_omegas(2, 0.4)
    levels = prob.hierarchy.levels
    for k, (shape, shape_c, n) in enumerate(PAIRS3[:3]):
        check(levels[k].grid_shape == shape, f"level {k} is "
              f"{levels[k].grid_shape}, expected {shape}")
        u, b = interior_randn3(shape, n, gen), interior_randn3(shape, n, gen)
        ec = interior_randn3(shape_c, n // 2, gen)
        depths = [("jacobi", om3, 3, om2, 2), ("rbgs", 1.0, 1, 1.0, 1)]
        if k == 2:
            om14 = ops.chebyshev_omegas(14, 0.4)
            depths += [("jacobi", om14, 14, om14, 14),
                       ("rbgs", 1.0, 6, 1.0, 6)]
        rels = []
        for nplanes in (3, 4, 6):
            coef = (levels[k].coef_stack if nplanes == 3
                    else seeded_planes3(nplanes, shape, gen))
            for sm, o1, s1, o2, s2 in depths:
                for g, w in zip(
                        VT3.var_smooth_restrict3(u, b, coef, n, shape_c, s1,
                                                 sm, o1),
                        VT3.var_smooth_restrict3_plain(u, b, coef, n,
                                                       shape_c, s1, sm, o1)):
                    track(errs, "var_smooth_restrict3", g, w)
                a = (u, b, ec, coef, n, s2, sm, o2)
                track(errs, "var_prolong_smooth3", VT3.var_prolong_smooth3(*a),
                      VT3.var_prolong_smooth3_plain(*a))
                ku, knorm = VT3.var_prolong_smooth_resnorm3(*a)
                pu, pnorm = VT3.var_prolong_smooth_resnorm3_plain(*a)
                track(errs, "var_prolong_smooth_resnorm3", ku, pu)
                rels.append(track_norm(errs, "var_prolong_smooth_resnorm3",
                                       knorm, pnorm))
                del ku, pu
            del coef
            torch.cuda.empty_cache()
        print(f"[var-kernels3d] {shape} / {shape_c} n={n}: K1v_3, K2v_3, "
              f"K2v_3-resnorm on 3 (the hierarchy's), 4 and 6 planes, "
              f"Chebyshev 3/2 and RB-GS 1"
              f"{', Chebyshev 14 and RB-GS 6' if k == 2 else ''} bitwise "
              f"equal; resnorm norm rel {max(rels):.3g}")
        del u, b, ec
        torch.cuda.empty_cache()
    torch.cuda.synchronize()


def var3_counts(cycles, level=None):
    """Launches of ``cycles`` cycles of the fused 3D var path of a level-
    ``level`` solve (``VAR3_LEVEL`` by default): K1v_3 on each pair whose
    fine level has Sx >= 256 (levels 7 and up), K2v_3 on each of those but
    the finest, whose K2v_3 fuses the residual norm."""
    pairs = (VAR3_LEVEL if level is None else level) - 6
    return expect(var_smooth_restrict3=cycles * pairs,
                  var_prolong_smooth3=cycles * (pairs - 1),
                  var_prolong_smooth_resnorm3=cycles)


def front_door3(path, fn, setup):
    """One front-door call on its path with launch counts set to 0 just
    before it: (result, seconds with set-up, host set-up seconds, peak
    device bytes above what was allocated before the call)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with setup as host:
        t0 = time.perf_counter()
        res = drive(path, fn)
        secs = time.perf_counter() - t0
    return (res, secs, host.seconds,
            torch.cuda.max_memory_allocated() - base)


def run_line(label, res, secs, host, peak):
    print(f"[var3d] {label}: {var_state(res)} after {res.iterations} "
          f"iterations, history {hist_str(res)}; seconds for one call "
          f"{secs:.3f} (host set-up {host:.3f}); peak device memory of the "
          f"call {peak / 2 ** 30:.2f} GiB")
    return {"iterations": res.iterations, "state": var_state(res),
            "seconds": secs, "host_setup_seconds": host,
            "peak_gib": peak / 2 ** 30}


def flux_matrix3(op):
    """The interior matrix of a float64 flux-stencil operator on the card,
    as a scipy CSC matrix in row-major interior order."""
    import scipy.sparse as sp
    n, m = op.n, op.n - 1
    inner = (slice(1, n),) * 3
    idx = np.arange(m ** 3).reshape(m, m, m)
    diag = op._diag(torch.float64)[inner].cpu().numpy()
    rows, cols, vals = [idx.ravel()], [idx.ravel()], [diag.ravel()]
    for ax, plus, minus in zip(range(3), (op.tz, op.ty, op.tx), op._tm()):
        for sign, plane in ((1, plus), (-1, minus)):
            src, dst = [slice(None)] * 3, [slice(None)] * 3
            src[ax] = slice(0, m - 1) if sign == 1 else slice(1, m)
            dst[ax] = slice(1, m) if sign == 1 else slice(0, m - 1)
            w = plane[inner].cpu().numpy()[tuple(src)]
            rows.append(idx[tuple(src)].ravel())
            cols.append(idx[tuple(dst)].ravel())
            vals.append(-w.ravel())
    return sp.csc_matrix((np.concatenate(vals),
                          (np.concatenate(rows), np.concatenate(cols))))


def phase_slice_var3(prob, host_secs, setup_secs):
    """The 3D variable-coefficient slice, each path with launch counts set
    to 0 just before it and checked exactly after."""
    import tpu_multigrid_torch as tmg
    from tpu_multigrid_torch import kernels
    n9 = 2 ** VAR3_LEVEL
    hier = prob.hierarchy
    summary = {}

    # 1. The front door at 513^3 on the kernels (its own set-up), and the
    # plain path over the shared hierarchy.
    res, secs, host, peak = front_door3("diffusion3d-9", lambda: (
        tmg.solve_diffusion3d(VAR3_LEVEL, coefficient=var3_coefficient,
                              config=var3_config(True), device=DEVICE)),
        diffusion3d_setup())
    it = res.iterations
    got = PATH_COUNTS["diffusion3d-9"]
    check(got == var3_counts(it), f"solve_diffusion3d({VAR3_LEVEL}) "
          f"launches {got}, expected {var3_counts(it)}")
    check(tuple(res.u.shape) == PAIRS3[0][0]
          and bool(torch.isfinite(res.u).all())
          and (res.converged or res.stalled),
          f"solve_diffusion3d: shape {tuple(res.u.shape)}, {var_state(res)}")
    summary["kernels"] = run_line(
        f"solve_diffusion3d({VAR3_LEVEL}), a = 1 + x + 2y + z, kernels", res,
        secs, host, peak)
    print(f"[var3d] launches {nonzero(got)}")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rp = tmg.solve_until_tol(hier, var3_config(False), prob.rhs(), tol=1e-8)
    torch.cuda.synchronize()
    secs_p = time.perf_counter() - t0
    check(set(kernels.launch_counts().values()) == {0},
          "the plain 3D var path launched kernels")
    summary["plain"] = run_line(
        "plain path on the shared hierarchy (set-up: the shared build, "
        "peak: the solve alone)", rp, setup_secs + secs_p, host_secs,
        torch.cuda.max_memory_allocated() - base)
    check(abs(rp.iterations - it) <= 1 and (rp.converged or rp.stalled)
          and float(rp.res_history[0]) == float(res.res_history[0]),
          f"plain 3D var path: {var_state(rp)} in {rp.iterations}, kernels "
          f"{it}")
    du = float((res.u - rp.u).abs().max()) / float(rp.u.abs().max())
    print(f"[var3d] max |u_kernels - u_plain| / max|u_plain| = {du:.3e}")
    del res, rp
    torch.cuda.empty_cache()

    # 2. 10 fixed cycles from a seeded random right-hand side.
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(10)
    br = interior_randn3(PAIRS3[0][0], n9, gen)
    fk = drive("diffusion3d-9-fixed", lambda: tmg.solve_fixed(
        hier, var3_config(True), br, 10))
    got = PATH_COUNTS["diffusion3d-9-fixed"]
    check(got == var3_counts(10), f"fixed-cycle 3D var launches {got}, "
          f"expected {var3_counts(10)}")
    fp = tmg.solve_fixed(hier, var3_config(False), br, 10)
    hk, hp = fk.res_history.numpy(), fp.res_history.numpy()
    print(f"[var3d] 10 fixed cycles, random rhs: kernels {hist_str(fk)}; "
          f"plain {hist_str(fp)}")
    check(np.allclose(hk[:4], hp[:4], rtol=1e-3, atol=0)
          and np.isfinite(hk).all() and hk[3] < 1e-2 * hk[0],
          "random-rhs 3D var histories differ beyond rtol 1e-3 or stall")
    del fk, fp, br
    torch.cuda.empty_cache()

    # 3. The reaction term, re-discretized on every level (4 planes), each
    # path through the front door with its own set-up.
    runs = {}
    for use in (True, False):
        path = "diffusion3d-9-shift" + ("" if use else "-plain")
        runs[use] = front_door3(path, lambda: tmg.solve_diffusion3d(
            VAR3_LEVEL, coefficient=var3_coefficient, shift=var3_shift,
            config=var3_config(use), device=DEVICE), diffusion3d_setup())
        r = runs[use][0]
        got = PATH_COUNTS[path]
        want = var3_counts(r.iterations) if use else expect()
        check(got == want, f"{path} launches {got}, expected {want}")
        check(bool(torch.isfinite(r.u).all()) and (r.converged or r.stalled),
              f"{path}: {var_state(r)}")
        summary["shift_" + ("kernels" if use else "plain")] = run_line(
            f"shift = 100 (1 + xyz), {'kernels' if use else 'plain'}",
            *runs[use])
    check(abs(runs[True][0].iterations - runs[False][0].iterations) <= 1,
          "shifted 3D solve: iterations differ by more than 1")
    del runs
    torch.cuda.empty_cache()

    # 4. Variable winds at 257^3 (6 planes), the front door on each path;
    # K1v_3 / K2v_3 take the pairs 8 -> 7 and 7 -> 6.
    runs = {}
    for use in (True, False):
        path = "convection3d-8" + ("" if use else "-plain")
        runs[use] = front_door3(path, lambda: (
            tmg.solve_convection_diffusion3d(
                CONV3_LEVEL, eps=0.01, **WINDS3, config=conv3_config(use),
                device=DEVICE)), convection3d_setup())
        r = runs[use][0]
        got = PATH_COUNTS[path]
        want = var3_counts(r.iterations, CONV3_LEVEL) if use else expect()
        check(got == want, f"{path} launches {got}, expected {want}")
        check(bool(torch.isfinite(r.u).all()) and (r.converged or r.stalled),
              f"{path}: {var_state(r)}")
        summary["convection_" + ("kernels" if use else "plain")] = run_line(
            f"solve_convection_diffusion3d({CONV3_LEVEL}), eps 0.01, "
            f"variable winds, RB-GS (2, 2), "
            f"{'kernels' if use else 'plain'}", *runs[use])
    check(abs(runs[True][0].iterations - runs[False][0].iterations) <= 1,
          "3D convection: iterations differ by more than 1")
    del runs
    torch.cuda.empty_cache()

    # 5. Level 5 in float64 (no kernel takes f64) against scipy's sparse
    # direct solve of the same flux system.
    import scipy.sparse.linalg as spl
    c5 = var3_config(False, 5, dtype=torch.float64)
    run5 = front_door3("diffusion3d-5-f64", lambda: tmg.solve_diffusion3d(
        5, coefficient=var3_coefficient, config=c5, tol=1e-10,
        device=DEVICE), diffusion3d_setup())
    r5 = run5[0]
    check(PATH_COUNTS["diffusion3d-5-f64"] == expect(),
          "the float64 level-5 solve launched kernels")
    summary["level5_f64"] = run_line("level 5, float64, tol 1e-10", *run5)
    p5 = tmg.Diffusion3DProblem(c5, coefficient=var3_coefficient,
                                device=DEVICE)
    inner = (slice(1, 32),) * 3
    ref = spl.spsolve(flux_matrix3(p5.finest),
                      p5.rhs()[inner].cpu().reshape(-1).numpy())
    err = float(np.abs(r5.u[inner].cpu().reshape(-1).numpy() - ref).max()
                / np.abs(ref).max())
    print(f"[var3d] level 5, float64: vs scipy sparse direct solve: rel "
          f"err {err:.3e}")
    check(r5.converged and err <= 1e-8, f"level-5 3D var rel err {err}")
    summary["level5_f64_rel_err"] = err
    return summary


# Float32 operations per node, counted from the 3D kernels' sources: a
# Jacobi step of the 7-point stencil (6 adds, 2 multiplies, 1 add), an RB-GS
# half-step on the half of the nodes it updates (7 each), the residual (8);
# the 19-point stencil's Jacobi step (18 multiplies, 17 adds, and 4); the
# 3D full weighting per coarse node (9 x-blurs, 3 y-blurs, 1 z-blur of 3
# each, a halving: 40); trilinear prolongation plus the add per fine node
# (7 on average).
JAC3, HALF3, RES3, JAC19, FW3, PRO3 = 9, 3.5, 8, 39, 40, 7


def times3d(card, times, work):
    """The 513^3 V-cycle on both paths, and each 3D kernel at the finest
    pair beside its plain version (Chebyshev 3 for K1_3 and the fused
    smoother, 2 for K2_3 and the smoother, RB-GS 1 for its entries)."""
    import tpu_multigrid_torch as tmg
    from tpu_multigrid_torch.core import ops
    from tpu_multigrid_torch.kernels import stencil3d as K3
    from tpu_multigrid_torch.kernels import transfer3d as T3
    dof = (2 ** LEVEL3 - 1) ** 3
    for use in (True, False):
        cfg = config3(use)
        prob = problem3(cfg)
        b = prob.rhs()
        u = torch.zeros_like(b)
        ms = cuda_ms(lambda: tmg.cycle(prob.hierarchy, cfg, u, b))
        times["vcycle3d" if use else "vcycle3d_plain"] = ms
        print(f"[times] V-cycle at {2 ** LEVEL3 + 1}^3, Chebyshev (3, 2), "
              f"{'kernels' if use else 'plain  '}: {ms:.3f} ms, "
              f"{dof / (ms * 1e-3):.4g} DOF/s  ({card})")
        del prob, b, u
        torch.cuda.empty_cache()
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(8)
    shape, shape_c, n = PAIRS3[0]
    u, b = interior_randn3(shape, n, gen), interior_randn3(shape, n, gen)
    ec = interior_randn3(shape_c, n // 2, gen)
    om3, om2 = ops.chebyshev_omegas(3, 0.4), ops.chebyshev_omegas(2, 0.4)
    cases = {
        "smooth_restrict3": (u, b, n, shape_c, 3, "jacobi", om3),
        "prolong_smooth3": (u, b, ec, n, 2, "jacobi", om2),
        "prolong_smooth_resnorm3": (u, b, ec, n, 2, "jacobi", om2),
        "jacobi_sweeps3": (u, b, n, om2, 2),
        "jacobi_sweeps_residual3": (u, b, n, om3, 3),
        "rbgs_sweeps3": (u, b, n, 1),
        "rbgs_sweeps_residual3": (u, b, n, 1),
        "residual3": (u, b, n),
    }
    # The bytes each function needs: every output written in full (padded
    # cube); u read over the (n+1)^3 nodes that the interior's stencils
    # reach, but in full for RB-GS, which keeps u outside the interior, and
    # only over the interior for K2_3, which masks u + P e_c first; b over
    # the interior; e_c over the (n/2+1)^3 coarse nodes that P reads.  The
    # operations count the interior nodes.
    cells = shape[0] * shape[1] * shape[2]
    ccells = shape_c[0] * shape_c[1] * shape_c[2]
    reach, inner = (n + 1) ** 3, (n - 1) ** 3
    creach, cinner = (n // 2 + 1) ** 3, (n // 2 - 1) ** 3
    k1 = 4 * (reach + inner + cells + ccells)
    k2 = 4 * (2 * inner + creach + cells)
    work.update({
        "smooth_restrict3": (k1, (3 * JAC3 + RES3) * inner + FW3 * cinner),
        "prolong_smooth3": (k2, (PRO3 + 2 * JAC3) * inner),
        "prolong_smooth_resnorm3": (k2 + 4,
                                    (PRO3 + 2 * JAC3 + RES3 + 2) * inner),
        "jacobi_sweeps3": (4 * (reach + inner + cells), 2 * JAC3 * inner),
        "jacobi_sweeps_residual3": (4 * (reach + inner + 2 * cells),
                                    (3 * JAC3 + RES3) * inner),
        "rbgs_sweeps3": (4 * (2 * cells + inner), 2 * HALF3 * inner),
        "rbgs_sweeps_residual3": (4 * (3 * cells + inner),
                                  (2 * HALF3 + RES3) * inner),
        "residual3": (4 * (reach + inner + cells), RES3 * inner)})
    for name, args in cases.items():
        mod = T3 if name in T3.LAUNCHES else K3
        kern, plain = getattr(mod, name), getattr(mod, name + "_plain")
        times[name] = (cuda_ms(lambda: kern(*args)),
                       cuda_ms(lambda: plain(*args)))
        k, p = times[name]
        bms, by = bound(*work[name])
        print(f"[times] {name:27s} {shape}: kernel {k:.3f} ms, plain {p:.3f} "
              f"ms, bound {bms:.3f} ms ({by})  ({card})")
    from tpu_multigrid_torch.core.operators import Const19Op
    st = Const19Op.STENCIL27
    k19 = cuda_ms(lambda: T3.smooth_restrict3(u, b, n, shape_c, 3, "jacobi",
                                              om3, st))
    bms, by = bound(k1, (3 * JAC19 + JAC19) * inner + FW3 * cinner)
    print(f"[times] smooth_restrict3 19-point     {shape}: kernel {k19:.3f} "
          f"ms, bound {bms:.3f} ms ({by})  ({card})")
    del cases
    # The refinement loop's other steps stay plain torch on both paths (the
    # JAX package has no 3D compensated-residual kernel): one ds residual
    # and one ds_add per refined iteration.
    from tpu_multigrid_torch import precision
    lo = interior_randn3(shape, n, gen, 1e-7)
    for name, fn in (("ds_residual3", lambda: precision.ds_residual(
            b, u, lo, n)), ("ds_add3", lambda: precision.ds_add(u, lo, b))):
        times[name] = cuda_ms(fn)
        print(f"[times] {name:27s} {shape}: plain torch only "
              f"{times[name]:.3f} ms  ({card})")
    del u, b, ec, lo
    torch.cuda.empty_cache()


# Float32 operations per node, counted from vartransfer3d.cu: the diagonal
# (5 adds, 6 with c2), the off-diagonal sum (6 multiplies, 5 adds), 1/diag,
# and a Jacobi step's 5 more; an RB-GS half-step's 2 more on half the nodes;
# the residual's 3 more.
VDIAG3, VOFF3 = 5, 11
VJAC3 = VDIAG3 + VOFF3 + 1 + 5
VHALF3 = (VDIAG3 + VOFF3 + 1 + 2) / 2
VRES3 = VDIAG3 + VOFF3 + 3


def var3_work(shape, shape_c, n, nplanes, sm, s1, s2):
    """(bytes, operations) of K1v_3, K2v_3 and K2v_3-resnorm, by the rows
    8-10 rule: u over its (n+1)^3 reach (in full for RB-GS, which keeps u
    outside the interior; the interior for K2v_3, which masks u + P e_c
    first), b over the interior, each coefficient plane over the reach, e_c
    over (n/2+1)^3, outputs in full."""
    cells = shape[0] * shape[1] * shape[2]
    ccells = shape_c[0] * shape_c[1] * shape_c[2]
    reach, inner = (n + 1) ** 3, (n - 1) ** 3
    creach, cinner = (n // 2 + 1) ** 3, (n // 2 - 1) ** 3
    u1 = cells if sm == "rbgs" else reach
    extra = 1 if nplanes == 4 else 0
    step = ((VJAC3 + extra) if sm == "jacobi" else 2 * (VHALF3 + extra / 2))
    res = VRES3 + extra
    k1 = (4 * (u1 + inner + nplanes * reach + cells + ccells),
          (s1 * step + res) * inner + FW3 * cinner)
    k2b = 4 * (2 * inner + nplanes * reach + creach + cells)
    k2 = (k2b, (PRO3 + s2 * step) * inner)
    k2r = (k2b + 4, (PRO3 + s2 * step + res + 2) * inner)
    return {"var_smooth_restrict3": k1, "var_prolong_smooth3": k2,
            "var_prolong_smooth_resnorm3": k2r}


def var3_times(card, prob, times, work):
    """The 513^3 var V-cycle on both paths over the shared hierarchy, and
    K1v_3 / K2v_3 / K2v_3-resnorm beside their plain versions: at 513^3 on
    the hierarchy's 3 planes (the record's numbers) and on 4 planes
    (Chebyshev (3, 2)), and at 257^3 on 6 seeded planes (RB-GS (2, 2), the
    convection schedule)."""
    import tpu_multigrid_torch as tmg
    from tpu_multigrid_torch.core import ops
    from tpu_multigrid_torch.kernels import vartransfer3d as VT3
    hier = prob.hierarchy
    b = prob.rhs()
    u = torch.zeros_like(b)
    dof = (2 ** VAR3_LEVEL - 1) ** 3
    for use in (True, False):
        cfg = var3_config(use)
        ms = cuda_ms(lambda: tmg.cycle(hier, cfg, u, b))
        times["var3_vcycle" if use else "var3_vcycle_plain"] = ms
        print(f"[times] var V-cycle at {2 ** VAR3_LEVEL + 1}^3, Chebyshev "
              f"(3, 2), {'kernels' if use else 'plain  '}: {ms:.3f} ms, "
              f"{dof / (ms * 1e-3):.4g} DOF/s  ({card})")
    del b, u
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(11)
    om3, om2 = ops.chebyshev_omegas(3, 0.4), ops.chebyshev_omegas(2, 0.4)
    cases = [(PAIRS3[0], 3, "jacobi", om3, 3, om2, 2),
             (PAIRS3[0], 4, "jacobi", om3, 3, om2, 2),
             (PAIRS3[1], 6, "rbgs", 1.0, 2, 1.0, 2)]
    for (shape, shape_c, n), nplanes, sm, o1, s1, o2, s2 in cases:
        u, b = interior_randn3(shape, n, gen), interior_randn3(shape, n, gen)
        ec = interior_randn3(shape_c, n // 2, gen)
        coef = (hier.levels[0].coef_stack if nplanes == 3
                else seeded_planes3(nplanes, shape, gen))
        k2 = (u, b, ec, coef, n, s2, sm, o2)
        fns = {
            "var_smooth_restrict3": (
                lambda: VT3.var_smooth_restrict3(u, b, coef, n, shape_c, s1,
                                                 sm, o1),
                lambda: VT3.var_smooth_restrict3_plain(u, b, coef, n,
                                                       shape_c, s1, sm, o1)),
            "var_prolong_smooth3": (
                lambda: VT3.var_prolong_smooth3(*k2),
                lambda: VT3.var_prolong_smooth3_plain(*k2)),
            "var_prolong_smooth_resnorm3": (
                lambda: VT3.var_prolong_smooth_resnorm3(*k2),
                lambda: VT3.var_prolong_smooth_resnorm3_plain(*k2))}
        wk = var3_work(shape, shape_c, n, nplanes, sm, s1, s2)
        for name, (kern, plain) in fns.items():
            kp = (cuda_ms(kern), cuda_ms(plain))
            bms, by = bound(*wk[name])
            if nplanes == 3:
                times[name], work[name] = kp, wk[name]
            print(f"[times] {name:27s} {shape} {nplanes} planes, "
                  f"{'Chebyshev' if sm == 'jacobi' else 'RB-GS'} "
                  f"({s1}, {s2}): kernel {kp[0]:.3f} ms, plain {kp[1]:.3f} "
                  f"ms, bound {bms:.3f} ms ({by})  ({card})")
        del u, b, ec, coef, fns, k2
        torch.cuda.empty_cache()


def bound(nbytes, flops):
    """(ms, "bytes" or "operations"): the least time the card could take to
    move ``nbytes`` and do ``flops`` float32 operations, at its peaks."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# Float32 operations per node, counted from the kernels' sources: a Jacobi
# step of the 5-point stencil (4 adds, 3 multiplies), an RB-GS half-step on
# the half of the nodes it updates (5 each), the residual (6); the same for
# the 9-point var stencil (Jacobi 21, half-step 18 on half the nodes,
# residual 19, 1/diag 1); full weighting per coarse node (12); bilinear
# prolongation plus the add per fine node (3, 8 with TwoSums); the ds / ts
# residuals (64 / 115, TwoSum = 6).
JAC, HALF, RES = 7, 2.5, 6
VJAC, VHALF, VRES, VINV = 21, 9, 19, 1
FW, PRO, PRO_COMP, DS, TS = 12, 3, 8, 64, 115


def cells2(S, Sc, n):
    """Node counts of a 2D level pair: the padded fine and coarse arrays,
    the fine (n+1)^2 reach and (n-1)^2 interior, the coarse reach and
    interior."""
    return (S * S, Sc * Sc, (n + 1) ** 2, (n - 1) ** 2, (n // 2 + 1) ** 2,
            (n // 2 - 1) ** 2)


def phase_times(card, prob_var, prob_var3):
    import tpu_multigrid_torch as tmg
    from tpu_multigrid_torch import precision
    from tpu_multigrid_torch.core import ops
    from tpu_multigrid_torch.kernels import compres, transfer

    times, work, library = {}, {}, {}
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
    # The bytes each function needs, by the rule of the 3D rows: u over the
    # (n+1)^2 nodes the interior's stencils reach (in full for RB-GS, which
    # keeps u outside the interior; the interior for K2 and prolong_add,
    # which mask u + P e_c first), b over the interior, e_c over the
    # (n/2+1)^2 coarse nodes P reads, every output in full (padded).  The
    # operations count the interior nodes.
    N, Nc, reach, inner, creach, cinner = cells2(S, Sc, n)
    work.update({
        "smooth_restrict": (4 * (reach + inner + N + Nc),
                            (3 * JAC + RES) * inner + FW * cinner),
        "prolong_smooth": (4 * (2 * inner + creach + N),
                           (PRO + 2 * JAC) * inner),
        "prolong_smooth_resnorm": (4 * (2 * inner + creach + N) + 4,
                                   (PRO + 2 * JAC + RES + 2) * inner),
        "ds_residual": (4 * (inner + 2 * reach + N), DS * inner),
        "ts_residual": (4 * (inner + 3 * reach + N), TS * inner)})
    for name, (kern, plain) in cases.items():
        times[name] = (cuda_ms(kern), cuda_ms(plain))
        k, p = times[name]
        bms, by = bound(*work[name])
        print(f"[times] {name:23s} S={S}: kernel {k:.3f} ms, plain {p:.3f} ms"
              f", bound {bms:.3f} ms ({by})  ({card})")
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
    N, Nc, reach, inner, creach, cinner = cells2(S, Sc, n)
    work.update({
        "jacobi_sweeps_residual": (4 * (reach + inner + 2 * N),
                                   (3 * JAC + RES) * inner),
        "jacobi_sweeps": (4 * (reach + inner + N), 2 * JAC * inner),
        "rbgs_sweeps_residual": (4 * (inner + 3 * N),
                                 (4 * HALF + RES) * inner),
        "rbgs_sweeps": (4 * (inner + 2 * N), 4 * HALF * inner),
        "residual": (4 * (reach + inner + N), RES * inner),
        "restrict_fw": (4 * (inner + Nc), FW * cinner),
        "prolong_add": (4 * (inner + creach + N), PRO * inner),
        "prolong_comp": (4 * (creach + 2 * N), PRO_COMP * inner)})
    for name, (kern, plain) in cases.items():
        times[name] = (cuda_ms(kern), cuda_ms(plain))
        k, p = times[name]
        bms, by = bound(*work[name])
        print(f"[times] {name:23s} S={S}: kernel {k:.3f} ms, plain {p:.3f} ms"
              f", bound {bms:.3f} ms ({by})  ({card})")
    # One PyTorch call computing the same function: full weighting is a
    # stride-2 convolution with the 3x3 FW stencil (the kernel also masks
    # the coarse boundary).  Bilinear prolongation is a stride-2 transposed
    # convolution, but without prolong_add's add of u: printed beside it,
    # not a library time of that kernel.
    import torch.nn.functional as F
    w1 = torch.tensor([0.5, 1.0, 0.5], device=DEVICE)
    fw = torch.outer(w1, w1)[None, None]
    r4, e4 = b[None, None], ec[None, None]
    library["restrict_fw"] = cuda_ms(
        lambda: F.conv2d(r4, fw, stride=2, padding=1))
    ct_ms = cuda_ms(lambda: F.conv_transpose2d(e4, fw, stride=2, padding=1))
    print(f"[times] library: F.conv2d stride 2 (restriction) "
          f"{library['restrict_fw']:.3f} ms; F.conv_transpose2d stride 2 "
          f"(P ec alone) {ct_ms:.3f} ms  ({card})")
    del r4, e4
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
    var_times(card, prob_var, times, work)
    times3d(card, times, work)
    var3_times(card, prob_var3, times, work)
    return times, work, library


def var_times(card, prob, times, work):
    """The 4097^2 var V-cycle on both paths over the shared hierarchy, and
    each var kernel at its finest pair (flux operator, 5 planes, RB-GS 1)."""
    import tpu_multigrid_torch as tmg
    from tpu_multigrid_torch.kernels import varstencil as V
    from tpu_multigrid_torch.kernels import vartransfer as VT
    hier = prob.hierarchy
    b = prob.rhs()
    u = torch.zeros_like(b)
    dof = (2 ** VAR_LEVEL - 1) ** 2
    for use in (True, False):
        cfg = var_config(use)
        ms = cuda_ms(lambda: tmg.cycle(hier, cfg, u, b))
        times["var_vcycle" if use else "var_vcycle_plain"] = ms
        print(f"[times] var V-cycle at {2 ** VAR_LEVEL + 1}^2, RB-GS (1,1), "
              f"{'kernels' if use else 'plain  '}: {ms:.3f} ms, "
              f"{dof / (ms * 1e-3):.4g} DOF/s  ({card})")
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(5)
    f, g = hier.levels[:2]
    S, Sc, n, coef = f.S, g.S, f.n, f.coef_sym
    u, b = interior_randn(S, n, gen), interior_randn(S, n, gen)
    ec = interior_randn(Sc, n // 2, gen)
    a = (u, b, coef, n, 1, "rbgs")
    k2 = (u, b, ec, coef, n, 1, "rbgs")
    cases = {
        "var_smooth": (lambda: V.var_smooth(*a),
                       lambda: V.var_smooth_plain(*a)),
        "var_smooth_residual": (lambda: V.var_smooth_residual(*a),
                                lambda: V.var_smooth_residual_plain(*a)),
        "var_smooth_restrict_fused": (
            lambda: VT.var_smooth_restrict_fused(u, b, coef, n, Sc, 1, "rbgs"),
            lambda: VT.var_smooth_restrict_plain(u, b, coef, n, Sc, 1,
                                                 "rbgs")),
        "var_prolong_smooth_fused": (
            lambda: VT.var_prolong_smooth_fused(*k2),
            lambda: VT.var_prolong_smooth_plain(*k2)),
        "var_prolong_smooth_resnorm": (
            lambda: VT.var_prolong_smooth_resnorm(*k2),
            lambda: VT.var_prolong_smooth_resnorm_plain(*k2)),
    }
    # By the rule of the 3D rows (phase_times): RB-GS reads u in full, K2v
    # the interior; each coefficient plane over the reach.
    N, Nc, reach, inner, creach, cinner = cells2(S, Sc, n)
    P = coef.shape[0]
    sweep = (VINV + 2 * VHALF) * inner
    k2v = 4 * (2 * inner + P * reach + creach + N)
    work.update({
        "var_smooth": (4 * (inner + P * reach + 2 * N), sweep),
        "var_smooth_residual": (4 * (inner + P * reach + 3 * N),
                                sweep + VRES * inner),
        "var_smooth_restrict_fused": (4 * (inner + P * reach + 2 * N + Nc),
                                      sweep + VRES * inner + FW * cinner),
        "var_prolong_smooth_fused": (k2v, sweep + PRO * inner),
        "var_prolong_smooth_resnorm": (k2v + 4,
                                       sweep + (PRO + VRES + 2) * inner)})
    for name, (kern, plain) in cases.items():
        times[name] = (cuda_ms(kern), cuda_ms(plain))
        k, p = times[name]
        bms, by = bound(*work[name])
        print(f"[times] {name:27s} S={S}: kernel {k:.3f} ms, plain {p:.3f} "
              f"ms, bound {bms:.3f} ms ({by})  ({card})")
    del u, b, ec, cases
    torch.cuda.empty_cache()


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
    prob_var, setup_secs = var_setup()
    phase_var_kernels(errs, prob_var)
    phase_var_slice(prob_var, setup_secs)
    phase_kernels3d(errs)
    record3d = phase_slice3d()
    prob_var3, host3, setup3 = var3_setup()
    phase_var_kernels3d(errs, prob_var3)
    record_var3d = phase_slice_var3(prob_var3, host3, setup3)
    times, work, library = phase_times(card, prob_var, prob_var3)
    launches = {name: sum(c[name] for c in PATH_COUNTS.values())
                for name in REPLACES}
    for name, n in launches.items():
        check(n > 0, f"{name} was launched on none of the paths")
    print(f"[record] summary: {json.dumps(record)}")
    print(f"[refined3d] summary: {json.dumps(record3d)}")
    print(f"[var3d] summary: {json.dumps(record_var3d)}")
    records = []
    for name in REPLACES:
        bms, by = bound(*work[name])
        records.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": times[name][0],
            "plain_ms": times[name][1], "bound_ms": bms, "bound_by": by,
            "library_ms": library.get(name)})
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
