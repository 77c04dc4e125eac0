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
   1e-4), and the ds / ts compensated residuals (ds_residual3,
   ts_residual3) at each smoother shape; then six paths, each with exact
   launch counts (the refined ones with one ds_residual3 an iteration): the
   default
   solve_poisson3d(9) (it stops at the f32 floor) on both paths; the
   refined solve to 1e-8 on both paths (iterations, seconds with set-up,
   peak device memory, an independent float64 residual of u_hi + u_lo);
   RB-GS (1, 1), 3 fixed cycles from a seeded random right-hand side on
   both paths; solve_poisson3d(6, num_cycles=3), whose finest level takes
   the residual kernel; solve_poisson3d(9, order=4) on the 19-point weights
   against the plain path; a refined level-5 solve to 1e-10 against a
   scipy sparse float64 direct solve.
4g. The 3D variable-coefficient slice at 513^3 (solve_diffusion3d, with and
   without a reaction term, and solve_convection_diffusion3d at 257^3):
   K1v_3 / K2v_3 bitwise at the fused pairs, the flux stencil's float64
   residual (ds_residual_var3) bitwise at (528, 528, 640) with and without
   a reaction plane, each path on both routes with exact launch counts,
   level 5 in float64 against scipy.
4h. The 2D anisotropic slice at 4097^2 (benchmarks/bench_families.py's
   rotated anisotropy: 45 degrees, eps_x = 1, eps_y = 0.05, zebra_x (1, 1),
   coarsest level 3, levels padded to 256): the zebra smoother, K1z, K2z
   and K2z-resnorm bitwise against their plain versions at 4352 / 2304,
   2304 / 1280, 1280 / 768 and 256 / 256 on the rotated fine operator, the
   Galerkin levels and a seeded 9-point operator (the norm to 1e-4), and
   the smoother at S = 8448 on the level-13 operator; then, each with exact
   launch counts, solve_anisotropic(12, tol=1e-5) on both paths, 10 cycles
   from a seeded random right-hand side (reduction per cycle < 0.5 on
   both), the zebra_y route (the transposed problem on the zebra_x
   kernels) against the plain zebra_y path, the unfused route (injection
   restriction), and level 6 in float64 against scipy's sparse direct
   solve.
4i. The nonlinear FAS slice (benchmarks/bench_fas.py's Bratu lam = 4 and
   quasilinear a = 1 + 2 u^2, Jacobi (2, 2)): K1f, K2f, K2f-resnorm and
   K1f_3, K2f_3, K2f_3-resnorm, both families, 1-3 sweeps from a seeded u
   (scale 0.1), bitwise against their plain versions (the norm to 1e-4) at
   4352 / 2304, 2304 / 1280, 256 / 256, (528, 528, 640) / (272, 272, 384)
   and (48, 48, 128) / (32, 32, 128); then, each with exact launch counts,
   solve_bratu(12) and solve_quasilinear_diffusion(12) at 4097^2, the 513^3
   solve_bratu(9, ndim=3) and the 257^3 quasilinear solve, each with the
   door's defaults on the kernels and on the plain route (iterations within
   1, seconds with set-up, peak device memory), solve_bratu(12,
   use_fmg=True), solve_nonlinear_poisson(9) with a caller's phi = u^3
   (no kernel launched; refused with use_kernels=True), and level 6 in
   float64 against scipy's sparse Newton solve.
4j. The periodic slice (bc="periodic", the wrap-aware fused tier): K1-local,
   K2-local and K2-local-resnorm bitwise against their plain versions over
   the whole arrays (the resnorm's norm to 1e-4) at every pair the level-13
   solve fuses, (8224, 8704) / (4128, 4608) down to (288, 768) /
   (160, 640), Jacobi 1-3 steps, Chebyshev (3, 2), RB-GS 1 and 6 sweeps,
   at the fused tier's origin (2, 2) with its virtual n and at two shard
   origins with a real n; then, each with exact launch counts,
   solve_poisson(13, bc="periodic") with Chebyshev (3, 2), coarsest level
   5, on both routes, 5 fixed cycles and until tol 1e-6 with the stall rule
   (iterations within 1, the mean-zero gauge to 1e-6); W and F cycles, RB-GS
   (1, 1) and Jacobi (2, 2) at level 12 and an FMG start at level 13 on the
   kernels; 10 seeded random mean-zero right-hand sides at level 12 on both
   routes (the mean reduction per cycle); level 6 in float64 against
   scipy's sparse direct solve; solve_poisson3d(9, bc="periodic") on the
   plain torus operators, and 3D level 5 in float64 against a direct
   Fourier solve.
4k. The distributed fused tier (tpu_multigrid_torch.dist): K0-local
   (Jacobi 2, Chebyshev 2, RB-GS 1, the residual), the ds / ts residual,
   the exact-pair prolongation and the compensated add (ds pair and ts
   triple, one and two addends) bitwise against their plain versions over
   the whole arrays, random ghosts included, at the (1, 1) level-14 finest
   block (17440, 17920) and a 2 x 2 level-13 shard block, four shard
   origins each; then, on a one-rank NCCL group (file:// store), each with
   exact launch counts: the 16385^2 ts refinement (ds_levels 2,
   benchmarks/bench_dist_refined.py's Jacobi (2, 2)) to 1e-8 with its
   float64 residual, seconds with set-up, peak memory and ms per iteration
   (the slope between 2 and 6 iterations); solve_poisson(13, mesh=...,
   dist_path="pallas") against the single-device kernel V-cycle; the
   level-13 ts solve on (1, 1) against a 2 x 2 gloo mesh of four spawned
   ranks sharing the card (strips staged through host memory): the same
   iterations, histories and iterates.
4l. The distributed fused FAS tier (dist.fas_pallas): K1f-local, K2f-local
   and K2f-local-resnorm, Bratu and quadratic, 1-3 sweeps, bitwise against
   their plain versions over the whole arrays (the resnorm's sum to 1e-4),
   random u, b and ec, ghosts included, at the (1, 1) level-12 block and a
   2 x 2 level-12 shard block, four origins each; a caller's own phi and a
   block outside the gate refused on the card.  Then, on a one-rank NCCL
   group, each with exact launch counts: solve_bratu(12, lam=4) and
   solve_quasilinear_diffusion(12, gamma=2) with mesh= and
   dist_path="pallas" (the doors' defaults, Jacobi (2, 2)) beside phase
   4i's single-device kernel route (iterations within 1, or both stalled at
   the f32 floor), seconds with set-up, peak memory, ms per fused FAS
   V-cycle and its replicated tail's share; the same doors at level 13;
   solve_bratu(12) on a 2 x 2 gloo mesh of four spawned ranks sharing the
   card against the (1, 1) run, 4 fixed cycles (histories rtol 1e-4,
   iterates rtol 1e-5, atol 1e-6).
4m. The distributed fused 3D tier (dist.pallas_cycle3): K1_3-ext,
   K2_3-local and K2_3-local-resnorm, and their var forms on 3, 4 and 6
   planes, bitwise against their plain versions over the whole arrays (the
   resnorm's sum to 1e-4), random u, b, ec and coefficients, ghosts
   included, at the (1, 1) level-9 block (576, 576, 640) / (304, 304, 384)
   and a 2 x 2 level-8 shard block (192, 192, 384) / (112, 112, 256), four
   origins, Chebyshev (3, 2), RB-GS (1, 1) and (5, 5) (K1 split into two
   launches); a block outside the gate refused on the card.  Then, on a
   one-rank NCCL group, each with exact launch counts: sharded_solve_pallas3
   and sharded_solve_pallas_var3 (phase 4g's coefficient) at 513^3, the var
   solve with phase 4g's shift at 257^3 and sharded_solve_pallas_conv3 with
   phase 4g's winds at 257^3, each until tol 1e-5 beside the single-device
   kernel route (iterations within 1; seconds with set-up, host build
   seconds, peak memory) and 2 fixed cycles on the same build (u within
   1e-4 of max|u| of the single-device route's solve_fixed); ms per fused
   3D V-cycle at 513^3 beside the single-device kernel V-cycle, and its
   replicated tail's share; Poisson at level 8 on a 2 x 2 gloo mesh of four
   spawned ranks sharing the card against the (1, 1) run, 4 fixed cycles
   (histories rtol 1e-4, iterates rtol 1e-5, atol 1e-6).
5. Times: ms per V-cycle and DOF/s at 8193^2, at 4097^2 (var, anisotropic,
   FAS Bratu and quasilinear), at 513^3 (3D, 3D var, FAS Bratu) and the
   periodic 8192^2 torus on both paths, one ts iteration at 16385^2 on both
   paths, and each kernel beside its plain version (K1/K2/ds/ts at
   S = 8448, the var, zebra and FAS kernels at 4352, the 3D ones at (528,
   528, 640), K1-local and K2-local at (8224, 8704), the distributed
   refinement's at (17440, 17920), K1f-local and K2f-local at (4384,
   4864), the 3D extended-block kernels at (576, 576, 640), the others at
   16640),
   with CUDA events (median of 7 after warm-up), and the one PyTorch call
   that computes the same function where there is one; the refinement
   loop's iterate update (a ds pair plus one addend on comp_add_ext, as
   precision._accumulate runs it) at S = 8448 and (528, 528, 640),
   bitwise against the plain ds_add chain and timed beside it with its
   byte bound.

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
import math
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
_Z = "tpu_multigrid/kernels/lines.py"
_F = "tpu_multigrid/kernels/fas.py"
_F3 = "tpu_multigrid/kernels/fas3d.py"
_L = "tpu_multigrid/kernels/local.py"
_LR = "tpu_multigrid/kernels/localref.py"
_LF = "tpu_multigrid/kernels/localfas.py"
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
    "zebra_sweeps": f"{_Z}:177",
    "zebra_smooth_restrict": f"{_Z}:379",
    "prolong_zebra_smooth": f"{_Z}:506",
    "prolong_zebra_smooth_resnorm": f"{_Z}:506",
    "fas_smooth_restrict": f"{_F}:173",
    "fas_prolong_smooth": f"{_F}:331",
    "fas_prolong_smooth_resnorm": f"{_F}:331",
    "qfas_smooth_restrict": f"{_F}:173",
    "qfas_prolong_smooth": f"{_F}:331",
    "qfas_prolong_smooth_resnorm": f"{_F}:331",
    "fas_smooth_restrict3": f"{_F3}:161",
    "fas_prolong_smooth3": f"{_F3}:338",
    "fas_prolong_smooth_resnorm3": f"{_F3}:338",
    "qfas_smooth_restrict3": f"{_F3}:161",
    "qfas_prolong_smooth3": f"{_F3}:338",
    "qfas_prolong_smooth_resnorm3": f"{_F3}:338",
    "smooth_restrict_ext": f"{_L}:216",
    "prolong_smooth_ext": f"{_L}:341",
    "prolong_smooth_ext_resnorm": f"{_L}:341",
    "smooth_ext": f"{_L}:101",
    "ds_residual_ext": f"{_LR}:74",
    "ts_residual_ext": f"{_LR}:74",
    "prolong_pair_ext": f"{_LR}:183",
    "comp_add_ext": f"{_LR}:320",
    "fas_smooth_restrict_ext": f"{_LF}:52",
    "fas_prolong_smooth_ext": f"{_LF}:182",
    "fas_prolong_smooth_ext_resnorm": f"{_LF}:182",
    "qfas_smooth_restrict_ext": f"{_LF}:52",
    "qfas_prolong_smooth_ext": f"{_LF}:182",
    "qfas_prolong_smooth_ext_resnorm": f"{_LF}:182",
    "smooth_restrict_ext3": f"{_T3}:279",
    "prolong_smooth_ext3": f"{_T3}:770",
    "prolong_smooth_ext3_resnorm": f"{_T3}:770",
    "var_smooth_restrict_ext3": f"{_VT3}:214",
    "var_prolong_smooth_ext3": f"{_VT3}:596",
    "var_prolong_smooth_ext3_resnorm": f"{_VT3}:596",
}
_CSRC = "tpu_multigrid_torch/kernels/csrc/"
SOURCES = {name: _CSRC + ("compres.cu" if name in ("ds_residual",
                                                   "ts_residual")
                          else "localref.cu" if REPLACES[name].startswith(
                              _LR)
                          else "localfas.cu" if REPLACES[name].startswith(
                              _LF)
                          else "local.cu" if REPLACES[name].startswith(_L)
                          else "fas3d.cu" if REPLACES[name].startswith(_F3)
                          else "fas.cu" if REPLACES[name].startswith(_F)
                          else "lines.cu" if REPLACES[name].startswith(_Z)
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
    difference seen.  Returns the relative difference (a zero sum, of a
    block that owns no live cell, must come out zero)."""
    diff = abs(float(got) - float(want))
    rel = diff / float(want) if float(want) else (diff and float("inf"))
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
                   ds_residual=it, comp_add_ext=it)
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
                  comp_add_ext=(1 + 2 * ds) * it,
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
                  prolong_smooth=cycle_pairs + nl * it, ds_residual=it + 1,
                  comp_add_ext=it)
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
    alone) and the ds / ts compensated residuals at each shape of
    ``SMOOTH3``, and K1_3 / K2_3 / K2_3-resnorm on
    the 7-point stencil and the 19-point weights at each pair of ``PAIRS3``,
    bitwise; the norm to 1e-4."""
    from tpu_multigrid_torch import precision
    from tpu_multigrid_torch.core import ops
    from tpu_multigrid_torch.core.operators import Const19Op
    from tpu_multigrid_torch.kernels import compres
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
        # The compensated residuals (u_mid ~1e-8, u_lo ~1e-16, b ~h^2).
        bh = interior_randn3(shape, n, gen, 1.0 / n ** 2)
        um = interior_randn3(shape, n, gen, 1e-8)
        ul = interior_randn3(shape, n, gen, 1e-16)
        track(errs, "ds_residual3", compres.ds_residual3(bh, u, um, n),
              precision.ds_residual(bh, u, um, n))
        track(errs, "ts_residual3", compres.ts_residual3(bh, u, um, ul, n),
              precision.ts_residual(bh, u, um, ul, n))
        print(f"[kernels3d] {shape} n={n}: ds_residual3, ts_residual3 "
              f"bitwise equal")
        del u, b, bh, um, ul
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
    want = dict(counts3(it, resnorm=False), ds_residual3=it,
                comp_add_ext=it)
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
    want = dict(counts3(out5[3], fused=0, unfused=2, resnorm=False),
                ds_residual3=out5[3], comp_add_ext=out5[3])
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
        smooth_restrict3=3 * len(transfer3d.k1_launches(lib, 10, (1.0,))),
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
    host part of a front door's set-up), and keeps the last one's result."""

    def __init__(self, module, name):
        import importlib
        self.module = importlib.import_module(module)
        self.name, self.seconds, self.result = name, 0.0, None

    def __enter__(self):
        fn = self.fn = getattr(self.module, self.name)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                self.result = fn(*a, **kw)
                return self.result
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


def var_residual3_inputs(prob, gen, c2):
    """The float64 var residual's inputs at the finest level of ``prob``:
    its operator (with a seeded reaction plane when ``c2``), b ~h^2,
    u_hi ~1 and u_lo within half an ulp of it on the interior."""
    from tpu_multigrid_torch.core.operators import VarStencilOp3D
    op = prob.hierarchy.levels[0]
    shape, n = op.grid_shape, op.n
    if c2:
        op = VarStencilOp3D(op.tz, op.ty, op.tx, op.inv_diag, n, op.S,
                            op.Sx, c2=seeded_planes3(1, shape, gen)[0])
    u_hi = interior_randn3(shape, n, gen)
    ulp = torch.nextafter(u_hi.abs(), torch.full_like(u_hi, np.inf)) \
        - u_hi.abs()
    u_lo = (torch.rand(shape, generator=gen, device=DEVICE) - 0.5) * ulp
    return op, interior_randn3(shape, n, gen, 1.0 / n ** 2), u_hi, u_lo


def phase_var_residual3(prob):
    """The flux stencil's float64 residual (ds_residual_var3, a kernel that
    replaces no TPU kernel: the JAX package evaluates it in jnp) against
    its plain z-slab body at the finest level, bitwise, with and without a
    reaction plane."""
    from tpu_multigrid_torch import precision
    from tpu_multigrid_torch.kernels import compres
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(10)
    for c2 in (False, True):
        op, b, u_hi, u_lo = var_residual3_inputs(prob, gen, c2)
        got = compres.ds_residual_var3(op, b, u_hi, u_lo)
        want = precision.ds_residual_var3_plain(op, b, u_hi, u_lo)
        err = float((got.double() - want.double()).abs().max())
        check(torch.equal(got, want), f"ds_residual_var3 differs from its "
              f"plain version: max err {err}")
        print(f"[var-kernels3d] {op.grid_shape} n={op.n}: ds_residual_var3 "
              f"{'with' if c2 else 'without'} a reaction plane bitwise "
              f"equal")
        del op, b, u_hi, u_lo, got, want
    torch.cuda.empty_cache()


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


def run_line(label, res, secs, host, peak, tag="var3d"):
    print(f"[{tag}] {label}: {var_state(res)} after {res.iterations} "
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


# ---------------------------------------------------------------------------
# 4h. The 2D anisotropic slice
# ---------------------------------------------------------------------------

ANISO_LEVEL = 12
ANISO_TOL = 1e-5
ANISO_ANGLE = float(np.radians(45.0))
ANISO_EPS = dict(eps_x=1.0, eps_y=0.05)
# Launches per cycle at 4097^2: 8 fused pairs (K1z and K2z, 3 launches
# each; the finest K2z-resnorm 5), and 512 -> 256 (Sc < S/2 + 128) unfused.
ANISO_PER_CYCLE = dict(zebra_smooth_restrict=24, prolong_zebra_smooth=21,
                       prolong_zebra_smooth_resnorm=5, zebra_sweeps=4,
                       restrict_fw=1, prolong_add=1)
# (n, S) of the level-13 operator the zebra smoother is checked on alone.
ZEBRA13 = (2 ** 13, 8448)
# The zebra_y routes' solutions at 4097^2 differ by the float32 floor of
# the h^2-scaled right-hand side (a few 1e-4 of max |u|); a wrong
# transposition would differ by O(1).
ZEBRA_Y_DU = 2e-3


def aniso_config(use_kernels, level=None, **kw):
    """benchmarks/bench_families.py's rotated-anisotropy schedule: zebra_x
    (1, 1), coarsest level 3 (a dense coarse inverse at 9^2), at
    ``ANISO_LEVEL`` unless another level is given."""
    import tpu_multigrid_torch as tmg
    fields = dict(finest_level=ANISO_LEVEL if level is None else level,
                  coarsest_level=3, nu1=1, nu2=1, smoother="zebra_x",
                  use_kernels=use_kernels)
    fields.update(kw)
    return tmg.MultigridConfig(**fields)


def aniso_forcing(x, y):
    """A forcing that is not symmetric in (x, y), so that the zebra_y
    route's transposition shows."""
    return 4.0 + 3.0 * x - y * y


def aniso_host_setup():
    return HostSetup("tpu_multigrid_torch.problems.anisotropic",
                     "build_anisotropic_hierarchy")


def aniso_setup():
    """The 4097^2 rotated-anisotropy hierarchy (Galerkin coarse operators,
    levels padded to 256), built once on the host and uploaded; shared by
    the kernel checks, the plain path, the fixed cycles and the times.
    (problem, host seconds, seconds with the upload)."""
    import tpu_multigrid_torch as tmg
    with aniso_host_setup() as host:
        t0 = time.perf_counter()
        prob = tmg.AnisotropicPoissonProblem(
            aniso_config(True), **ANISO_EPS, angle=ANISO_ANGLE, device=DEVICE,
            align=256, min_pad_level=0)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    print(f"[aniso] set-up of the {2 ** ANISO_LEVEL + 1}^2 hierarchy: host "
          f"build {host.seconds:.3f} s, with the upload {secs:.3f} s; levels "
          f"(n, S) {[(op.n, op.S) for op in prob.hierarchy.levels]}")
    return prob, host.seconds, secs


def zebra_planes(op):
    """The zebra kernels' (9, S, S) view of a 9-point operator."""
    return op.coef.reshape(9, op.S, op.S)


def seeded_zebra_planes(S, n, gen):
    """(9, S, S) planes of a nonsymmetric 9-point operator from a seed:
    off-diagonals in (-1.25, -0.25], the centre (plane 4) in [8, 9), zero
    outside the interior.  Every line's tridiagonal system is diagonally
    dominant (PCR does not pivot)."""
    from tpu_multigrid_torch.core import ops
    c = -0.25 - torch.rand((9, S, S), generator=gen, device=DEVICE)
    c[4] = 8.0 + torch.rand((S, S), generator=gen, device=DEVICE)
    return torch.where(ops.interior_mask(S, n, c.device), c, 0.0)


def check_zebra(errs, coef, S, Sc, n, gen):
    """The zebra smoother, K1z, K2z and K2z-resnorm on ``coef``, 1 and 2
    sweeps, against their plain versions: bitwise, the norm to 1e-4.
    Returns the largest relative norm difference."""
    from tpu_multigrid_torch.kernels import lines as Z
    u, b = interior_randn(S, n, gen), interior_randn(S, n, gen)
    ec = interior_randn(Sc, n // 2, gen)
    rels = []
    for sweeps in (1, 2):
        track(errs, "zebra_sweeps", Z.zebra_sweeps(u, b, coef, n, sweeps),
              Z.zebra_sweeps_plain(u, b, coef, n, sweeps))
        for got, want in zip(
                Z.zebra_smooth_restrict(u, b, coef, n, Sc, sweeps),
                Z.zebra_smooth_restrict_plain(u, b, coef, n, Sc, sweeps)):
            track(errs, "zebra_smooth_restrict", got, want)
        a = (u, b, ec, coef, n, sweeps)
        track(errs, "prolong_zebra_smooth", Z.prolong_zebra_smooth(*a),
              Z.prolong_zebra_smooth_plain(*a))
        ku, knorm = Z.prolong_zebra_smooth_resnorm(*a)
        pu, pnorm = Z.prolong_zebra_smooth_resnorm_plain(*a)
        track(errs, "prolong_zebra_smooth_resnorm", ku, pu)
        rels.append(track_norm(errs, "prolong_zebra_smooth_resnorm", knorm,
                               pnorm))
    return max(rels)


def phase_aniso_kernels(errs, prob):
    """The zebra kernels against their plain versions at the finest pair
    (4352 / 2304) on the rotated fine operator and on a seeded 9-point one,
    at 2304 / 1280 and 1280 / 768 on the Galerkin levels 11 and 10, at the
    bottom pair (256 / 256) on the Galerkin level 7 and a seeded operator;
    then the smoother at S = 8448 on the closed-form level-13 operator."""
    from tpu_multigrid_torch.kernels import lines as Z
    from tpu_multigrid_torch.problems import anisotropic
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(11)
    lv = prob.hierarchy.levels
    cases = [("rotated-12", lv[0], lv[1], False),
             ("nonsym-9", lv[0], lv[1], True),
             ("galerkin-11", lv[1], lv[2], False),
             ("galerkin-10", lv[2], lv[3], False),
             ("galerkin-7", lv[-5], lv[-4], False),
             ("nonsym-9", lv[-5], lv[-4], True)]
    for label, op, opc, seeded in cases:
        coef = (seeded_zebra_planes(op.S, op.n, gen) if seeded
                else zebra_planes(op))
        rel = check_zebra(errs, coef, op.S, opc.S, op.n, gen)
        print(f"[aniso-kernels] {label:11s} S={op.S:5d} Sc={opc.S:5d} "
              f"n={op.n:5d}, 1 and 2 sweeps: zebra smoother, K1z, K2z, "
              f"K2z-resnorm bitwise equal; resnorm norm rel {rel:.3g}")
        del coef
    torch.cuda.empty_cache()
    n, S = ZEBRA13
    check(Z.supported_zebra(S, 1, torch.float32),
          f"the zebra smoother's gate refuses S = {S}")
    t0 = time.perf_counter()
    op13 = anisotropic.anisotropic_poisson_op(n, S, **ANISO_EPS,
                                              angle=ANISO_ANGLE)
    coef = torch.from_numpy(op13.coef).to(DEVICE).reshape(9, S, S)
    host = time.perf_counter() - t0
    del op13
    u, b = interior_randn(S, n, gen), interior_randn(S, n, gen)
    track(errs, "zebra_sweeps", Z.zebra_sweeps(u, b, coef, n, 1),
          Z.zebra_sweeps_plain(u, b, coef, n, 1))
    print(f"[aniso-kernels] level-13 operator S={S} n={n} (built and "
          f"uploaded in {host:.3f} s), 1 sweep: zebra smoother bitwise equal")
    del u, b, coef
    torch.cuda.empty_cache()
    torch.cuda.synchronize()


def aniso_counts(hier, cycles, injection=False):
    """Launches of ``cycles`` zebra (1, 1) cycles over ``hier``: K1z and K2z
    on each pair the fused gate takes (K2z-resnorm on the finest), else the
    zebra smoother before and after, the full-weighting restriction kernel
    and the prolong-add kernel.  With injection restriction every pair runs
    unfused and restricts in plain torch."""
    from tpu_multigrid_torch.kernels import lines as Z
    want = {}

    def add(name, k):
        want[name] = want.get(name, 0) + cycles * k
    for k, (op, opc) in enumerate(zip(hier.levels, hier.levels[1:])):
        if not injection and Z.supported_zebra_fused(op.S, opc.S, 1,
                                                     torch.float32):
            add("zebra_smooth_restrict", Z.launches("zebra_smooth_restrict",
                                                    1))
            k2 = ("prolong_zebra_smooth_resnorm" if k == 0
                  else "prolong_zebra_smooth")
            add(k2, Z.launches(k2, 1))
        else:
            add("zebra_sweeps", 2 * Z.launches("zebra_sweeps", 1))
            if not injection:
                add("restrict_fw", 1)
            add("prolong_add", 1)
    return expect(**want)


def nine_point_matrix(op):
    """The interior matrix of a float64 9-point operator on the card
    (``coef[di + 1, dj + 1]`` couples u[i + di, j + dj]), as a scipy CSC
    matrix in row-major interior order."""
    import scipy.sparse as sp
    n, m = op.n, op.n - 1
    coef = op.coef.cpu().numpy()[:, :, 1:n, 1:n]
    idx = np.arange(m * m).reshape(m, m)
    rows, cols, vals = [], [], []
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            src = (slice(max(0, -di), m - max(0, di)),
                   slice(max(0, -dj), m - max(0, dj)))
            dst = (slice(max(0, di), m + min(0, di)),
                   slice(max(0, dj), m + min(0, dj)))
            rows.append(idx[src].ravel())
            cols.append(idx[dst].ravel())
            vals.append(coef[di + 1, dj + 1][src].ravel())
    return sp.csc_matrix((np.concatenate(vals),
                          (np.concatenate(rows), np.concatenate(cols))),
                         shape=(m * m, m * m))


def phase_aniso_slice(prob, host_secs, setup_secs):
    """The 2D anisotropic slice, each path with launch counts set to 0 just
    before it and checked exactly after."""
    import scipy.sparse.linalg as spl

    import tpu_multigrid_torch as tmg
    from tpu_multigrid_torch import kernels
    hier = prob.hierarchy
    n12 = 2 ** ANISO_LEVEL
    summary = {}
    per_cycle = expect(**ANISO_PER_CYCLE)
    check(aniso_counts(hier, 1) == per_cycle,
          f"launches per cycle {aniso_counts(hier, 1)}, expected {per_cycle}")

    def door(path, cfg, **kw):
        return front_door3(path, lambda: tmg.solve_anisotropic(
            ANISO_LEVEL, angle=ANISO_ANGLE, coarsening="full", config=cfg,
            device=DEVICE, **kw), aniso_host_setup())

    # 1. The front door to tol on the kernels (its own set-up), and the plain
    # path over the shared hierarchy.
    res, secs, host, peak = door("aniso-12", aniso_config(True), **ANISO_EPS,
                                 tol=ANISO_TOL)
    it = res.iterations
    got = PATH_COUNTS["aniso-12"]
    check(got == aniso_counts(hier, it), f"solve_anisotropic({ANISO_LEVEL}) "
          f"launches {got}, expected {aniso_counts(hier, it)}")
    check(tuple(res.u.shape) == (hier.levels[0].S,) * 2
          and bool(torch.isfinite(res.u).all())
          and (res.converged or res.stalled),
          f"solve_anisotropic: shape {tuple(res.u.shape)}, {var_state(res)}")
    summary["kernels"] = run_line(
        f"solve_anisotropic({ANISO_LEVEL}, 45 degrees, eps 1 / 0.05, "
        f"tol={ANISO_TOL:g}), kernels", res, secs, host, peak, tag="aniso")
    print(f"[aniso] launches {nonzero(got)}")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rp = tmg.solve_until_tol(hier, aniso_config(False), prob.rhs(),
                             tol=ANISO_TOL)
    torch.cuda.synchronize()
    secs_p = time.perf_counter() - t0
    check(set(kernels.launch_counts().values()) == {0},
          "the plain anisotropic path launched kernels")
    summary["plain"] = run_line(
        "plain path on the shared hierarchy (set-up: the shared build, "
        "peak: the solve alone)", rp, setup_secs + secs_p, host_secs,
        torch.cuda.max_memory_allocated() - base, tag="aniso")
    check(abs(rp.iterations - it) <= 1 and (rp.converged or rp.stalled)
          and float(rp.res_history[0]) == float(res.res_history[0]),
          f"plain anisotropic path: {var_state(rp)} in {rp.iterations}, "
          f"kernels {it}")
    du = float((res.u - rp.u).abs().max()) / float(rp.u.abs().max())
    print(f"[aniso] max |u_kernels - u_plain| / max|u_plain| = {du:.3e}")
    del res, rp
    torch.cuda.empty_cache()

    # 2. 10 fixed cycles from a seeded random right-hand side: the mean
    # reduction per cycle, (r_10 / r_0)^(1/10), is below 0.5 on both paths
    # (the bound of the JAX package's test_45deg_usable_rate).
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(12)
    br = interior_randn(hier.levels[0].S, n12, gen)
    fk = drive("aniso-12-fixed", lambda: tmg.solve_fixed(
        hier, aniso_config(True), br, 10))
    got = PATH_COUNTS["aniso-12-fixed"]
    check(got == aniso_counts(hier, 10), f"fixed-cycle anisotropic launches "
          f"{got}, expected {aniso_counts(hier, 10)}")
    fp = tmg.solve_fixed(hier, aniso_config(False), br, 10)
    hk, hp = fk.res_history.numpy(), fp.res_history.numpy()
    rate_k = float(hk[10] / hk[0]) ** 0.1
    rate_p = float(hp[10] / hp[0]) ** 0.1
    print(f"[aniso] 10 fixed cycles, random rhs: kernels {hist_str(fk)}; "
          f"plain {hist_str(fp)}; mean reduction per cycle: kernels "
          f"{rate_k:.4f}, plain {rate_p:.4f}")
    check(np.allclose(hk[:4], hp[:4], rtol=1e-3, atol=0)
          and rate_k < 0.5 and rate_p < 0.5,
          "random-rhs anisotropic histories differ beyond rtol 1e-3, or a "
          "path reduces by 0.5 or more per cycle")
    summary["random_rhs_rate"] = {"kernels": rate_k, "plain": rate_p}

    # 3. The unfused route: injection restriction, 2 cycles, where the zebra
    # smoother kernel and the prolong-add kernel run on every pair.
    inj = aniso_config(True, restriction="injection")
    ri = drive("aniso-12-injection", lambda: tmg.solve_fixed(hier, inj, br,
                                                             2))
    got = PATH_COUNTS["aniso-12-injection"]
    want = aniso_counts(hier, 2, injection=True)
    pairs = len(hier.levels) - 1
    check(got == want and want["zebra_sweeps"] == 2 * pairs * 4
          and want["prolong_add"] == 2 * pairs,
          f"injection launches {got}, expected {want}")
    rip = tmg.solve_fixed(hier, dataclasses.replace(inj, use_kernels=False),
                          br, 2)
    hk, hp = ri.res_history.numpy(), rip.res_history.numpy()
    print(f"[aniso] injection, 2 cycles: kernels {hist_str(ri)}, plain "
          f"{hist_str(rip)}; launches {nonzero(got)}")
    check(np.allclose(hk, hp, rtol=1e-3, atol=0) and np.isfinite(hk).all(),
          "injection: histories differ beyond rtol 1e-3 or are not finite")
    del fk, fp, ri, rip, br
    torch.cuda.empty_cache()

    # 4. The zebra_y route: strong coupling in y; with the kernels the door
    # solves the transposed problem on the zebra_x kernels and transposes
    # back, the plain path runs zebra_y itself.  Each with its own set-up.
    runs = {}
    for use in (True, False):
        path = "aniso-12-zebra_y" + ("" if use else "-plain")
        runs[use] = door(path, aniso_config(use, smoother="zebra_y"),
                         eps_x=0.05, eps_y=1.0, forcing=aniso_forcing,
                         tol=ANISO_TOL)
        r = runs[use][0]
        got = PATH_COUNTS[path]
        want = aniso_counts(hier, r.iterations) if use else expect()
        check(got == want, f"{path} launches {got}, expected {want}")
        check(bool(torch.isfinite(r.u).all()) and (r.converged or r.stalled),
              f"{path}: {var_state(r)}")
        route = "kernels (transposed)" if use else "plain"
        summary["zebra_y_" + ("kernels" if use else "plain")] = run_line(
            f"zebra_y, eps 0.05 / 1, {route}", *runs[use], tag="aniso")
    rk, rp = runs[True][0], runs[False][0]
    uk = tmg.extract_solution(rk.u, n12)
    up = tmg.extract_solution(rp.u, n12)
    du = float((uk - up).abs().max()) / float(up.abs().max())
    print(f"[aniso] zebra_y: max |u_kernels - u_plain| / max|u_plain| = "
          f"{du:.3e}")
    check(abs(rk.iterations - rp.iterations) <= 1 and du <= ZEBRA_Y_DU,
          f"zebra_y routes: iterations {rk.iterations} / {rp.iterations}, "
          f"solutions differ by {du:.3e}")
    del runs, rk, rp, uk, up
    torch.cuda.empty_cache()

    # 5. Level 6 in float64 (no kernel takes f64; a smoothed coarsest level,
    # as the coarse inverse is kept in float32) against scipy's sparse
    # direct solve of the same 9-point system.
    c6 = aniso_config(False, 6, dtype=torch.float64, coarse_solver="smooth",
                      coarse_smooth_sweeps=4)
    run6 = front_door3("aniso-6-f64", lambda: tmg.solve_anisotropic(
        6, **ANISO_EPS, angle=ANISO_ANGLE, coarsening="full", config=c6,
        tol=1e-10, device=DEVICE), aniso_host_setup())
    r6 = run6[0]
    check(PATH_COUNTS["aniso-6-f64"] == expect(),
          "the float64 level-6 solve launched kernels")
    summary["level6_f64"] = run_line("level 6, float64, tol 1e-10", *run6,
                                      tag="aniso")
    p6 = tmg.AnisotropicPoissonProblem(c6, **ANISO_EPS, angle=ANISO_ANGLE,
                                       device=DEVICE)
    inner = (slice(1, 64),) * 2
    ref = spl.spsolve(nine_point_matrix(p6.finest),
                      p6.rhs()[inner].cpu().reshape(-1).numpy())
    err = float(np.abs(r6.u[inner].cpu().reshape(-1).numpy() - ref).max()
                / np.abs(ref).max())
    print(f"[aniso] level 6, float64: vs scipy sparse direct solve: rel err "
          f"{err:.3e}")
    check(r6.converged and err <= 1e-8, f"level-6 anisotropic rel err {err}")
    summary["level6_f64_rel_err"] = err
    return summary


# ---------------------------------------------------------------------------
# Phase 4i: the nonlinear FAS slice
# ---------------------------------------------------------------------------

FAS_LEVEL = 12
FAS3_LEVEL = 9
QUASI3_LEVEL = 8
FAS_LAM, FAS_GAMMA = 4.0, 2.0
# (S, Sc, n) of the 2D FAS kernel checks: the two finest pairs of the
# 4097^2 solve (levels padded to 256) and the bottom pair.
FAS_PAIRS = [(4352, 2304, 4096), (2304, 1280, 2048), (256, 256, 64)]
# (shape, coarse shape, n) of the 3D checks: the finest pair of the 513^3
# solve and the smallest 3D layout.
FAS_PAIRS3 = [((528, 528, 640), (272, 272, 384), 512),
              ((48, 48, 128), (32, 32, 128), 32)]
# Fused pairs per cycle with the doors' Jacobi (2, 2): all 9 of the padded
# 4097^2 hierarchy (levels 12 -> 3), 3 of the 513^3 one (9 -> 6; level 6
# is 128 wide), 2 of the 257^3 one.
FAS_PER_CYCLE = {FAS_LEVEL: 9, FAS3_LEVEL: 3, QUASI3_LEVEL: 2}


def fas_nl(family):
    """(entry prefix, nonlinearity arguments) of a family: Bratu with
    lam = 4 (phi passed as phi and dphi), or a = 1 + 2 u^2."""
    import tpu_multigrid_torch as tmg
    if family == "bratu":
        phi = tmg.BratuNonlinearity(FAS_LAM)
        return "fas_", (phi, phi)
    return "qfas_", (tmg.QuadraticCoefficient(FAS_GAMMA),)


def fas_cases(family, suffix, u, b, ec, n, shape_c, sweeps):
    """{entry: (kernel call, plain call)} of a family's three entries."""
    from tpu_multigrid_torch.kernels import fas as KF
    from tpu_multigrid_torch.kernels import fas3d as KF3
    mod = KF3 if suffix else KF
    prefix, nl = fas_nl(family)
    extra = ((1.0 / n) ** 2, 6.0 if suffix else 4.0) if prefix == "fas_" \
        else ()
    args = {"smooth_restrict": (u, b, n, shape_c, sweeps, 2.0 / 3.0),
            "prolong_smooth": (u, b, ec, n, sweeps, 2.0 / 3.0),
            "prolong_smooth_resnorm": (u, b, ec, n, sweeps, 2.0 / 3.0)}
    cases = {}
    for name, a in args.items():
        entry = prefix + name + suffix
        kern, plain = getattr(mod, entry), getattr(mod, entry + "_plain")
        full = a + nl + extra
        cases[entry] = (lambda k=kern, f=full: k(*f),
                        lambda p=plain, f=full: p(*f))
    return cases


def check_fas(errs, cases):
    """Each entry against its plain version: bitwise, the norm to 1e-4.
    Returns the largest relative norm difference."""
    rel = 0.0
    for entry, (kern, plain) in cases.items():
        got, want = kern(), plain()
        if "_resnorm" in entry:
            track(errs, entry, got[0], want[0])
            rel = max(rel, track_norm(errs, entry, got[1], want[1]))
        elif isinstance(got, tuple):
            for g, w in zip(got, want):
                track(errs, entry, g, w)
        else:
            track(errs, entry, got, want)
    return rel


def phase_fas_kernels(errs):
    """K1f, K2f, K2f-resnorm (2D) and K1f_3, K2f_3, K2f_3-resnorm (3D),
    pointwise (Bratu) and quasilinear, 1, 2 and 3 sweeps, from a seeded u
    (scale 0.1) and b, against their plain versions."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(21)
    for S, Sc, n in FAS_PAIRS:
        u, b = interior_randn(S, n, gen, 0.1), interior_randn(S, n, gen)
        ec = interior_randn(Sc, n // 2, gen, 0.05)
        rel = max(check_fas(errs, fas_cases(fam, "", u, b, ec, n, Sc, sw))
                  for fam in ("bratu", "quadratic") for sw in (1, 2, 3))
        print(f"[fas-kernels] S={S:5d} Sc={Sc:5d} n={n:5d}, Bratu and "
              f"quadratic, 1-3 sweeps: K1f, K2f, K2f-resnorm bitwise equal; "
              f"resnorm norm rel {rel:.3g}")
        del u, b, ec
    for shape, shape_c, n in FAS_PAIRS3:
        u = interior_randn3(shape, n, gen, 0.1)
        b = interior_randn3(shape, n, gen)
        ec = interior_randn3(shape_c, n // 2, gen, 0.05)
        rel = max(check_fas(errs, fas_cases(fam, "3", u, b, ec, n, shape_c,
                                            sw))
                  for fam in ("bratu", "quadratic") for sw in (1, 2, 3))
        print(f"[fas-kernels] {shape} -> {shape_c} n={n}, Bratu and "
              f"quadratic, 1-3 sweeps: K1f_3, K2f_3, K2f_3-resnorm bitwise "
              f"equal; resnorm norm rel {rel:.3g}")
        del u, b, ec
    torch.cuda.empty_cache()
    torch.cuda.synchronize()


def fas_counts(hier, prefix, cycles, fmg=False):
    """Launches of ``cycles`` FAS cycles (Jacobi (2, 2)) over ``hier``: K1f
    on each pair the gate takes, K2f on each but the finest, whose K2f
    fuses the norm; with ``fmg`` first the FMG-FAS pass, one cycle at each
    level from the second coarsest up (K1f and K2f on every fused pair
    below it)."""
    from tpu_multigrid_torch.kernels import fas as KF
    from tpu_multigrid_torch.kernels import fas3d as KF3
    lv = hier.levels
    three = getattr(lv[0], "ndim", 2) == 3
    suffix = "3" if three else ""
    fused = [KF3.fas3_supported(f.grid_shape, c.grid_shape, 2, torch.float32)
             if three else KF.fas_supported(f.S, c.S, 2, torch.float32)
             for f, c in zip(lv, lv[1:])]
    k1 = cycles * sum(fused)
    k2 = cycles * sum(fused[1:])
    if fmg:
        extra = sum(sum(fused[k:]) for k in range(len(fused)))
        k1, k2 = k1 + extra, k2 + extra
    return expect(**{prefix + "smooth_restrict" + suffix: k1,
                     prefix + "prolong_smooth" + suffix: k2,
                     prefix + "prolong_smooth_resnorm" + suffix:
                         cycles * int(fused[0])})


def fas_setup(family, ndim):
    name = ("build_pointwise_hierarchy" if family == "bratu"
            else "build_quasilinear_hierarchy") + ("3" if ndim == 3 else "")
    module = "bratu" if family == "bratu" else "nldiffusion"
    return HostSetup(f"tpu_multigrid_torch.problems.{module}", name)


def fas_problem(family, cfg, ndim):
    """The door's problem on the card, its levels padded for the kernels
    when ``cfg`` takes them."""
    import tpu_multigrid_torch as tmg
    pad = (dict(align=16, min_pad_level=0, lane_align=128) if ndim == 3
           else dict(align=256, min_pad_level=0)) if cfg.use_kernels else {}
    if family == "bratu":
        cls = tmg.Bratu3DProblem if ndim == 3 else tmg.BratuProblem
        return cls(cfg, lam=FAS_LAM, device=DEVICE, **pad)
    cls = (tmg.QuasilinearDiffusion3DProblem if ndim == 3
           else tmg.QuasilinearDiffusionProblem)
    return cls(cfg, gamma=FAS_GAMMA, device=DEVICE, **pad)


def fas_config(family, level, use_kernels, **kw):
    """The doors' default schedule: Jacobi (2, 2), coarsest level 3; the
    quasilinear door smooths its coarsest level with 40 sweeps."""
    import tpu_multigrid_torch as tmg
    if family != "bratu":
        kw = dict(dict(coarse_solver="smooth", coarse_smooth_sweeps=40), **kw)
    return tmg.MultigridConfig(finest_level=level, use_kernels=use_kernels,
                               **kw)


def fas_routes(tag, family, level, ndim, summary, fmg=False):
    """One door on the kernel route (its default config) and on the plain
    route, each with launch counts set to 0 just before it and checked
    exactly after: iterations within 1, finite solutions."""
    import tpu_multigrid_torch as tmg
    door = (tmg.solve_bratu if family == "bratu"
            else tmg.solve_quasilinear_diffusion)
    kw = dict(lam=FAS_LAM) if family == "bratu" else dict(gamma=FAS_GAMMA)
    prefix = "fas_" if family == "bratu" else "qfas_"
    hier = fas_problem(family, fas_config(family, level, True),
                       ndim).hierarchy
    if not fmg:
        per = fas_counts(hier, prefix, 1)
        check(sum(per.values()) == 2 * FAS_PER_CYCLE[level],
              f"{tag}: launches per cycle {nonzero(per)}")
    runs = {}
    for use in ((True,) if fmg else (True, False)):
        path = tag + ("" if use else "-plain")
        cfg = None if use else fas_config(family, level, False)
        res, secs, host, peak = front_door3(path, lambda: door(
            level, ndim=ndim, config=cfg, use_fmg=fmg, device=DEVICE, **kw),
            fas_setup(family, ndim))
        got = PATH_COUNTS[path]
        want = (fas_counts(hier, prefix, res.iterations, fmg) if use
                else expect())
        check(got == want, f"{path} launches {got}, expected {want}")
        check(bool(torch.isfinite(res.u).all())
              and (res.converged or res.stalled),
              f"{path}: {var_state(res)}")
        route = "kernels" if use else "plain"
        label = (f"{door.__name__}({level}{', ndim=3' if ndim == 3 else ''}"
                 f"{', use_fmg=True' if fmg else ''}), {route}")
        summary[path] = run_line(label, res, secs, host, peak, tag="fas")
        if use:
            print(f"[fas] launches {nonzero(got)}")
            check(tuple(res.u.shape) == tuple(hier.levels[0].grid_shape
                                              if ndim == 3 else
                                              (hier.levels[0].S,) * 2),
                  f"{path}: shape {tuple(res.u.shape)}")
        runs[use] = res
    if not fmg:
        rk, rp = runs[True], runs[False]
        n = 2 ** level
        uk = tmg.extract_solution(rk.u, n)
        up = tmg.extract_solution(rp.u, n)
        du = float((uk - up).abs().max()) / float(up.abs().max())
        print(f"[fas] {tag}: iterations kernels / plain {rk.iterations} / "
              f"{rp.iterations}; max |u_kernels - u_plain| / max|u_plain| = "
              f"{du:.3e}")
        check(abs(rk.iterations - rp.iterations) <= 1,
              f"{tag}: iterations {rk.iterations} / {rp.iterations}")
        summary[tag + "-du"] = du
    del runs, hier
    torch.cuda.empty_cache()


def bratu_newton_scipy(n, lam):
    """The discrete Bratu system A u - h^2 lam e^u = 0 (5-point A, diag 4),
    solved by Newton's method with scipy's sparse direct solves, float64,
    from zero to |F| < 1e-14: the interior values, row-major."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spl
    m = n - 1
    t = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(m, m))
    eye = sp.identity(m)
    a = (sp.kron(t, eye) + sp.kron(eye, t)).tocsc()
    h2 = (1.0 / n) ** 2
    u = np.zeros(m * m)
    for _ in range(20):
        f = a @ u - h2 * lam * np.exp(u)
        if np.abs(f).max() < 1e-14:
            break
        u = u - spl.spsolve((a - sp.diags(h2 * lam * np.exp(u))).tocsc(), f)
    return u


def phase_fas_slice():
    """The FAS slice, each path with launch counts set to 0 just before it
    and checked exactly after."""
    import tpu_multigrid_torch as tmg
    summary = {}
    # 1-4. The doors on both routes: 4097^2 Bratu and quasilinear, 513^3
    # Bratu, 257^3 quasilinear.
    fas_routes("fas-bratu-12", "bratu", FAS_LEVEL, 2, summary)
    fas_routes("fas-quasi-12", "quadratic", FAS_LEVEL, 2, summary)
    fas_routes("fas-bratu3-9", "bratu", FAS3_LEVEL, 3, summary)
    fas_routes("fas-quasi3-8", "quadratic", QUASI3_LEVEL, 3, summary)
    # 5. FMG-FAS first, on the kernels.
    fas_routes("fas-bratu-12-fmg", "bratu", FAS_LEVEL, 2, summary, fmg=True)

    # 6. A caller's own nonlinearity (phi = u^3) runs the plain route and
    # launches no FAS kernel; with use_kernels=True the door refuses it.
    def cubic(u):
        return u * u * u

    def dcubic(u):
        return 3.0 * u * u
    rc = drive("fas-cubic-9", lambda: tmg.solve_nonlinear_poisson(
        9, phi=cubic, dphi=dcubic, device=DEVICE))
    check(PATH_COUNTS["fas-cubic-9"] == expect()
          and bool(torch.isfinite(rc.u).all())
          and (rc.converged or rc.stalled),
          f"solve_nonlinear_poisson(9, u^3): {var_state(rc)}, launches "
          f"{nonzero(PATH_COUNTS['fas-cubic-9'])}")
    refused = False
    try:
        tmg.solve_nonlinear_poisson(
            9, phi=cubic, dphi=dcubic, device=DEVICE,
            config=tmg.MultigridConfig(finest_level=9, use_kernels=True))
    except ValueError as e:
        refused = "carry only" in str(e)
    check(refused, "use_kernels=True with u^3 was not refused")
    print(f"[fas] solve_nonlinear_poisson(9, phi=u^3): {var_state(rc)} after "
          f"{rc.iterations} iterations, no kernel launched; with "
          f"use_kernels=True: ValueError")
    summary["cubic_9_iterations"] = rc.iterations

    # 7. Level 6 in float64 (no kernel takes f64) against scipy's Newton
    # solve of the same discrete Bratu system.
    c6 = tmg.MultigridConfig(finest_level=6, dtype=torch.float64)
    r6 = drive("fas-bratu-6-f64", lambda: tmg.solve_bratu(
        6, lam=FAS_LAM, config=c6, tol=1e-12, device=DEVICE))
    check(PATH_COUNTS["fas-bratu-6-f64"] == expect(),
          "the float64 level-6 Bratu solve launched kernels")
    ref = bratu_newton_scipy(64, FAS_LAM)
    got = r6.u[1:64, 1:64].cpu().reshape(-1).numpy()
    err = float(np.abs(got - ref).max() / np.abs(ref).max())
    print(f"[fas] level 6, float64: {var_state(r6)} after {r6.iterations} "
          f"iterations; vs scipy's sparse Newton solve: rel err {err:.3e}")
    check(r6.converged and err <= 1e-10, f"level-6 Bratu rel err {err}")
    summary["level6_f64_iterations"] = r6.iterations
    summary["level6_f64_rel_err"] = err
    return summary


# ---------------------------------------------------------------------------
# 4j. The periodic slice: bc="periodic" on the wrap-aware fused tier
# ---------------------------------------------------------------------------

PER_LEVEL = 13
PER_W_LEVEL = 12
PER3_LEVEL = 9
PER_TOL = 1e-6
# The extended (R, C) = (n + 2 GR, n + 2 GC) fine blocks of every pair the
# level-13 periodic solve fuses (coarsest level 5): n = 8192 down to 256.
PER_BLOCKS = [(n + 32, n + 512) for n in (8192, 4096, 2048, 1024, 512, 256)]
# Fused levels of the level-13 and level-12 solves (n a multiple of 256).
PER_DEPTH = {PER_LEVEL: 6, PER_W_LEVEL: 5}


def per_forcing(x, y):
    """8 pi^2 sin(2 pi x) cos(2 pi y): zero mean on the torus."""
    return (8 * np.pi ** 2 * torch.sin(2 * np.pi * x)
            * torch.cos(2 * np.pi * y))


def per_forcing3(x, y, z):
    return (12 * np.pi ** 2 * torch.sin(2 * np.pi * x)
            * torch.sin(2 * np.pi * y) * torch.cos(2 * np.pi * z))


def per_config(use_kernels, level=None, **kw):
    """The slice's schedule: Chebyshev (3, 2), coarsest level 5."""
    import tpu_multigrid_torch as tmg
    kw = dict(dict(coarsest_level=5, smoother="chebyshev", nu1=3, nu2=2),
              **kw)
    return tmg.MultigridConfig(finest_level=level or PER_LEVEL,
                               use_kernels=use_kernels, **kw)


def per_visits(depth, cyc, k=0):
    """Fused level visits of one cycle from fused level k, as the fused
    tier recurses: W visits the next fused level twice, F once as F and
    once as V; below the last fused level the protocol path runs."""
    if k + 1 >= depth:
        return 1
    again = 0
    if cyc in ("W", "F"):
        again = per_visits(depth, cyc if cyc == "W" else "V", k + 1)
    return 1 + per_visits(depth, cyc, k + 1) + again


def per_counts(depth, cycles, cyc="V"):
    """Launches of ``cycles`` fused cycles: K1-local at every fused visit,
    K2-local at each but the finest, whose K2-local fuses the norm."""
    visits = per_visits(depth, cyc)
    return expect(smooth_restrict_ext=cycles * visits,
                  prolong_smooth_ext=cycles * (visits - 1),
                  prolong_smooth_ext_resnorm=cycles)


def per_setup():
    return HostSetup("tpu_multigrid_torch.problems.periodic",
                     "build_periodic_hierarchy")


def local_cases(u, b, ec, origin, n, sm, om1, sw1, om2, sw2):
    """{entry: (kernel call, plain call)} of K1-local, K2-local and
    K2-local-resnorm."""
    from tpu_multigrid_torch.kernels import local as KL
    k2 = (u, b, ec, origin, n, sw2, sm, om2)
    return {
        "smooth_restrict_ext": (
            lambda: KL.smooth_restrict_ext(u, b, origin, n, sw1, sm, om1),
            lambda: KL.smooth_restrict_ext_plain(u, b, origin, n, sw1, sm,
                                                 om1)),
        "prolong_smooth_ext": (
            lambda: KL.prolong_smooth_ext(*k2),
            lambda: KL.prolong_smooth_ext_plain(*k2)),
        "prolong_smooth_ext_resnorm": (
            lambda: KL.prolong_smooth_ext(*k2, want_resnorm=True),
            lambda: KL.prolong_smooth_ext_resnorm_plain(*k2))}


def phase_periodic_kernels(errs):
    """K1-local, K2-local and K2-local-resnorm bitwise against their plain
    versions over the whole arrays (the resnorm's norm to 1e-4), at every
    pair the level-13 solve fuses; Jacobi 1-3 steps, Chebyshev (3, 2),
    RB-GS 1 and 6 sweeps; at the fused tier's origin and virtual n, and at
    two shard origins with a real n: the top-left block of a 2 x 2
    decomposition (its ghosts outside the grid) and an interior block of a
    4 x 4 one."""
    from tpu_multigrid_torch.core import ops
    from tpu_multigrid_torch.kernels import local as KL
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(31)
    cheb3, cheb2 = ops.chebyshev_omegas(3, 0.4), ops.chebyshev_omegas(2, 0.4)
    smoothers = [("jacobi", 2.0 / 3.0, s, 2.0 / 3.0, s) for s in (1, 2, 3)]
    smoothers += [("jacobi", cheb3, 3, cheb2, 2),
                  ("rbgs", 2.0 / 3.0, 1, 2.0 / 3.0, 1),
                  ("rbgs", 2.0 / 3.0, 6, 2.0 / 3.0, 6)]
    for R, C in PER_BLOCKS:
        lr, lc = R - 2 * KL.GR, C - 2 * KL.GC
        origins = [((2, 2), 1 << 30), ((-KL.GR, -KL.GC), 2 * lr),
                   ((lr - KL.GR, lc - KL.GC), 4 * lr)]
        u = torch.randn((R, C), generator=gen, device=DEVICE)
        b = torch.randn((R, C), generator=gen, device=DEVICE)
        ec = torch.randn(KL.coarse_shape(R, C), generator=gen, device=DEVICE)
        rel = 0.0
        for origin, n in origins:
            for sm, om1, sw1, om2, sw2 in smoothers:
                for entry, (kern, plain) in local_cases(
                        u, b, ec, origin, n, sm, om1, sw1, om2,
                        sw2).items():
                    got, want = kern(), plain()
                    if entry == "prolong_smooth_ext_resnorm":
                        track(errs, entry, got[0], want[0])
                        rel = max(rel, track_norm(
                            errs, entry, torch.sqrt(got[1]),
                            torch.sqrt(want[1])))
                    elif isinstance(got, tuple):
                        for g, w in zip(got, want):
                            track(errs, entry, g, w)
                    else:
                        track(errs, entry, got, want)
        print(f"[periodic-kernels] ({R}, {C}) -> {KL.coarse_shape(R, C)}, "
              f"origins {[o for o, _ in origins]}: Jacobi 1-3, Chebyshev "
              f"(3, 2), RB-GS 1 and 6: K1-local u' and rc, K2-local, "
              f"K2-local-resnorm u' bitwise equal over the whole arrays; "
              f"resnorm norm rel {rel:.3g}")
        del u, b, ec
    torch.cuda.empty_cache()
    torch.cuda.synchronize()


def gauge(u):
    """|mean(u)| / max|u|, in float64."""
    return float(u.double().mean().abs()) / float(u.abs().max())


def per_route(tag, use, level=None, summary=None, **kw):
    """One periodic door call with launch counts set to 0 just before it
    and checked exactly after: (result, seconds with set-up, peak bytes)."""
    import tpu_multigrid_torch as tmg
    level = level or PER_LEVEL
    cfg = per_config(use, level, **{k: kw.pop(k) for k in
                                    ("cycle", "smoother", "nu1", "nu2")
                                    if k in kw})
    res, secs, host, peak = front_door3(tag, lambda: tmg.solve_poisson(
        level, bc="periodic", forcing=per_forcing, config=cfg, device=DEVICE,
        **kw), per_setup())
    want = (per_counts(PER_DEPTH[level], res.iterations, cfg.cycle) if use
            else expect())
    got = PATH_COUNTS[tag]
    check(got == want, f"{tag} launches {nonzero(got)}, expected "
                       f"{nonzero(want)}")
    check(tuple(res.u.shape) == (2 ** level,) * 2
          and bool(torch.isfinite(res.u).all()), f"{tag}: bad solution")
    g = gauge(res.u)
    h = res.res_history[:res.iterations + 1]
    red = float(h[-1] / h[0]) if res.iterations else 1.0
    label = (f"solve_poisson({level}, bc='periodic', {cfg.cycle}, "
             f"{cfg.smoother} ({cfg.nu1}, {cfg.nu2}), "
             f"{', '.join(f'{k}={v}' for k, v in kw.items())}), "
             f"{'kernels' if use else 'plain'}")
    line = run_line(label, res, secs, host, peak, tag="periodic")
    print(f"[periodic]   reduction {red:.4g} over {res.iterations} cycles; "
          f"|mean u| / max|u| = {g:.3e}; launches {nonzero(got)}")
    if summary is not None:
        summary[tag] = dict(line, reduction=red, gauge=g)
    return res


def torus_direct(n, b):
    """The float64 (n, n) torus system A u = b (diag 4, -1 per wrapped
    neighbour) solved by scipy's sparse LU with node 0 pinned to 0, then
    the mean removed: the mean-zero solution."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spl
    t = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n)).tolil()
    t[0, n - 1] = t[n - 1, 0] = -1.0
    eye = sp.identity(n)
    a = (sp.kron(t, eye) + sp.kron(eye, t)).tocsc()[1:, 1:]
    rhs = b.reshape(-1)
    x = np.concatenate([[0.0], spl.splu(a).solve(rhs[1:])])
    return (x - x.mean()).reshape(b.shape)


def torus_direct3(n, b):
    """The float64 (n, n, n) torus system (diag 6, -1 per wrapped
    neighbour) solved directly in its Fourier basis, which diagonalizes it:
    u_k = b_k / (6 - 2 cos t1 - 2 cos t2 - 2 cos t3), the constant mode 0
    (the mean-zero solution).  A sparse LU of the 32^3 torus fills in for
    about a minute of a host core; the transform takes milliseconds."""
    c = 2.0 * np.cos(2.0 * np.pi * np.fft.fftfreq(n))
    lam = (6.0 - c[:, None, None] - c[None, :, None] - c[None, None, :])
    lam[0, 0, 0] = 1.0
    uk = np.fft.fftn(b) / lam
    uk[0, 0, 0] = 0.0
    return np.real(np.fft.ifftn(uk))


def phase_periodic_slice():
    """The periodic slice, each path with launch counts set to 0 just
    before it and checked exactly after."""
    import tpu_multigrid_torch as tmg
    from tpu_multigrid_torch.cycles import periodic_fused as PF
    summary = {}
    # 1. The slice at 8193^2 nodes (8192^2 unknowns): 5 fixed cycles, then
    # until tol with the stall rule, on both routes.
    runs = {}
    for use in (True, False):
        suffix = "" if use else "-plain"
        per_route(f"periodic-13-fixed{suffix}", use, num_cycles=5, tol=None,
                  summary=summary)
        runs[use] = per_route(f"periodic-13{suffix}", use, tol=PER_TOL,
                              summary=summary)
    rk, rp = runs[True], runs[False]
    du = float((rk.u - rp.u).abs().max()) / float(rp.u.abs().max())
    print(f"[periodic] level 13: iterations kernels / plain {rk.iterations} "
          f"/ {rp.iterations}; max |u_kernels - u_plain| / max|u_plain| = "
          f"{du:.3e}")
    check(abs(rk.iterations - rp.iterations) <= 1,
          f"periodic-13: iterations {rk.iterations} / {rp.iterations}")
    for use, res in runs.items():
        check(gauge(res.u) < 1e-6, f"periodic-13 (kernels={use}): the "
              f"mean-zero gauge moved to {gauge(res.u):.3e}")
    summary["periodic-13-du"] = du
    del runs, rk, rp
    # 2. W and F cycles at level 12, an FMG start at level 13 (the FMG pass
    # runs the protocol path, its cycles the fused tier), RB-GS (1, 1) and
    # Jacobi (2, 2) at level 12.
    for cyc in ("W", "F"):
        per_route(f"periodic-12-{cyc}", True, PER_W_LEVEL, summary,
                  cycle=cyc, num_cycles=3, tol=None)
    per_route("periodic-13-fmg", True, summary=summary, use_fmg=True,
              num_cycles=2, tol=None)
    for sm, nu in (("rbgs", 1), ("jacobi", 2)):
        per_route(f"periodic-12-{sm}", True, PER_W_LEVEL, summary,
                  smoother=sm, nu1=nu, nu2=nu, num_cycles=3, tol=None)
    # 3. 10 seeded random mean-zero right-hand sides at level 12, 3 fixed
    # cycles each on both routes over one hierarchy: the mean reduction per
    # cycle (3 cycles stay above the float32 floor, ~6e-5 of r0 for a white
    # noise right-hand side at level 12).
    cfg_k, cfg_p = per_config(True, PER_W_LEVEL), per_config(False,
                                                            PER_W_LEVEL)
    prob = tmg.PeriodicPoissonProblem(cfg_k, forcing=per_forcing,
                                      device=DEVICE)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(32)
    n = 2 ** PER_W_LEVEL
    rates = {True: [], False: []}

    def rand_runs():
        for _ in range(10):
            b = torch.randn((n, n), generator=gen, device=DEVICE)
            b = b - b.mean()
            rk = PF.solve_fixed_periodic(prob.hierarchy, cfg_k, b, 3)
            rp = tmg.solve_fixed(prob.hierarchy, cfg_p, b, 3)
            for use, r in ((True, rk), (False, rp)):
                h = r.res_history.double()
                rates[use].append(float((h[-1] / h[0]) ** (1 / 3)))
    drive("periodic-12-random", rand_runs)
    check(PATH_COUNTS["periodic-12-random"]
          == per_counts(PER_DEPTH[PER_W_LEVEL], 30),
          f"periodic-12-random launches "
          f"{nonzero(PATH_COUNTS['periodic-12-random'])}")
    mean_k = float(np.mean(rates[True]))
    mean_p = float(np.mean(rates[False]))
    print(f"[periodic] 10 random mean-zero right-hand sides at level 12, 3 "
          f"cycles each: mean reduction per cycle kernels {mean_k:.4f}, "
          f"plain {mean_p:.4f} (per rhs: kernels "
          f"{[round(r, 4) for r in rates[True]]})")
    check(mean_k < 0.2 and abs(mean_k - mean_p) <= 0.1 * mean_p,
          f"random rhs: reduction per cycle {mean_k} / {mean_p}")
    summary["random12_reduction_kernels"] = mean_k
    summary["random12_reduction_plain"] = mean_p
    del prob
    torch.cuda.empty_cache()
    # 4. Level 6 in float64 (no kernel takes it) against scipy's sparse
    # direct solve, both in the mean-zero gauge.
    c6 = tmg.MultigridConfig(finest_level=6, coarsest_level=3,
                             smoother="chebyshev", nu1=3, nu2=2,
                             dtype=torch.float64, use_kernels=True)
    r6 = drive("periodic-6-f64", lambda: tmg.solve_poisson(
        6, bc="periodic", forcing=per_forcing, config=c6, tol=1e-13,
        device=DEVICE))
    check(PATH_COUNTS["periodic-6-f64"] == expect(),
          "the float64 level-6 periodic solve launched kernels")
    b6 = tmg.PeriodicPoissonProblem(c6, forcing=per_forcing,
                                    device=DEVICE).rhs()
    ref = torus_direct(64, b6.cpu().numpy())
    got = r6.u.cpu().numpy()
    err = float(np.abs((got - got.mean()) - ref).max() / np.abs(ref).max())
    print(f"[periodic] level 6, float64: {var_state(r6)} after "
          f"{r6.iterations} iterations; vs scipy's sparse direct solve (node "
          f"0 pinned, mean removed): rel err {err:.3e}")
    check(r6.converged and err <= 1e-10, f"level-6 periodic rel err {err}")
    summary["level6_f64_rel_err"] = err
    # 5. 3D: solve_poisson3d(9, bc="periodic") on the plain torus operators
    # (no kernel takes them), 3 fixed cycles and until tol; level 5 in
    # float64 against the direct Fourier solve.
    for tag, kw in (("periodic3-9-fixed", dict(num_cycles=3, tol=None)),
                    ("periodic3-9", dict())):
        res, secs, host, peak = front_door3(tag, lambda: tmg.solve_poisson3d(
            PER3_LEVEL, bc="periodic", forcing=per_forcing3, device=DEVICE,
            **kw), HostSetup("tpu_multigrid_torch.problems.periodic3d",
                             "build_periodic3_hierarchy"))
        check(PATH_COUNTS[tag] == expect(), f"{tag} launched kernels")
        check(bool(torch.isfinite(res.u).all())
              and tuple(res.u.shape) == (2 ** PER3_LEVEL,) * 3,
              f"{tag}: bad solution")
        line = run_line(f"solve_poisson3d({PER3_LEVEL}, bc='periodic', "
                        f"{kw or 'tol=1e-8'}), plain", res, secs, host, peak,
                        tag="periodic")
        print(f"[periodic]   |mean u| / max|u| = {gauge(res.u):.3e}")
        summary[tag] = line
        del res
    torch.cuda.empty_cache()
    c5 = tmg.MultigridConfig(finest_level=5, coarsest_level=2,
                             smoother="chebyshev", nu1=3, nu2=2,
                             dtype=torch.float64)
    r5 = drive("periodic3-5-f64", lambda: tmg.solve_poisson3d(
        5, bc="periodic", forcing=per_forcing3, config=c5, tol=1e-13,
        device=DEVICE))
    b5 = tmg.Periodic3DPoissonProblem(c5, forcing=per_forcing3,
                                      device=DEVICE).rhs()
    ref = torus_direct3(32, b5.cpu().numpy())
    got = r5.u.cpu().numpy()
    err3 = float(np.abs((got - got.mean()) - ref).max() / np.abs(ref).max())
    print(f"[periodic] 3D level 5, float64: {var_state(r5)} after "
          f"{r5.iterations} iterations; vs the direct Fourier solve (mean "
          f"removed): rel err {err3:.3e}")
    check(r5.converged and err3 <= 1e-10, f"3D level-5 rel err {err3}")
    summary["level5_3d_f64_rel_err"] = err3
    return summary


def local_work(R, C, steps1, steps2):
    """(bytes, operations) of the three entries on an (R, C) block of the
    fused tier, where every cell is live: K1-local reads u and b and writes
    u' and the coarse block; K2-local reads u, b and the (R/2 + 1, C/2 + 1)
    coarse cells P reads, and writes u'; K2-local-resnorm also writes the
    sum, and its residual counts the owned cells."""
    Rc, Cc = R // 2 + 16, C // 2 + 256
    cells, owned = R * C, (R - 32) * (C - 512)
    k2 = 4 * (3 * cells + (R // 2 + 1) * (C // 2 + 1))
    return {
        "smooth_restrict_ext": (4 * (3 * cells + Rc * Cc),
                                (steps1 * JAC + RES) * cells
                                + FW * cells // 4),
        "prolong_smooth_ext": (k2, (PRO + steps2 * JAC) * cells),
        "prolong_smooth_ext_resnorm": (
            k2 + 4, (PRO + steps2 * JAC) * cells + (RES + 2) * owned)}


def periodic_times(card, times, work):
    """The periodic 8192^2 V-cycle on both routes (the fused tier's cycle
    on the extended state, with its norm, against the protocol path's),
    with the host's time to issue it and the plain levels' share, and
    each new kernel at the finest pair beside its plain version (Chebyshev
    3 for K1-local, 2 for K2-local).  No PyTorch call computes these
    functions: no library time."""
    from tpu_multigrid_torch.core import ops
    from tpu_multigrid_torch.cycles import cycle, cycle_with_norm
    from tpu_multigrid_torch.cycles import periodic_fused as PF
    import tpu_multigrid_torch as tmg
    dof = (2 ** PER_LEVEL) ** 2
    cfg_k, cfg_p = per_config(True), per_config(False)
    prob = tmg.PeriodicPoissonProblem(cfg_k, forcing=per_forcing,
                                      device=DEVICE)
    hier, b = prob.hierarchy, prob.rhs()
    depth = PF.fused_levels(hier, cfg_k, b.dtype)
    ue, be = PF.extend(torch.zeros_like(b)), PF.extend(b)
    u = torch.zeros_like(b)
    for use, fn in ((True, lambda: PF.cycle_with_norm_ext(hier, cfg_k, ue, be,
                                                          depth)),
                    (False, lambda: cycle_with_norm(hier, cfg_p, u, b))):
        ms = cuda_ms(fn)
        key = "periodic_vcycle" if use else "periodic_vcycle_plain"
        times[key] = ms
        # The host's time to issue one cycle (no cycle syncs with the host).
        issue = []
        for _ in range(7):
            t0 = time.perf_counter()
            fn()
            issue.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        times[key + "_issue"] = statistics.median(issue)
        print(f"[times] periodic V-cycle at {2 ** PER_LEVEL}^2 (torus), "
              f"Chebyshev (3,2), coarsest 5, "
              f"{'kernels' if use else 'plain  '}: {ms:.3f} ms, "
              f"{dof / (ms * 1e-3):.4g} DOF/s; host issue "
              f"{times[key + '_issue']:.3f} ms  ({card})")
    # The plain levels below the fused ones, alone: one V-cycle from the
    # last fused level's coarse grid (128^2) down to the 32^2 coarsest.
    nc = 2 ** PER_LEVEL >> depth
    rc = torch.randn((nc, nc), generator=torch.Generator(
        device=DEVICE).manual_seed(34), device=DEVICE)
    rc = rc - rc.mean()
    ms = cuda_ms(lambda: cycle(hier, cfg_k, torch.zeros_like(rc), rc, depth))
    times["periodic_plain_tail"] = ms
    print(f"[times]   its plain levels {nc}^2 to {hier.levels[-1].n}^2 alone "
          f"(one V-cycle from a zero guess): {ms:.3f} ms  ({card})")
    del prob, hier, b, ue, be, u, rc
    torch.cuda.empty_cache()
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(33)
    R, C = PER_BLOCKS[0]
    u = torch.randn((R, C), generator=gen, device=DEVICE)
    b = torch.randn((R, C), generator=gen, device=DEVICE)
    ec = torch.randn((R // 2 + 16, C // 2 + 256), generator=gen,
                     device=DEVICE)
    cases = local_cases(u, b, ec, (2, 2), 1 << 30, "jacobi",
                        ops.chebyshev_omegas(3, 0.4), 3,
                        ops.chebyshev_omegas(2, 0.4), 2)
    work.update(local_work(R, C, 3, 2))
    for name, (kern, plain) in cases.items():
        times[name] = (cuda_ms(kern), cuda_ms(plain))
        k, p = times[name]
        bms, by = bound(*work[name])
        print(f"[times] {name:27s} ({R}, {C}): kernel {k:.3f} ms, plain "
              f"{p:.3f} ms, bound {bms:.3f} ms ({by})  ({card})")
    del u, b, ec, cases
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 4k. The distributed fused tier (dist/refine_pallas.py, dist/pallas_cycle.py)
# ---------------------------------------------------------------------------

DIST_LEVEL = 14
DIST_V_LEVEL = 13
DIST_TOL = 1e-8
DIST_DS = 2
# (R, C, n) of the extended blocks the kernels are held at: the finest block
# of the (1, 1) level-14 solve, and a 2 x 2 shard of the level-13 one.
DIST_BLOCKS = [(17408 + 32, 17408 + 512, 16384),
               (4608 + 32, 4608 + 512, 8192)]
# Launches per refined iteration of the ts solve with ds_levels 2 over three
# sharded levels (two on the 2 x 2 mesh at level 13): K1-local at each
# sharded level, K2-local at the last, and per ds level one K0-local, one
# ds residual, one exact-pair prolongation and two compensated adds; then
# one add into the triple and its ts residual.
DIST_PER_ITER = {3: dict(smooth_restrict_ext=3, prolong_smooth_ext=1,
                         smooth_ext=2, ds_residual_ext=2, prolong_pair_ext=2,
                         comp_add_ext=5, ts_residual_ext=1),
                 2: dict(smooth_restrict_ext=2, smooth_ext=2,
                         ds_residual_ext=2, prolong_pair_ext=2,
                         comp_add_ext=5, ts_residual_ext=1)}


def dist_origins(R, C):
    lr, lc = R - 32, C - 512
    return [(-16, -256), (lr - 16, -256), (-16, lc - 256),
            (lr - 16, lc - 256)]


def dist_cases(u, b, um, ul, ech, ecl, origin, n):
    """{entry: [(kernel call, plain call), ...]} of the four kernels'
    entries on the path (and residual_ext, K0-local's other entry)."""
    from tpu_multigrid_torch.core import ops
    from tpu_multigrid_torch.kernels import local as KL
    from tpu_multigrid_torch.kernels import localref as KR
    smooth = [("jacobi", 2.0 / 3.0, 2),
              ("jacobi", ops.chebyshev_omegas(2, 0.4), 2),
              ("rbgs", 1.0, 1)]
    return {
        "smooth_ext": [
            (lambda a=a: KL.smooth_ext(u, b, origin, n, a[2], a[0], a[1]),
             lambda a=a: KL.smooth_ext_plain(u, b, origin, n, a[2], a[0],
                                             a[1])) for a in smooth],
        "residual_ext": [(lambda: KL.residual_ext(u, b, origin, n),
                          lambda: KL.residual_ext_plain(u, b, origin, n))],
        "ds_residual_ext": [
            (lambda: KR.ds_residual_ext(b, u, um, origin, n),
             lambda: KR.ds_residual_ext_plain(b, u, um, origin, n))],
        "ts_residual_ext": [
            (lambda: KR.ts_residual_ext(b, u, um, ul, origin, n),
             lambda: KR.ts_residual_ext_plain(b, u, um, ul, origin, n))],
        "prolong_pair_ext": [
            (lambda: KR.prolong_pair_ext(ech, ecl, origin, n),
             lambda: KR.prolong_pair_ext_plain(ech, ecl, origin, n))]}


def comp_add_case(k, m, u, b, um, ul):
    """(kernel call, plain call) of comp_add_ext on fresh copies."""
    from tpu_multigrid_torch.kernels import localref as KR
    comps = [u, um, ul][:k]
    ys = [b, um][:m]
    return (lambda: KR.comp_add_ext([c.clone() for c in comps], ys),
            lambda: KR.comp_add_ext_plain([c.clone() for c in comps], ys))


def phase_dist_kernels(errs):
    """The four kernels of the distributed refinement bitwise against their
    plain versions over the whole arrays, random ghosts included: at the
    (1, 1) level-14 finest block and a 2 x 2 level-13 shard block, at the
    four shard origins each; K0-local with Jacobi 2, Chebyshev 2, RB-GS 1
    and the residual; comp_add_ext for the ds pair and ts triple with one
    and two addends."""
    from tpu_multigrid_torch.kernels import local as KL
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(41)
    for R, C, n in DIST_BLOCKS:
        u, b = (torch.randn((R, C), generator=gen, device=DEVICE)
                for _ in range(2))
        um = 1e-8 * torch.randn((R, C), generator=gen, device=DEVICE)
        ul = 1e-15 * torch.randn((R, C), generator=gen, device=DEVICE)
        ech = torch.randn(KL.coarse_shape(R, C), generator=gen,
                          device=DEVICE)
        ecl = 1e-8 * torch.randn(KL.coarse_shape(R, C), generator=gen,
                                 device=DEVICE)
        for origin in dist_origins(R, C):
            for entry, pairs in dist_cases(u, b, um, ul, ech, ecl, origin,
                                           n).items():
                for kern, plain in pairs:
                    got, want = kern(), plain()
                    for g, w in zip(*(x if isinstance(x, tuple) else (x,)
                                      for x in (got, want))):
                        track(errs, entry, g, w)
                    del got, want
        for k in (2, 3):
            for m in (1, 2):
                kern, plain = comp_add_case(k, m, u, b, um, ul)
                for g, w in zip(kern(), plain()):
                    track(errs, "comp_add_ext", g, w)
        print(f"[dist-kernels] ({R}, {C}) -> {KL.coarse_shape(R, C)}, n={n}"
              f", origins {dist_origins(R, C)}: smooth_ext (Jacobi 2, "
              f"Chebyshev 2, RB-GS 1), residual_ext, ds/ts_residual_ext, "
              f"prolong_pair_ext, comp_add_ext (k, m) in {{2, 3}} x {{1, 2}}"
              f": bitwise equal over the whole arrays")
        del u, b, um, ul, ech, ecl
        torch.cuda.empty_cache()
    torch.cuda.synchronize()


def dist_config(level):
    """benchmarks/bench_dist_refined.py's configuration: Jacobi (2, 2),
    coarsest level 5."""
    import tpu_multigrid_torch as tmg
    return tmg.MultigridConfig(finest_level=level, coarsest_level=5)


def dist_gathered_rhs(mesh, levels):
    from tpu_multigrid_torch.dist import pallas_cycle as PC
    n0, S0 = levels.sizes[0]
    my, mx = mesh.shape
    b = PC.rhs_ext(mesh, n0, S0 // my, S0 // mx, 4.0, torch.float32)
    return PC.gather_owned(mesh, b)


def dist_ts_solve(mesh, level, **kw):
    from tpu_multigrid_torch import dist
    return dist.refined_sharded_solve_pallas(
        dist_config(level), mesh, tol=DIST_TOL, max_iters=30, ts=True,
        ds_levels=DIST_DS, **kw)


def dist_rank_program(mesh, level):
    """A rank of the 2 x 2 mesh: the ts solve at ``level`` with its launch
    counts and seconds; rank 0 also returns the gathered leading
    component."""
    from tpu_multigrid_torch import dist, kernels
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res, levels = dist_ts_solve(mesh, level)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = kernels.launch_counts()
    u = dist.gather_full(mesh, res.u.contiguous()).cpu()
    return dict(hist=res.res_history, iterations=res.iterations,
                converged=res.converged, counts=counts, seconds=secs,
                sizes=levels.sizes, num_sharded=levels.num_sharded,
                u=u if mesh.rank == 0 else None)


def dist_ratios(h, it):
    h = np.asarray(h)[:it + 1]
    return h[1:] / h[0]


def phase_dist_slice(card, record):
    """The distributed fused tier on a one-rank NCCL group at full width,
    and on a 2 x 2 gloo mesh sharing the card; each path with launch counts
    set to 0 just before it and checked exactly after."""
    import os
    import tempfile
    import torch.distributed as tdist
    import tpu_multigrid_torch as tmg
    from tpu_multigrid_torch import dist
    from tpu_multigrid_torch.cycles import cycle_with_norm
    from tpu_multigrid_torch.dist import pallas_cycle as PC
    summary = {}
    tmp = tempfile.mkdtemp(prefix="chip-smoke-nccl-")
    tdist.init_process_group("nccl", init_method="file://" + os.path.join(
        tmp, "store"), world_size=1, rank=0)
    try:
        mesh = dist.make_grid_mesh((1, 1))
        print(f"[dist] one-rank {mesh.backend} group, mesh {mesh.shape} on "
              f"{mesh.device}")
        # 1. The 16385^2 ts solve, from set-up to the end of the solve.
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res, levels = drive("dist-ts-14", lambda: dist_ts_solve(
            mesh, DIST_LEVEL))
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        it = res.iterations
        b = dist_gathered_rhs(mesh, levels)
        comps = [dist.gather_full(mesh, c) for c in res.components]
        rel = f64_rel_residual(b, comps, 2 ** DIST_LEVEL)
        del b, comps
        hist = res.res_history[:it + 1]
        print(f"[dist] refined_sharded_solve_pallas at {2 ** DIST_LEVEL + 1}"
              f"^2, (1, 1) mesh, ts, ds_levels {DIST_DS}, levels "
              f"{levels.sizes[:4]}... ({levels.num_sharded} sharded): "
              f"converged={res.converged} iterations={it} history=["
              f"{', '.join(f'{float(x):.4e}' for x in hist)}]; seconds (one "
              f"call, set-up included) {secs:.3f}, max_memory_allocated "
              f"{peak / 2 ** 30:.2f} GiB, f64 relative residual of u_hi + "
              f"u_mid + u_lo {rel:.3e}  ({card})")
        check(res.converged, f"dist-ts-14: not converged in {it}")
        check(rel <= 2e-8, f"dist-ts-14: f64 relative residual {rel}")
        check(levels.num_sharded == 3, f"dist-ts-14: {levels}")
        want = expect(**{k: v * it for k, v in DIST_PER_ITER[3].items()})
        got = PATH_COUNTS["dist-ts-14"]
        check(got == want, f"dist-ts-14 launches {nonzero(got)}, expected "
                           f"{nonzero(want)}")
        print(f"[dist] launches over {it} iterations: {nonzero(got)}")
        del res
        torch.cuda.empty_cache()
        # Its time per iteration: the slope between 2 and 6 iterations,
        # after a warm-up call, on a prebuilt hierarchy.
        pre = PC.build_pallas_poisson(dist_config(DIST_LEVEL), (1, 1),
                                      replicate_below=256,
                                      device=mesh.device)
        walls = {}
        for iters in (1, 2, 6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dist.refined_sharded_solve_pallas(
                dist_config(DIST_LEVEL), mesh, num_cycles=iters, ts=True,
                ds_levels=DIST_DS, prebuilt=pre)
            torch.cuda.synchronize()
            walls[iters] = time.perf_counter() - t0
        per_ms = (walls[6] - walls[2]) / 4 * 1e3
        torch.cuda.empty_cache()
        print(f"[dist] ms per refined iteration (slope 2 -> 6 iterations): "
              f"{per_ms:.3f}; beside it the single-device record "
              f"(solve_refined_ts, ds_levels 3, Chebyshev (3, 2), another "
              f"route): {record['iterations']} iterations, "
              f"{record['seconds']:.3f} s with set-up  ({card})")
        summary["ts14"] = dict(iterations=it, seconds=secs,
                               peak_gib=peak / 2 ** 30, f64_rel_residual=rel,
                               ms_per_iteration=per_ms)

        # 2. The fused V-cycle at 8193^2 against the single-device kernel
        # V-cycle.
        cfg = record_config(True, DIST_V_LEVEL)
        rd = drive("dist-v-13", lambda: tmg.solve_poisson(
            DIST_V_LEVEL, config=cfg, mesh=mesh, dist_path="pallas",
            refined=False, num_cycles=3))
        want = expect(smooth_restrict_ext=9, prolong_smooth_ext=6,
                      prolong_smooth_ext_resnorm=3)
        got = PATH_COUNTS["dist-v-13"]
        check(got == want, f"dist-v-13 launches {nonzero(got)}, expected "
                           f"{nonzero(want)}")
        # After 3 cycles the iterate sits at the f32 floor of this
        # h^2-scaled right-hand side (0.2 of r0 at level 13, as the torus
        # phase shows), where two f32 routes part by ~2e-4 of max|u|: held
        # to 1e-3; the one-cycle iterates, above the floor, to 1e-5.
        n = 2 ** DIST_V_LEVEL
        phys = (slice(0, n + 1), slice(0, n + 1))
        du = {}
        for cycles in (1, 3):
            r_s = tmg.solve_poisson(DIST_V_LEVEL, config=cfg, refined=False,
                                    num_cycles=cycles, device=DEVICE)
            if cycles == 3:
                rs = r_s
                ud = dist.gather_full(mesh, rd.u)
            else:
                ud = dist.gather_full(mesh, tmg.solve_poisson(
                    DIST_V_LEVEL, config=cfg, mesh=mesh, dist_path="pallas",
                    refined=False, num_cycles=1).u)
            us = r_s.u[phys]
            du[cycles] = float((ud[phys] - us).abs().max() / us.abs().max())
            del ud, us, r_s
        dh = float(np.max(np.abs(np.asarray(rd.res_history)
                                 / np.asarray(rs.res_history) - 1)))
        levels, hier = PC.build_pallas_poisson(cfg, (1, 1),
                                               device=mesh.device)
        n0, S0 = levels.sizes[0]
        be = PC.rhs_ext(mesh, n0, S0, S0, 4.0, torch.float32)
        ue = torch.zeros_like(be)
        def vcycle():
            return PC._vcycle_pallas(mesh, levels, hier, cfg, 0, ue, be,
                                     want_norm=True)
        ms_d = cuda_ms(vcycle)
        # The host's time to issue it (the cycle syncs with the host only
        # for its norm), and the replicated plain levels alone.
        issue = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vcycle()
            issue.append((time.perf_counter() - t0) * 1e3)
        issue_ms = statistics.median(issue)
        ns = levels.num_sharded
        rc = torch.randn((levels.sizes[ns][1],) * 2, generator=torch.Generator(
            device=DEVICE).manual_seed(44), device=DEVICE)
        tail_ms = cuda_ms(lambda: PC._replicated_cycle(
            hier, cfg, ns, torch.zeros_like(rc), rc))
        prob = tmg.PoissonProblem(cfg, device=DEVICE, align=256,
                                  min_pad_level=0)
        bs = prob.rhs()
        us0 = torch.zeros_like(bs)
        ms_s = cuda_ms(lambda: cycle_with_norm(prob.hierarchy, cfg, us0, bs))
        print(f"[dist] V-cycle with its norm at {n + 1}^2, Chebyshev (3, 2):"
              f" fused tier on (1, 1) {ms_d:.3f} ms ({levels.num_sharded} "
              f"sharded levels; host issue {issue_ms:.3f} ms; its replicated "
              f"plain levels from {levels.sizes[ns][1]}^2 alone "
              f"{tail_ms:.3f} ms), single-device kernels {ms_s:.3f} ms; max "
              f"|u_dist - u_single| / max|u_single| after 1 cycle "
              f"{du[1]:.3e}, after 3 {du[3]:.3e}; history rel diff "
              f"{dh:.3e}  ({card})")
        check(du[1] <= 1e-5 and du[3] <= 1e-3, f"dist-v-13 against the "
              f"single-device V-cycle: du {du}")
        summary["v13"] = dict(ms_dist=ms_d, ms_single=ms_s, du_1=du[1],
                              du_3=du[3], issue_ms=issue_ms, tail_ms=tail_ms)
        del rd, rs, be, ue, prob, bs, us0, hier, rc
        torch.cuda.empty_cache()

        # 3. The 2 x 2 mesh on the one card (gloo, strips staged through
        # host memory) against the (1, 1) NCCL run at level 13.
        r1, lv1 = drive("dist-ts-13", lambda: dist_ts_solve(
            mesh, DIST_V_LEVEL))
        it1 = r1.iterations
        want = expect(**{k: v * it1 for k, v in DIST_PER_ITER[3].items()})
        check(PATH_COUNTS["dist-ts-13"] == want,
              f"dist-ts-13 launches {nonzero(PATH_COUNTS['dist-ts-13'])}")
        u1 = dist.gather_full(mesh, r1.u).cpu()
        h1 = np.asarray(r1.res_history)
        del r1
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out = dist.run_on_mesh(dist_rank_program, (2, 2), backend="gloo",
                               device=DEVICE + ":0", args=(DIST_V_LEVEL,))
        wall = time.perf_counter() - t0
        o = out[0]
        it4 = o["iterations"]
        total = {k: sum(r["counts"][k] for r in out) for k in o["counts"]}
        PATH_COUNTS["dist-ts-13-2x2"] = total
        want = expect(**{k: v * it4 * 4 for k, v in
                         DIST_PER_ITER[2].items()})
        check(o["num_sharded"] == 2 and total == want,
              f"dist-ts-13-2x2: {o['num_sharded']} sharded, launches "
              f"{nonzero(total)}, expected {nonzero(want)}")
        for r in out[1:]:
            check(r["iterations"] == it4 and torch.equal(
                r["hist"][:it4 + 1], o["hist"][:it4 + 1]),
                "dist-ts-13-2x2: the ranks disagree")
        check(o["converged"] and it4 == it1, f"dist-ts-13-2x2: {it4} "
              f"iterations against {it1}")
        ua, ub = o["u"][phys].numpy(), u1[phys].numpy()
        close = np.allclose(ua, ub, rtol=1e-4, atol=1e-8)
        rat = float(np.max(np.abs(dist_ratios(o["hist"], it4)
                                  / dist_ratios(h1, it1) - 1)))
        print(f"[dist] 2 x 2 gloo mesh on one card at {n + 1}^2 (levels "
              f"{o['sizes'][:3]}..., 2 sharded): converged={o['converged']}"
              f" in {it4} iterations (the (1, 1) NCCL run: {it1}); history "
              f"ratios rel diff {rat:.3e}; u within rtol 1e-4 / atol 1e-8 "
              f"of the (1, 1) run: {close} (max |du| "
              f"{float(np.abs(ua - ub).max()):.3e}); seconds per rank "
              f"{[round(r['seconds'], 3) for r in out]}, {wall:.3f} s with "
              f"the ranks' start (not a multi-card time: the ranks share "
              f"one card and stage every strip through host memory)  "
              f"({card})")
        check(rat <= 2e-2 and close, "dist-ts-13-2x2 against the (1, 1) "
              f"run: history ratios {rat}, u close {close}")
        summary["ts13_2x2"] = dict(iterations=it4, iterations_1x1=it1,
                                   ratio_rel_diff=rat, seconds=o["seconds"])
    finally:
        tdist.destroy_process_group()
    torch.cuda.empty_cache()
    return summary


def dist_cells(R, C, origin, n):
    """(cells, live, reach, coarse reach) of an extended block: the live
    cells (global 1..n-1), the cells their stencils read (0..n), and the
    coarse cells the prolongation of the live cells reads."""
    def span(o, size, lo, hi):
        return max(0, min(o + size - 1, hi) - max(o, lo) + 1)
    live = span(origin[0], R, 1, n - 1) * span(origin[1], C, 1, n - 1)
    reach = span(origin[0], R, 0, n) * span(origin[1], C, 0, n)
    creach = (span(origin[0], R, 0, n) // 2 + 1) * (
        span(origin[1], C, 0, n) // 2 + 1)
    return R * C, live, reach, creach


# Float32 operations per element of the compensated adds, counted from
# localref.cu: ds_add 10 (a TwoSum, an add, a quick TwoSum), ts_add 28.
DS_ADD, TS_ADD = 10, 28


def dist_work(R, C, origin, n, steps):
    """(bytes, operations) of the entries at an (R, C) block: each input
    read once over what the function needs (u over the reach, b over the
    live cells, every component of the compensated adds in full), each
    output written once in full."""
    cells, live, reach, creach = dist_cells(R, C, origin, n)
    return {
        "smooth_ext": (4 * (reach + live + cells), steps * JAC * live),
        "ds_residual_ext": (4 * (live + 2 * reach + cells), DS * live),
        "ts_residual_ext": (4 * (live + 3 * reach + cells), TS * live),
        "prolong_pair_ext": (4 * (2 * creach + 2 * cells),
                             (PRO_COMP + PRO + 1) * live),
        "comp_add_ext": (4 * (3 + 2 + 3) * cells, 2 * TS_ADD * cells)}


def comp_add_times(card, times, shape, gen, name):
    """The refinement loop's iterate update at ``shape``: a ds pair plus
    one addend through ``precision._accumulate`` on the kernel (one
    comp_add_ext launch, in place), bitwise against the plain ds_add chain,
    then timed beside the chain against its byte bound: hi, lo and y read
    once, hi and lo written once (5 passes)."""
    from tpu_multigrid_torch import precision
    from tpu_multigrid_torch.kernels import localref as KR
    hi = torch.randn(shape, generator=gen, device=DEVICE)
    lo = 1e-8 * torch.randn(shape, generator=gen, device=DEVICE)
    y = 1e-3 * torch.randn(shape, generator=gen, device=DEVICE)
    want = [hi.clone(), lo.clone()]
    precision._accumulate(want, (y,))
    got = [hi, lo]
    before = KR.LAUNCHES["comp_add_ext"]
    precision._accumulate(got, (y,), True)
    check(KR.LAUNCHES["comp_add_ext"] == before + 1 and got[0] is hi,
          f"{name}: not one in-place comp_add_ext launch")
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"{name}: comp_add_ext differs from the ds_add chain at {shape}")
    del want
    k = cuda_ms(lambda: KR.comp_add_ext((hi, lo), (y,)), reps=21)
    p = cuda_ms(lambda: precision.ds_add(hi, lo, y))
    times[name] = (k, p)
    bms, by = bound(5 * 4 * hi.numel(), DS_ADD * hi.numel())
    print(f"[times] {name:27s} {tuple(shape)}: kernel {k:.3f} ms "
          f"({100 * bms / k:.1f} % of the bound), plain chain {p:.3f} ms, "
          f"bound {bms:.3f} ms ({by}), bitwise equal  ({card})")
    del hi, lo, y, got
    torch.cuda.empty_cache()


def dist_times(card, times, work):
    """Each new kernel at the (1, 1) level-14 finest block beside its plain
    version: Jacobi 2 for K0-local, the ts triple with two addends for the
    compensated add (the iterate's update, in place on copies of its own,
    so that no copy is timed).  No PyTorch call computes a compensated
    residual, an exact-pair prolongation or a TwoSum add: no library
    time."""
    from tpu_multigrid_torch.kernels import local as KL
    from tpu_multigrid_torch.kernels import localref as KR
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(43)
    R, C, n = DIST_BLOCKS[0]
    origin = (-16, -256)
    u, b = (torch.randn((R, C), generator=gen, device=DEVICE)
            for _ in range(2))
    um = 1e-8 * torch.randn((R, C), generator=gen, device=DEVICE)
    ul = 1e-15 * torch.randn((R, C), generator=gen, device=DEVICE)
    ech = torch.randn(KL.coarse_shape(R, C), generator=gen, device=DEVICE)
    ecl = 1e-8 * ech
    cases = {k: v[0] for k, v in dist_cases(u, b, um, ul, ech, ecl, origin,
                                            n).items()
             if k != "residual_ext"}
    comps = [u.clone(), um.clone(), ul.clone()]
    cases["comp_add_ext"] = (lambda: KR.comp_add_ext(comps, (b, um)),
                             lambda: KR.comp_add_ext_plain(comps, (b, um)))
    work.update(dist_work(R, C, origin, n, 2))
    for name, (kern, plain) in cases.items():
        times[name] = (cuda_ms(kern), cuda_ms(plain))
        k, p = times[name]
        bms, by = bound(*work[name])
        print(f"[times] {name:27s} ({R}, {C}): kernel {k:.3f} ms, plain "
              f"{p:.3f} ms, bound {bms:.3f} ms ({by})  ({card})")
    del u, b, um, ul, ech, ecl, cases, comps
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 4l. The distributed fused FAS tier (dist/fas_pallas.py)
# ---------------------------------------------------------------------------

DFAS_LEVEL = 12
DFAS_BIG_LEVEL = 13
DFAS_FIXED = 4
DFAS_ENTRIES = ("smooth_restrict_ext", "prolong_smooth_ext",
                "prolong_smooth_ext_resnorm")


def dfas_door(family):
    """(door, its keyword arguments, entry prefix) of a family, at phase
    4i's problems: Bratu lam = 4, a = 1 + 2 u^2."""
    import tpu_multigrid_torch as tmg
    if family == "bratu":
        return tmg.solve_bratu, dict(lam=FAS_LAM), "fas_"
    return tmg.solve_quasilinear_diffusion, dict(gamma=FAS_GAMMA), "qfas_"


def dfas_levels(family, level, mesh_shape):
    """The level layout of a door's default config on a mesh."""
    from tpu_multigrid_torch.dist import pallas_cycle as PC
    return PC.pallas_level_sizes(fas_config(family, level, True), mesh_shape)


def dfas_blocks():
    """(R, C, n) of the blocks the FAS kernels are held at: the (1, 1)
    level-12 finest block and a 2 x 2 level-12 shard block."""
    out = []
    for shape in ((1, 1), (2, 2)):
        n, S = dfas_levels("bratu", DFAS_LEVEL, shape).sizes[0]
        out.append((S // shape[0] + 32, S // shape[1] + 512, n))
    return out


def dfas_counts(prefix, num_sharded, cycles):
    """Launches of ``cycles`` fused FAS V-cycles: K1f-local at every
    sharded level, K2f-local at every one but the finest, whose K2f-local
    carries the norm."""
    return expect(**{prefix + "smooth_restrict_ext": cycles * num_sharded,
                     prefix + "prolong_smooth_ext":
                         cycles * (num_sharded - 1),
                     prefix + "prolong_smooth_ext_resnorm": cycles})


def dfas_cases(family, u, b, ec, origin, n, sweeps):
    """{entry: (kernel call, plain call)} of a family's three entries on an
    extended block."""
    from tpu_multigrid_torch.kernels import localfas as KLF
    prefix, nl = fas_nl(family)
    extra = ((1.0 / n) ** 2,) if prefix == "fas_" else ()
    cases = {}
    for name in DFAS_ENTRIES:
        want = name.endswith("_resnorm")
        entry = prefix + name.replace("_resnorm", "")
        kern = getattr(KLF, entry)
        plain = getattr(KLF, entry + "_plain")
        args = ((u, b, origin, n, sweeps, 2.0 / 3.0) if "restrict" in name
                else (u, b, ec, origin, n, sweeps, 2.0 / 3.0))
        kw = {} if "restrict" in name else dict(want_resnorm=want)
        full = args + nl + extra
        cases[prefix + name] = (lambda k=kern, f=full, kw=kw: k(*f, **kw),
                                lambda p=plain, f=full, kw=kw: p(*f, **kw))
    return cases


def phase_dist_fas_kernels(errs):
    """K1f-local, K2f-local and K2f-local-resnorm, Bratu and quadratic,
    1-3 sweeps, bitwise against their plain versions over the whole
    arrays (the resnorm's sum to 1e-4), random u (scale 0.1), b and ec
    (scale 0.05), ghosts included, at the (1, 1) level-12 block and a 2 x 2
    level-12 shard block, four shard origins each; then the refusals of a
    caller's own nonlinearity and of a block outside the gate."""
    import tpu_multigrid_torch as tmg
    from tpu_multigrid_torch.kernels import local as KL
    from tpu_multigrid_torch.kernels import localfas as KLF
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(51)
    for R, C, n in dfas_blocks():
        u = 0.1 * torch.randn((R, C), generator=gen, device=DEVICE)
        b = torch.randn((R, C), generator=gen, device=DEVICE)
        ec = 0.05 * torch.randn(KL.coarse_shape(R, C), generator=gen,
                                device=DEVICE)
        rel = 0.0
        for origin in dist_origins(R, C):
            for family in ("bratu", "quadratic"):
                for sweeps in (1, 2, 3):
                    rel = max(rel, check_fas(errs, dfas_cases(
                        family, u, b, ec, origin, n, sweeps)))
        print(f"[dist-fas-kernels] ({R}, {C}) -> {KL.coarse_shape(R, C)}, "
              f"n={n}, origins {dist_origins(R, C)}, Bratu and quadratic, "
              f"1-3 sweeps: K1f-local (u', uc0, bc), K2f-local, "
              f"K2f-local-resnorm bitwise equal over the whole arrays; "
              f"resnorm sum rel {rel:.3g}")
        del u, b, ec
    torch.cuda.empty_cache()
    u = torch.zeros((288, 768), device=DEVICE)
    refusals = []
    for call in (lambda: KLF.fas_smooth_restrict_ext(
                     u, u, (0, 0), 500, 2, 0.5, torch.exp, torch.exp, 1e-6),
                 lambda: KLF.qfas_prolong_smooth_ext(
                     u[:280], u[:280], u, (0, 0), 500, 2, 0.5,
                     tmg.QuadraticCoefficient(1.0))):
        try:
            call()
            refusals.append(False)
        except ValueError:
            refusals.append(True)
    check(all(refusals), f"a caller's own phi / a block outside the gate "
                         f"was taken on the card: {refusals}")
    print("[dist-fas-kernels] a caller's own phi and a block outside "
          "fas_supported_local raise ValueError on the card")
    torch.cuda.synchronize()


def dfas_timed(path, fn):
    """One call on its path with launch counts set to 0 just before it:
    (result, seconds with set-up, peak device bytes above what was
    allocated before the call)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    res = drive(path, fn)
    secs = time.perf_counter() - t0
    return res, secs, torch.cuda.max_memory_allocated() - base


def dfas_cycle_times(mesh, family, level):
    """(ms of one fused FAS V-cycle with its norm, ms of its replicated
    plain tail alone, ms of the single-device kernel FAS cycle, the level
    layout) at the door's default config, CUDA events, median of 7, each
    from a zero guess; the tail's right-hand side is the constant forcing
    4 h^2 on its first level."""
    import dataclasses as dc
    import tpu_multigrid_torch as tmg
    from tpu_multigrid_torch.dist import fas_pallas as FP
    from tpu_multigrid_torch.dist import pallas_cycle as PC
    from tpu_multigrid_torch.dist.fas import build_replicated_tail
    cfg = fas_config(family, level, True)
    prefix, nl = fas_nl(family)
    kw = (dict(phi=None, dphi=None, a=nl[0]) if prefix == "qfas_"
          else dict(phi=nl[0], dphi=nl[1]))
    levels = PC.pallas_level_sizes(cfg, (1, 1))
    if prefix == "qfas_":
        tail = tmg.Hierarchy(tuple(tmg.QuasilinearFluxOp(n, S, nl[0], nl[0])
                                   for n, S in levels.sizes), None)
    else:
        tail = build_replicated_tail(levels, cfg, nl[0], nl[1],
                                     device=mesh.device)
    n0, S0 = levels.sizes[0]
    be = PC.rhs_ext(mesh, n0, S0, S0, 4.0, torch.float32)
    ue = torch.zeros_like(be)
    ms = cuda_ms(lambda: FP._fas_vcycle_pallas(
        mesh, levels, tail, cfg, 0, ue, be, want_norm=True, **kw))
    ns = levels.num_sharded
    n, S = levels.sizes[ns]
    bc = torch.zeros((S, S), device=DEVICE)
    bc[1:n, 1:n] = 4.0 / n ** 2
    uc = torch.zeros_like(bc)
    plain = dc.replace(cfg, use_kernels=False)
    tail_ms = cuda_ms(lambda: tmg.fas_cycle(tail, plain, uc, bc, k=ns))
    prob = fas_problem(family, cfg, 2)
    b = prob.rhs()
    u = torch.zeros_like(b)
    single_ms = cuda_ms(lambda: tmg.fas_cycle(prob.hierarchy, cfg, u, b))
    del prob, b, u, ue, be, uc, bc, tail
    torch.cuda.empty_cache()
    return ms, tail_ms, single_ms


def dfas_rank_program(mesh, level, cycles):
    """A rank of the 2 x 2 mesh: solve_bratu on the mesh, ``cycles`` fixed
    cycles, with its launch counts and seconds; rank 0 also returns the
    gathered iterate."""
    import tpu_multigrid_torch as tmg
    from tpu_multigrid_torch import dist, kernels
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = tmg.solve_bratu(level, lam=FAS_LAM, mesh=mesh, dist_path="pallas",
                          num_cycles=cycles)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    secs = time.perf_counter() - t0
    counts = kernels.launch_counts()
    u = dist.gather_full(mesh, res.u.contiguous()).cpu()
    return dict(hist=res.res_history, iterations=res.iterations,
                counts=counts, seconds=secs,
                u=u if mesh.rank == 0 else None)


def phase_dist_fas_slice(card, record_fas):
    """The three FAS doors' mesh route on a one-rank NCCL group at full
    width, and Bratu on a 2 x 2 gloo mesh sharing the card; each path with
    launch counts set to 0 just before it and checked exactly after."""
    import os
    import tempfile
    import torch.distributed as tdist
    import tpu_multigrid_torch as tmg
    from tpu_multigrid_torch import dist
    summary = {}
    tmp = tempfile.mkdtemp(prefix="chip-smoke-nccl-")
    tdist.init_process_group("nccl", init_method="file://" + os.path.join(
        tmp, "store"), world_size=1, rank=0)
    try:
        mesh = dist.make_grid_mesh((1, 1))
        print(f"[dist-fas] one-rank {mesh.backend} group, mesh {mesh.shape} "
              f"on {mesh.device}")
        # 1-4. Bratu and quasilinear at 4097^2 beside phase 4i's
        # single-device kernel route, and at 8193^2.
        for family, level in (("bratu", DFAS_LEVEL),
                              ("quadratic", DFAS_LEVEL),
                              ("bratu", DFAS_BIG_LEVEL),
                              ("quadratic", DFAS_BIG_LEVEL)):
            door, kw, prefix = dfas_door(family)
            tag = f"dist-fas-{'bratu' if family == 'bratu' else 'quasi'}"
            path = f"{tag}-{level}"
            res, secs, peak = dfas_timed(path, lambda: door(
                level, mesh=mesh, dist_path="pallas", **kw))
            levels = dfas_levels(family, level, (1, 1))
            got = PATH_COUNTS[path]
            want = dfas_counts(prefix, levels.num_sharded, res.iterations)
            check(got == want, f"{path} launches {nonzero(got)}, expected "
                               f"{nonzero(want)}")
            check(bool(torch.isfinite(res.u).all())
                  and (res.converged or res.stalled)
                  and tuple(res.u.shape) == (levels.sizes[0][1],) * 2,
                  f"{path}: {var_state(res)}, shape {tuple(res.u.shape)}")
            ms, tail_ms, single_ms = dfas_cycle_times(mesh, family, level)
            ns = levels.num_sharded
            print(f"[dist-fas] {door.__name__}({level}, mesh=(1, 1), "
                  f"dist_path='pallas'): {var_state(res)} after "
                  f"{res.iterations} iterations, history {hist_str(res)}; "
                  f"seconds for one call {secs:.3f}; peak device memory of "
                  f"the call {peak / 2 ** 30:.2f} GiB; levels "
                  f"{levels.sizes[:4]}... ({ns} sharded); launches "
                  f"{nonzero(got)}  ({card})")
            print(f"[dist-fas]   fused FAS V-cycle with its norm {ms:.3f} ms;"
                  f" its replicated plain tail from {levels.sizes[ns][1]}^2 "
                  f"alone {tail_ms:.3f} ms ({100 * tail_ms / ms:.1f} %); the "
                  f"single-device kernel FAS cycle {single_ms:.3f} ms  "
                  f"({card})")
            line = dict(iterations=res.iterations, state=var_state(res),
                        seconds=secs, peak_gib=peak / 2 ** 30,
                        ms_per_cycle=ms, tail_ms=tail_ms,
                        single_ms=single_ms, sharded=ns)
            if level == DFAS_LEVEL:
                ref = record_fas[f"fas-{tag[9:]}-{level}"]
                same = (abs(res.iterations - ref["iterations"]) <= 1
                        or var_state(res) == ref["state"] == "stalled")
                print(f"[dist-fas]   phase 4i's single-device kernel route: "
                      f"{ref['state']} after {ref['iterations']} "
                      f"iterations; the mesh route: {var_state(res)} after "
                      f"{res.iterations}")
                check(same, f"{path}: {res.iterations} iterations "
                            f"({var_state(res)}) against the single-device "
                            f"route's {ref['iterations']} ({ref['state']})")
            summary[path] = line
            del res
            torch.cuda.empty_cache()

        # 5. Bratu on a 2 x 2 gloo mesh sharing the card against the (1, 1)
        # NCCL run, 4 fixed cycles.
        n = 2 ** DFAS_LEVEL
        phys = (slice(0, n + 1), slice(0, n + 1))
        fixed = f"dist-fas-bratu-{DFAS_LEVEL}-fixed"
        r1 = drive(fixed, lambda: tmg.solve_bratu(
            DFAS_LEVEL, lam=FAS_LAM, mesh=mesh, dist_path="pallas",
            num_cycles=DFAS_FIXED))
        lv1 = dfas_levels("bratu", DFAS_LEVEL, (1, 1))
        want = dfas_counts("fas_", lv1.num_sharded, DFAS_FIXED)
        check(PATH_COUNTS[fixed] == want, f"{fixed} launches "
              f"{nonzero(PATH_COUNTS[fixed])}, expected {nonzero(want)}")
        u1 = dist.gather_full(mesh, r1.u).cpu()
        h1 = np.asarray(r1.res_history)
        del r1
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out = dist.run_on_mesh(dfas_rank_program, (2, 2), backend="gloo",
                               device=DEVICE + ":0",
                               args=(DFAS_LEVEL, DFAS_FIXED))
        wall = time.perf_counter() - t0
        o = out[0]
        lv4 = dfas_levels("bratu", DFAS_LEVEL, (2, 2))
        path = f"dist-fas-bratu-{DFAS_LEVEL}-2x2"
        total = {k: sum(r["counts"][k] for r in out) for k in o["counts"]}
        PATH_COUNTS[path] = total
        want = {k: 4 * v for k, v in dfas_counts(
            "fas_", lv4.num_sharded, DFAS_FIXED).items()}
        check(total == want, f"{path} launches {nonzero(total)}, expected "
                             f"{nonzero(want)}")
        for r in out[1:]:
            check(torch.equal(r["hist"], o["hist"]),
                  f"{path}: the ranks disagree")
        h4 = np.asarray(o["hist"])
        ua, ub = o["u"][phys].numpy(), u1[phys].numpy()
        hrel = float(np.max(np.abs(h4 / h1 - 1)))
        close = np.allclose(ua, ub, rtol=1e-5, atol=1e-6)
        bitwise = bool(np.array_equal(ua, ub))
        print(f"[dist-fas] 2 x 2 gloo mesh on one card, solve_bratu("
              f"{DFAS_LEVEL}), {DFAS_FIXED} cycles (levels {lv4.sizes[:2]}..."
              f", {lv4.num_sharded} sharded; the (1, 1) run "
              f"{lv1.sizes[:2]}...): history rel diff to (1, 1) {hrel:.3e} "
              f"(history {', '.join(f'{x:.4e}' for x in h4)}); u within "
              f"rtol 1e-5 / atol 1e-6 of the (1, 1) run: {close}, bitwise "
              f"equal: {bitwise} (max |du| {float(np.abs(ua - ub).max()):.3e}"
              f"); seconds per rank {[round(r['seconds'], 3) for r in out]}, "
              f"{wall:.3f} s with the ranks' start (not a multi-card time: "
              f"the ranks share one card and stage every strip through "
              f"host memory)  ({card})")
        check(hrel <= 1e-4 and close, f"{path} against (1, 1): history rel "
              f"diff {hrel}, u close {close}")
        summary[path] = dict(history_rel_diff=hrel, u_bitwise=bitwise,
                             seconds=o["seconds"], wall=wall)
    finally:
        tdist.destroy_process_group()
    torch.cuda.empty_cache()
    return summary


def dfas_work(prefix, R, C, origin, n, sweeps):
    """(bytes, operations) of a family's extended-block FAS kernels, by
    fas_work's rule: u over its reach (the live cells for K2f-local, which
    masks u + P e_c first), b over the live cells, e_c over the coarse
    reach, every output in full (u', and uc0 and bc for K1f-local); the
    operations count the live cells (a quarter of them for the coarse
    right-hand side)."""
    cells, live, reach, creach = dist_cells(R, C, origin, n)
    ccells = (R // 2 + 16) * (C // 2 + 256)
    key = (prefix, "")
    sweep = sweeps * FSTEP[key] * live
    k2 = 4 * (2 * live + creach + cells)
    return {
        prefix + "smooth_restrict_ext": (
            4 * (reach + live + cells + 2 * ccells),
            sweep + FRES[key] * live + (FW + FCAP[key]) * (live // 4)),
        prefix + "prolong_smooth_ext": (k2, sweep + PRO * live),
        prefix + "prolong_smooth_ext_resnorm": (
            k2 + 4, sweep + (PRO + FRES[key] + 2) * live)}


def dist_fas_times(card, times, work):
    """Each extended-block FAS kernel at the (1, 1) level-12 finest block
    (origin (-16, -256)), 2 sweeps, beside its plain version.  No PyTorch
    call smooths nonlinearly: no library time."""
    from tpu_multigrid_torch.kernels import local as KL
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(52)
    R, C, n = dfas_blocks()[0]
    origin = (-16, -256)
    u = 0.1 * torch.randn((R, C), generator=gen, device=DEVICE)
    b = torch.randn((R, C), generator=gen, device=DEVICE)
    ec = 0.05 * torch.randn(KL.coarse_shape(R, C), generator=gen,
                            device=DEVICE)
    for family in ("bratu", "quadratic"):
        prefix = fas_nl(family)[0]
        work.update(dfas_work(prefix, R, C, origin, n, 2))
        for name, (kern, plain) in dfas_cases(family, u, b, ec, origin, n,
                                              2).items():
            times[name] = (cuda_ms(kern), cuda_ms(plain))
            k, p = times[name]
            bms, by = bound(*work[name])
            print(f"[times] {name:32s} ({R}, {C}): kernel {k:.3f} ms, plain "
                  f"{p:.3f} ms, bound {bms:.3f} ms ({by})  ({card})")
    del u, b, ec
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 4m. The distributed fused 3D tier (dist/pallas_cycle3.py)
# ---------------------------------------------------------------------------

DIST3_LEVEL = 9
DIST3_SHIFT_LEVEL = 8
DIST3_MESH_LEVEL = 8
DIST3_FIXED = 4
DIST3_TOL = 1e-5
# The blocks the kernels are held at: the (1, 1) level-9 finest block and
# its coarse block, and a 2 x 2 level-8 shard block (lz = ly = 160).
DIST3_BLOCKS = [((576, 576, 640), (304, 304, 384), 512),
                ((192, 192, 384), (112, 112, 256), 256)]
# (K1 smoother, omega, sweeps), (K2 ...): Chebyshev (3, 2), RB-GS (1, 1),
# and RB-GS (5, 5), whose K1 (12 window layers) splits into two launches.
DIST3_SMOOTHERS = [(("jacobi", 3), ("jacobi", 2)), (("rbgs", 1), ("rbgs", 1)),
                   (("rbgs", 5), ("rbgs", 5))]
DIST3_ENTRIES = ("smooth_restrict_ext3", "prolong_smooth_ext3",
                 "prolong_smooth_ext3_resnorm")


def dist3_origins(shape):
    """The global (oz, oy) of the four blocks of a 2 x 2 mesh (one for the
    (1, 1) block)."""
    lz, ly = shape[0] - 32, shape[1] - 32
    if lz >= 512:
        return [(-16, -16)]
    return [(-16, -16), (lz - 16, -16), (-16, ly - 16), (lz - 16, ly - 16)]


def dist3_omega(sm, sweeps):
    from tpu_multigrid_torch.core import ops
    return ops.chebyshev_omegas(sweeps, 0.4) if sm == "jacobi" else 1.0


def dist3_cases(u, b, ec, coef, origin, n, k1, k2):
    """{entry: (kernel call, plain call)} of K1_3-ext, K2_3-local and
    K2_3-local-resnorm, or their var forms on ``coef``; K1 with smoother
    ``k1`` = (name, sweeps), K2 with ``k2``."""
    from tpu_multigrid_torch.kernels import transfer3d as T3
    from tpu_multigrid_torch.kernels import vartransfer3d as V3
    mod, pre = (T3, "") if coef is None else (V3, "var_")
    cf = () if coef is None else (coef,)
    (s1, w1), (s2, w2) = k1, k2
    a1 = (u, b) + cf + (origin, n, tuple(ec.shape), w1, s1,
                        dist3_omega(s1, w1))
    a2 = (u, b, ec) + cf + (origin, n, w2, s2, dist3_omega(s2, w2))
    cases = {}
    for name in DIST3_ENTRIES:
        fn = pre + name.replace("_resnorm", "")
        args, kw = (a1, {}) if "restrict" in name else (
            a2, dict(want_resnorm=name.endswith("_resnorm")))
        cases[pre + name] = (
            lambda f=getattr(mod, fn), a=args, kw=kw: f(*a, **kw),
            lambda f=getattr(mod, fn + "_plain"), a=args, kw=kw: f(*a, **kw))
    return cases


def phase_dist3_kernels(errs):
    """K1_3-ext, K2_3-local and K2_3-local-resnorm, and their var forms on
    3, 4 and 6 planes, bitwise against their plain versions over the whole
    arrays (the owned resnorm sums to 1e-4), random u, b, ec and
    coefficients, ghosts included, at the (1, 1) level-9 block and a 2 x 2
    level-8 shard block, four origins, Chebyshev (3, 2), RB-GS (1, 1) and
    RB-GS (5, 5) (K1 split into two launches); then a block outside the gate
    refused on the card."""
    from tpu_multigrid_torch.kernels import transfer3d as T3
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(61)
    for shape, shape_c, n in DIST3_BLOCKS:
        u, b = (torch.randn(shape, generator=gen, device=DEVICE)
                for _ in range(2))
        ec = torch.randn(shape_c, generator=gen, device=DEVICE)
        rel = 0.0
        for nplanes in (0, 3, 4, 6):
            coef = None if not nplanes else 0.5 + torch.rand(
                (nplanes,) + shape, generator=gen, device=DEVICE)
            for origin in dist3_origins(shape):
                for k1, k2 in DIST3_SMOOTHERS:
                    rel = max(rel, check_fas(errs, dist3_cases(
                        u, b, ec, coef, origin, n, k1, k2)))
            del coef
            torch.cuda.empty_cache()
        print(f"[dist3-kernels] {shape} -> {shape_c}, n={n}, origins "
              f"{dist3_origins(shape)}, Chebyshev (3, 2), RB-GS (1, 1) and "
              f"(5, 5): K1_3-ext (u', the whole coarse block), K2_3-local, "
              f"K2_3-local-resnorm and their var forms on 3, 4 and 6 planes "
              f"bitwise equal over the whole arrays; resnorm sum rel "
              f"{rel:.3g}")
        del u, b, ec
        torch.cuda.empty_cache()
    u = torch.zeros((192, 184, 384), device=DEVICE)
    try:
        T3.smooth_restrict_ext3(u, u, (-16, -16), 256, (112, 108, 256), 1)
        refused = False
    except ValueError:
        refused = True
    check(refused, "a block outside supported_local3 was taken on the card")
    print("[dist3-kernels] a block outside supported_local3 raises "
          "ValueError on the card")
    torch.cuda.synchronize()


def dist3_counts(pre, num_sharded, cycles):
    """Launches of ``cycles`` fused 3D cycles: K1-ext at every sharded
    level, K2-local at every one but the finest, whose K2 carries the
    norm."""
    return expect(**{pre + "smooth_restrict_ext3": cycles * num_sharded,
                     pre + "prolong_smooth_ext3": cycles * (num_sharded - 1),
                     pre + "prolong_smooth_ext3_resnorm": cycles})


def dist3_solvers():
    """(tag, solver, keyword arguments, single-device problem class and its
    keyword arguments, level, config, entry prefix, host builder) of the
    four 3D solves: Poisson and phase 4g's coefficient at 513^3, with
    phase 4g's shift at 257^3, phase 4g's winds at 257^3."""
    import tpu_multigrid_torch as tmg
    from tpu_multigrid_torch import dist
    coef = dict(coefficient=var3_coefficient)
    shift = dict(coefficient=var3_coefficient, shift=var3_shift)
    winds = dict(eps=0.01, **WINDS3)
    return [
        ("dist3-poisson-9", dist.sharded_solve_pallas3, {},
         tmg.Poisson3DProblem, {}, DIST3_LEVEL, config3(True, DIST3_LEVEL),
         "", "build_pallas_poisson3"),
        ("dist3-var-9", dist.sharded_solve_pallas_var3, coef,
         tmg.Diffusion3DProblem, coef, DIST3_LEVEL,
         var3_config(True, DIST3_LEVEL), "var_", "build_pallas_diffusion3"),
        ("dist3-shift-8", dist.sharded_solve_pallas_var3, shift,
         tmg.Diffusion3DProblem, shift, DIST3_SHIFT_LEVEL,
         var3_config(True, DIST3_SHIFT_LEVEL), "var_",
         "build_pallas_diffusion3"),
        ("dist3-conv-8", dist.sharded_solve_pallas_conv3, winds,
         tmg.ConvectionDiffusion3DProblem, winds, CONV3_LEVEL,
         conv3_config(True), "var_", "build_pallas_convection3")]


def dist3_single(cls, kw, cfg):
    """The single-device kernel route's problem at the front door's padded
    layout."""
    return cls(cfg, align=16, min_pad_level=0, lane_align=128,
               device=DEVICE, **kw)


def dist3_cycle_ms(mesh, cfg, levels, hier, coefs):
    """(ms of one fused 3D V-cycle with its norm from a zero guess, ms of
    its replicated plain tail alone), CUDA events, median of 7; the tail's
    right-hand side is the constant 6 h^2 on its first level."""
    import dataclasses as dc
    from tpu_multigrid_torch.cycles import _coarsest_solve
    from tpu_multigrid_torch.dist import pallas_cycle3 as P3
    from tpu_multigrid_torch.dist.shard_cycle import _replicated_cycle
    n0, S0, Sx0 = levels.sizes[0]
    be = P3.rhs_ext3(mesh, n0, S0, S0, Sx0, 6.0)
    ue = torch.zeros_like(be)
    ms = cuda_ms(lambda: P3._vcycle_pallas3(mesh, levels, hier, cfg, 0, ue,
                                            be, want_norm=True, coefs=coefs))
    ns = levels.num_sharded
    n, S, Sx = levels.sizes[ns]
    bc = torch.zeros((S, S, Sx), device=DEVICE)
    bc[1:n, 1:n, 1:n] = 6.0 / n ** 2
    uc = torch.zeros_like(bc)
    plain = dc.replace(cfg, use_kernels=False)
    if ns == len(levels.sizes) - 1:
        tail_ms = cuda_ms(lambda: _coarsest_solve(hier, plain, uc, bc))
    else:
        tail_ms = cuda_ms(lambda: _replicated_cycle(hier, plain, ns, uc, bc))
    del be, ue, bc, uc
    return ms, tail_ms


def dist3_rank_program(mesh, level, cycles):
    """A rank of the 2 x 2 mesh: the Poisson solve, ``cycles`` fixed cycles,
    with its launch counts and seconds; rank 0 also returns the gathered
    iterate."""
    from tpu_multigrid_torch import dist, kernels
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res, lv = dist.sharded_solve_pallas3(config3(True, level), mesh,
                                         num_cycles=cycles, tol=0.0)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    secs = time.perf_counter() - t0
    counts = kernels.launch_counts()
    u = dist.gather_full(mesh, res.u.contiguous()).cpu()
    return dict(hist=res.res_history, counts=counts, seconds=secs,
                sizes=lv.sizes, num_sharded=lv.num_sharded,
                u=u if mesh.rank == 0 else None)


def phase_dist3_slice(card, prob_var3):
    """The three 3D solvers on a one-rank NCCL group at full width beside
    the single-device kernel route (phase 4g's 513^3 problem for the var
    solve), and Poisson on a 2 x 2 gloo mesh sharing the card; each path
    with launch counts set to 0 just before it and checked exactly after."""
    import os
    import tempfile
    import torch.distributed as tdist
    import tpu_multigrid_torch as tmg
    from tpu_multigrid_torch import dist
    from tpu_multigrid_torch.cycles import cycle_with_norm
    from tpu_multigrid_torch.dist import pallas_cycle3 as P3
    summary = {}
    tmp = tempfile.mkdtemp(prefix="chip-smoke-nccl-")
    tdist.init_process_group("nccl", init_method="file://" + os.path.join(
        tmp, "store"), world_size=1, rank=0)
    try:
        mesh = dist.make_grid_mesh3((1, 1))
        print(f"[dist3] one-rank {mesh.backend} group, mesh {mesh.shape} on "
              f"{mesh.device}")
        for (tag, solver, kw, cls, pkw, level, cfg, pre,
             builder) in dist3_solvers():
            n = 2 ** level
            phys = (slice(1, n), slice(1, n), slice(1, n))
            # 1. Until tol through the solver, its set-up included.
            path = tag + "-tol"
            build = HostSetup("tpu_multigrid_torch.dist.pallas_cycle3",
                              builder)
            res, secs, host, peak = front_door3(path, lambda: solver(
                cfg, mesh, tol=DIST3_TOL, **kw)[0], build)
            levels, hier = build.result
            ns = levels.num_sharded
            it = res.iterations
            want = dist3_counts(pre, ns, it)
            check(PATH_COUNTS[path] == want, f"{path} launches "
                  f"{nonzero(PATH_COUNTS[path])}, expected {nonzero(want)}")
            check(ns >= 2 and tuple(res.u.shape) == (
                levels.sizes[0][1],) * 2 + (levels.sizes[0][2],)
                and bool(torch.isfinite(res.u).all())
                and (res.converged or res.stalled),
                f"{path}: {ns} sharded, shape {tuple(res.u.shape)}, "
                f"{var_state(res)}")
            prob = (prob_var3 if tag == "dist3-var-9"
                    else dist3_single(cls, pkw, cfg))
            ref = tmg.solve_until_tol(prob.hierarchy, cfg, prob.rhs(),
                                      tol=DIST3_TOL)
            print(f"[dist3] {solver.__name__}({level}) {tag}, until tol "
                  f"{DIST3_TOL:g}: levels {levels.sizes[:3]}... ({ns} "
                  f"sharded); {var_state(res)} after {it} iterations, "
                  f"history {hist_str(res)}; the single-device kernel route "
                  f"{var_state(ref)} after {ref.iterations}; seconds for one "
                  f"call {secs:.3f} (host build {host:.3f}); peak device "
                  f"memory of the call {peak / 2 ** 30:.2f} GiB; launches "
                  f"{nonzero(PATH_COUNTS[path])}  ({card})")
            check(abs(it - ref.iterations) <= 1, f"{path}: {it} iterations "
                  f"({var_state(res)}), single-device {ref.iterations} "
                  f"({var_state(ref)})")
            line = dict(iterations=it, state=var_state(res),
                        single_iterations=ref.iterations,
                        single_state=var_state(ref), seconds=secs,
                        host_seconds=host, peak_gib=peak / 2 ** 30,
                        sharded=ns)
            del res, ref
            torch.cuda.empty_cache()
            # 2. Two fixed cycles on the same build against the single-
            # device kernel route.
            path = tag + "-fixed"
            if pre:
                res = drive(path, lambda: P3._sharded_solve_var3_from(
                    cfg, mesh, levels, hier, forcing=6.0, tol=0.0,
                    max_cycles=2, num_cycles=2, halo="lean")[0])
            else:
                res = drive(path, lambda: P3._solve(
                    mesh, cfg, levels, hier, (), forcing=6.0, tol=0.0,
                    max_cycles=2, num_cycles=2, halo="lean")[0])
            want = dist3_counts(pre, ns, 2)
            check(PATH_COUNTS[path] == want, f"{path} launches "
                  f"{nonzero(PATH_COUNTS[path])}, expected {nonzero(want)}")
            ref = tmg.solve_fixed(prob.hierarchy, cfg, prob.rhs(), 2)
            a, w = res.u[phys], ref.u[phys]
            du = float((a - w).abs().max()) / float(w.abs().max())
            print(f"[dist3]   2 fixed cycles: history {hist_str(res)}, the "
                  f"single-device kernel route {hist_str(ref)}; max |u - "
                  f"u_single| / max|u_single| {du:.3e}")
            check(du <= 1e-4, f"{path}: u differs from the single-device "
                              f"route by {du} of max|u|")
            line["fixed_du"] = du
            del res, ref, a, w
            torch.cuda.empty_cache()
            # 3. ms per fused V-cycle at 513^3, and its tail's share.
            if level == DIST3_LEVEL:
                coefs, hier_d = (), hier.to(mesh.device)
                if pre:
                    coefs, hier_d = P3._split_pallas_var3(levels, hier, mesh)
                ms, tail_ms = dist3_cycle_ms(mesh, cfg, levels, hier_d,
                                             coefs)
                b = prob.rhs()
                u0 = torch.zeros_like(b)
                single_ms = cuda_ms(lambda: cycle_with_norm(
                    prob.hierarchy, cfg, u0, b))
                print(f"[dist3]   fused 3D V-cycle with its norm {ms:.3f} ms"
                      f"; its replicated plain tail from "
                      f"{levels.sizes[ns][0] + 1}^3 alone {tail_ms:.3f} ms "
                      f"({100 * tail_ms / ms:.1f} %); the single-device "
                      f"kernel V-cycle with its norm {single_ms:.3f} ms "
                      f"({ms / single_ms:.3f} x)  ({card})")
                line.update(ms_per_cycle=ms, tail_ms=tail_ms,
                            single_ms=single_ms)
                del hier_d, coefs, b, u0
            summary[tag] = line
            del prob, levels, hier, build
            torch.cuda.empty_cache()

        # 4. The 2 x 2 mesh on the one card (gloo, strips staged through
        # host memory) against the (1, 1) NCCL run.
        level = DIST3_MESH_LEVEL
        n = 2 ** level
        phys = (slice(0, n + 1), slice(0, n + 1), slice(0, n + 1))
        path = f"dist3-poisson-{level}-fixed"
        r1, lv1 = drive(path, lambda: dist.sharded_solve_pallas3(
            config3(True, level), mesh, num_cycles=DIST3_FIXED, tol=0.0))
        want = dist3_counts("", lv1.num_sharded, DIST3_FIXED)
        check(PATH_COUNTS[path] == want, f"{path} launches "
              f"{nonzero(PATH_COUNTS[path])}, expected {nonzero(want)}")
        u1 = dist.gather_full(mesh, r1.u).cpu()
        h1 = np.asarray(r1.res_history)
        del r1
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out = dist.run_on_mesh(dist3_rank_program, (2, 2), backend="gloo",
                               device=DEVICE + ":0",
                               args=(level, DIST3_FIXED))
        wall = time.perf_counter() - t0
        o = out[0]
        path = f"dist3-poisson-{level}-2x2"
        total = {k: sum(r["counts"][k] for r in out) for k in o["counts"]}
        PATH_COUNTS[path] = total
        want = {k: 4 * v for k, v in dist3_counts(
            "", o["num_sharded"], DIST3_FIXED).items()}
        check(o["num_sharded"] == lv1.num_sharded == 2 and total == want,
              f"{path}: {o['num_sharded']} sharded, launches "
              f"{nonzero(total)}, expected {nonzero(want)}")
        for r in out[1:]:
            check(torch.equal(r["hist"], o["hist"]),
                  f"{path}: the ranks disagree")
        h4 = np.asarray(o["hist"])
        ua, ub = o["u"][phys].numpy(), u1[phys].numpy()
        hrel = float(np.max(np.abs(h4 / h1 - 1)))
        close = np.allclose(ua, ub, rtol=1e-5, atol=1e-6)
        bitwise = bool(np.array_equal(ua, ub))
        print(f"[dist3] 2 x 2 gloo mesh on one card, sharded_solve_pallas3("
              f"{level}), {DIST3_FIXED} cycles (levels {o['sizes'][:2]}..., "
              f"{o['num_sharded']} sharded; the (1, 1) run "
              f"{lv1.sizes[:2]}...): history rel diff to (1, 1) {hrel:.3e} "
              f"(history {', '.join(f'{x:.4e}' for x in h4)}); u within "
              f"rtol 1e-5 / atol 1e-6 of the (1, 1) run: {close}, bitwise "
              f"equal: {bitwise} (max |du| {float(np.abs(ua - ub).max()):.3e}"
              f"); seconds per rank {[round(r['seconds'], 3) for r in out]}, "
              f"{wall:.3f} s with the ranks' start (not a multi-card time: "
              f"the ranks share one card and stage every strip through host "
              f"memory)  ({card})")
        check(hrel <= 1e-4 and close, f"{path} against (1, 1): history rel "
              f"diff {hrel}, u close {close}")
        summary[path] = dict(history_rel_diff=hrel, u_bitwise=bitwise,
                             seconds=o["seconds"], wall=wall)
    finally:
        tdist.destroy_process_group()
    torch.cuda.empty_cache()
    return summary


def dist3_cells(shape, origin, n):
    """(cells, live, reach, coarse reach) of an extended 3D block: the live
    cells (global 1..n-1), the cells their stencils read (0..n), and the
    coarse cells the prolongation of the live cells reads."""
    def span(o, size, lo, hi):
        return max(0, min(o + size - 1, hi) - max(o, lo) + 1)
    Rz, Ry, Sx = shape
    sz, sy = span(origin[0], Rz, 0, n), span(origin[1], Ry, 0, n)
    sx = span(0, Sx, 0, n)
    live = (span(origin[0], Rz, 1, n - 1) * span(origin[1], Ry, 1, n - 1)
            * span(0, Sx, 1, n - 1))
    creach = (sz // 2 + 1) * (sy // 2 + 1) * (sx // 2 + 1)
    return Rz * Ry * Sx, live, sz * sy * sx, creach


def dist3_work(shape, shape_c, origin, n, nplanes, sm1, s1, sm2, s2):
    """(bytes, operations) of the three entries (or their var forms), by
    times3d's / var3_work's rule at a block: u over its reach (in full for
    RB-GS, which keeps u outside the live cells; the live cells for K2,
    which masks u + P e_c first), b over the live cells, each coefficient
    plane over the reach, e_c over the coarse reach, every output in full;
    the operations count the live cells (an eighth of them for the
    restriction)."""
    cells, live, reach, creach = dist3_cells(shape, origin, n)
    ccells = shape_c[0] * shape_c[1] * shape_c[2]
    clive = live // 8
    extra = 1 if nplanes == 4 else 0
    if nplanes:
        step = {"jacobi": VJAC3 + extra, "rbgs": 2 * (VHALF3 + extra / 2)}
        res, planes = VRES3 + extra, nplanes * reach
    else:
        step, res, planes = {"jacobi": JAC3, "rbgs": 2 * HALF3}, RES3, 0
    u1 = cells if sm1 == "rbgs" else reach
    pre = "var_" if nplanes else ""
    k2 = 4 * (2 * live + planes + creach + cells)
    return {
        pre + "smooth_restrict_ext3": (
            4 * (u1 + live + planes + cells + ccells),
            (s1 * step[sm1] + res) * live + FW3 * clive),
        pre + "prolong_smooth_ext3": (k2, (PRO3 + s2 * step[sm2]) * live),
        pre + "prolong_smooth_ext3_resnorm": (
            k2 + 4, (PRO3 + s2 * step[sm2] + res + 2) * live)}


def dist3_times(card, times, work):
    """Each extended-block 3D kernel at the (1, 1) level-9 block (origin
    (-16, -16)) beside its plain version, Chebyshev (3, 2): the constant
    stencil and the var forms on 3 planes (the records) and on 4 and 6
    planes.  No PyTorch call smooths a stencil: no library time."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(62)
    shape, shape_c, n = DIST3_BLOCKS[0]
    origin = (-16, -16)
    u, b = (torch.randn(shape, generator=gen, device=DEVICE)
            for _ in range(2))
    ec = torch.randn(shape_c, generator=gen, device=DEVICE)
    for nplanes in (0, 3, 4, 6):
        coef = None if not nplanes else 0.5 + torch.rand(
            (nplanes,) + shape, generator=gen, device=DEVICE)
        wk = dist3_work(shape, shape_c, origin, n, nplanes, "jacobi", 3,
                        "jacobi", 2)
        for name, (kern, plain) in dist3_cases(
                u, b, ec, coef, origin, n, ("jacobi", 3),
                ("jacobi", 2)).items():
            kp = (cuda_ms(kern), cuda_ms(plain))
            bms, by = bound(*wk[name])
            if nplanes in (0, 3):
                times[name], work[name] = kp, wk[name]
            print(f"[times] {name:32s} {shape} {nplanes or 7}"
                  f"{' planes' if nplanes else '-point'}, Chebyshev (3, 2):"
                  f" kernel {kp[0]:.3f} ms, plain {kp[1]:.3f} ms, bound "
                  f"{bms:.3f} ms ({by})  ({card})")
        del coef
        torch.cuda.empty_cache()
    del u, b, ec
    torch.cuda.empty_cache()


# Float32 operations per node, counted from the 3D kernels' sources: a
# Jacobi step of the 7-point stencil (6 adds, 2 multiplies, 1 add), an RB-GS
# half-step on the half of the nodes it updates (7 each), the residual (8);
# the 19-point stencil's Jacobi step (18 multiplies, 17 adds, and 4); the
# 3D full weighting per coarse node (9 x-blurs, 3 y-blurs, 1 z-blur of 3
# each, a halving: 40); trilinear prolongation plus the add per fine node
# (7 on average); the 7-point ds / ts compensated residuals (97 / 180,
# TwoSum = 6: compsum.cuh's ds_resid3 / ts_resid3).
JAC3, HALF3, RES3, JAC19, FW3, PRO3 = 9, 3.5, 8, 39, 40, 7
DS3, TS3 = 97, 180


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
    # The refinement loop's other steps: one ds residual (a kernel that
    # replaces no TPU kernel: the JAX package evaluates it in jnp) and one
    # ds_add (plain torch) per refined iteration.
    from tpu_multigrid_torch import precision
    from tpu_multigrid_torch.kernels import compres
    lo = interior_randn3(shape, n, gen, 1e-7)
    for name, kern, plain, arrays in (
            ("ds_residual3", lambda: compres.ds_residual3(b, u, lo, n),
             lambda: precision.ds_residual(b, u, lo, n), 2),
            ("ts_residual3", lambda: compres.ts_residual3(b, u, lo, lo, n),
             lambda: precision.ts_residual(b, u, lo, lo, n), 3)):
        times[name] = (cuda_ms(kern), cuda_ms(plain))
        k, p = times[name]
        bms, by = bound(4 * (inner + arrays * reach + cells),
                        (DS3 if arrays == 2 else TS3) * inner)
        full, _ = bound(4 * (arrays + 2) * cells, 0)
        print(f"[times] {name:27s} {shape}: kernel {k:.3f} ms, plain {p:.3f} "
              f"ms, bound {bms:.3f} ms ({by}; {full:.3f} ms on full "
              f"arrays)  ({card})")
    times["ds_add3"] = cuda_ms(lambda: precision.ds_add(u, lo, b))
    print(f"[times] {'ds_add3':27s} {shape}: plain torch only "
          f"{times['ds_add3']:.3f} ms  ({card})")
    del u, b, ec, lo
    torch.cuda.empty_cache()
    comp_add_times(card, times, shape, gen, "comp_add_ds3")


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
    var_residual3_times(card, prob, times, gen)


def var_residual3_times(card, prob, times, gen):
    """The refinement loop's float64 residual beside its plain body, on the
    hierarchy's planes, with its bound: b, u_hi, u_lo, tz, ty, tx read and
    r written, 7 passes of the padded array, or 6 over the (n+1)^3 cells
    the interior reads and r in full."""
    from tpu_multigrid_torch import precision
    from tpu_multigrid_torch.kernels import compres
    op, b, u_hi, u_lo = var_residual3_inputs(prob, gen, False)
    cells, reach = math.prod(op.grid_shape), (op.n + 1) ** 3
    kp = (cuda_ms(lambda: compres.ds_residual_var3(op, b, u_hi, u_lo)),
          cuda_ms(lambda: precision.ds_residual_var3_plain(op, b, u_hi,
                                                           u_lo)))
    times["ds_residual_var3"] = kp
    full, _ = bound(4 * 7 * cells, 0)
    read, _ = bound(4 * (6 * reach + cells), 0)
    print(f"[times] {'ds_residual_var3':27s} {op.grid_shape}: kernel "
          f"{kp[0]:.3f} ms, plain {kp[1]:.3f} ms, bound {full:.3f} ms on "
          f"full arrays ({100 * full / kp[0]:.1f} %), {read:.3f} ms on the "
          f"cells read ({100 * read / kp[0]:.1f} %) (bytes)  ({card})")
    del op, b, u_hi, u_lo
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


def phase_times(card, prob_var, prob_var3, prob_aniso):
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
    # The compensated adds of the refinement loop as plain torch chains (the
    # plain path's; cycle_ds runs ds_add twice per ds level, the ts loop
    # ts_add twice per iteration), then the kernel route's comp_add_ext.
    for name, fn in (("ds_add", lambda: precision.ds_add(u, b, u)),
                     ("ts_add", lambda: precision.ts_add(u, b, b, u))):
        times[name] = cuda_ms(fn)
        print(f"[times] {name:23s} S={S}: plain torch only "
              f"{times[name]:.3f} ms  ({card})")
    comp_add_times(card, times, (PAIRS[-1][0],) * 2, gen, "comp_add_ds")
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
    aniso_times(card, prob_aniso, times, work)
    fas_times(card, times, work)
    periodic_times(card, times, work)
    dist_times(card, times, work)
    dist_fas_times(card, times, work)
    dist3_times(card, times, work)
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


# Float32 operations per solved node, counted from lines.cu: the right-hand
# side (6 multiplies, 6 adds, 1 subtraction), each PCR step (2 divisions,
# 6 multiplies, 4 adds), the closing division; the 9-point residual (9
# multiplies, 8 adds, 1 subtraction).
ZRHS, ZPCR, ZRES = 13, 12, 18


def zebra_work(S, Sc, n, sweeps):
    """(bytes, operations) of the zebra kernels, by the rows 8-10 rule: u
    over its (n+1)^2 reach (the interior for K2z, which masks u + P e_c
    first), b over the interior, the 9 planes over the reach, e_c over the
    coarse reach, every output in full.  The operations count the interior
    nodes, each PCR over ceil(log2 S) steps."""
    N, Nc, reach, inner, creach, cinner = cells2(S, Sc, n)
    steps = (S - 1).bit_length()
    sweep = sweeps * (ZRHS + steps * ZPCR + 1) * inner
    planes = 9 * reach
    k2 = 4 * (2 * inner + planes + creach + N)
    return {
        "zebra_sweeps": (4 * (reach + inner + planes + N), sweep),
        "zebra_smooth_restrict": (4 * (reach + inner + planes + N + Nc),
                                  sweep + ZRES * inner + FW * cinner),
        "prolong_zebra_smooth": (k2, sweep + PRO * inner),
        "prolong_zebra_smooth_resnorm": (k2 + 4,
                                         sweep + (PRO + ZRES + 2) * inner)}


def aniso_times(card, prob, times, work):
    """The 4097^2 anisotropic V-cycle on both paths over the shared
    hierarchy, and each zebra kernel at the finest pair (the rotated
    operator, 1 sweep) beside its plain version.  No PyTorch call solves
    batched tridiagonal systems: their library time is null."""
    import tpu_multigrid_torch as tmg
    from tpu_multigrid_torch.kernels import lines as Z
    hier = prob.hierarchy
    b = prob.rhs()
    u = torch.zeros_like(b)
    dof = (2 ** ANISO_LEVEL - 1) ** 2
    for use in (True, False):
        cfg = aniso_config(use)
        ms = cuda_ms(lambda: tmg.cycle(hier, cfg, u, b))
        times["aniso_vcycle" if use else "aniso_vcycle_plain"] = ms
        print(f"[times] anisotropic V-cycle at {2 ** ANISO_LEVEL + 1}^2, "
              f"zebra_x (1,1), {'kernels' if use else 'plain  '}: {ms:.3f} "
              f"ms, {dof / (ms * 1e-3):.4g} DOF/s  ({card})")
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(13)
    f, g = hier.levels[:2]
    S, Sc, n, coef = f.S, g.S, f.n, zebra_planes(f)
    u, b = interior_randn(S, n, gen), interior_randn(S, n, gen)
    ec = interior_randn(Sc, n // 2, gen)
    cases = {"zebra_sweeps": (u, b, coef, n, 1),
             "zebra_smooth_restrict": (u, b, coef, n, Sc, 1),
             "prolong_zebra_smooth": (u, b, ec, coef, n, 1),
             "prolong_zebra_smooth_resnorm": (u, b, ec, coef, n, 1)}
    work.update(zebra_work(S, Sc, n, 1))
    for name, args in cases.items():
        kern, plain = getattr(Z, name), getattr(Z, name + "_plain")
        times[name] = (cuda_ms(lambda: kern(*args)),
                       cuda_ms(lambda: plain(*args)))
        k, p = times[name]
        bms, by = bound(*work[name])
        print(f"[times] {name:28s} S={S}: kernel {k:.3f} ms, plain {p:.3f} "
              f"ms, bound {bms:.3f} ms ({by})  ({card})")
    del u, b, ec, cases
    torch.cuda.empty_cache()


# Float32 operations per node, counted from fas.cu / fas3d.cu (an expf
# counted as one): a Jacobi-Newton step (the 5- or 7-point neighbour sum,
# phi, ap, the denominator, the update: 14 / 16), a Picard-Jacobi step (9
# per edge, 5 more: 41 / 59), the nonlinear residual (Bratu 10 / 12,
# quadratic 37 / 55), the coarse apply plus the restricted residual per
# coarse node (10 / 12, 37 / 55).
FSTEP = {("fas_", ""): 14, ("fas_", "3"): 16, ("qfas_", ""): 41,
         ("qfas_", "3"): 59}
FRES = {("fas_", ""): 10, ("fas_", "3"): 12, ("qfas_", ""): 37,
        ("qfas_", "3"): 55}
FCAP = FRES


def fas_work(prefix, suffix, shape, shape_c, n, sweeps):
    """(bytes, operations) of a family's FAS kernels, by the rule of the
    other rows: u over its (n+1)^d reach (the interior for K2f, which masks
    u + P e_c first), b over the interior, e_c over the coarse reach, every
    output in full (u', and uc0 and bc for K1f); the operations count the
    interior nodes."""
    d = 3 if suffix else 2
    cells = int(np.prod(shape)) if d == 3 else shape * shape
    ccells = int(np.prod(shape_c)) if d == 3 else shape_c * shape_c
    reach, inner = (n + 1) ** d, (n - 1) ** d
    creach, cinner = (n // 2 + 1) ** d, (n // 2 - 1) ** d
    key = (prefix, suffix)
    fw, pro = (FW3, PRO3) if d == 3 else (FW, PRO)
    sweep = sweeps * FSTEP[key] * inner
    k2 = 4 * (2 * inner + creach + cells)
    return {
        prefix + "smooth_restrict" + suffix: (
            4 * (reach + inner + cells + 2 * ccells),
            sweep + FRES[key] * inner + (fw + FCAP[key]) * cinner),
        prefix + "prolong_smooth" + suffix: (k2, sweep + pro * inner),
        prefix + "prolong_smooth_resnorm" + suffix: (
            k2 + 4, sweep + (pro + FRES[key] + 2) * inner)}


def fas_times(card, times, work):
    """The FAS V-cycle on both routes at 4097^2 (Bratu and quasilinear,
    benchmarks/bench_fas.py's Jacobi (2, 2), coarsest level 5) and at 513^3
    (Bratu, coarsest level 3), and each FAS kernel beside its plain version
    at 4352 / 2304 and (528, 528, 640) / (272, 272, 384), 2 sweeps.  No
    PyTorch call computes any of these functions: no library time."""
    import tpu_multigrid_torch as tmg
    cycles = [("bratu", FAS_LEVEL, 2, 5), ("quadratic", FAS_LEVEL, 2, 5),
              ("bratu", FAS3_LEVEL, 3, 3)]
    for family, level, ndim, coarsest in cycles:
        for use in (True, False):
            cfg = tmg.MultigridConfig(finest_level=level,
                                      coarsest_level=coarsest,
                                      use_kernels=use)
            prob = fas_problem(family, cfg, ndim)
            b = prob.rhs()
            u = torch.zeros_like(b)
            ms = cuda_ms(lambda: tmg.fas_cycle(prob.hierarchy, cfg, u, b))
            key = (f"fas_vcycle_{family}{'3d' if ndim == 3 else ''}"
                   f"{'' if use else '_plain'}")
            times[key] = ms
            side = f"{2 ** level + 1}^{ndim}"
            dof = (2 ** level - 1) ** ndim
            print(f"[times] FAS V-cycle ({family}) at {side}, Jacobi (2,2), "
                  f"coarsest {coarsest}, {'kernels' if use else 'plain  '}: "
                  f"{ms:.3f} ms, {dof / (ms * 1e-3):.4g} DOF/s  ({card})")
            if use:
                # The coarsest level's share: the dense Newton solve (three
                # torch.linalg.solve) or the Picard sweeps, the same on both
                # routes.
                from tpu_multigrid_torch.cycles import fas as FC
                hier = prob.hierarchy
                uc = torch.zeros_like(prob.rhs(hier.num_levels - 1))
                cms = cuda_ms(lambda: FC._coarsest(hier, cfg, uc, uc))
                times[key + "_coarsest"] = cms
                print(f"[times]   its coarsest level ({hier.levels[-1].n + 1}"
                      f"^{ndim}) alone: {cms:.3f} ms  ({card})")
            del prob, b, u
            torch.cuda.empty_cache()
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(22)
    for (S, Sc, n), (shape, shape_c, n3) in zip(FAS_PAIRS[:1],
                                                FAS_PAIRS3[:1]):
        grids = [("", interior_randn(S, n, gen, 0.1), interior_randn(S, n, gen),
                  interior_randn(Sc, n // 2, gen, 0.05), n, Sc, S),
                 ("3", interior_randn3(shape, n3, gen, 0.1),
                  interior_randn3(shape, n3, gen),
                  interior_randn3(shape_c, n3 // 2, gen, 0.05), n3, shape_c,
                  shape)]
        for suffix, u, b, ec, nn, sc, sf in grids:
            for family in ("bratu", "quadratic"):
                prefix = fas_nl(family)[0]
                work.update(fas_work(prefix, suffix, sf, sc, nn, 2))
                for name, (kern, plain) in fas_cases(
                        family, suffix, u, b, ec, nn, sc, 2).items():
                    times[name] = (cuda_ms(kern), cuda_ms(plain))
                    k, p = times[name]
                    bms, by = bound(*work[name])
                    print(f"[times] {name:29s} {sf}: kernel {k:.3f} ms, "
                          f"plain {p:.3f} ms, bound {bms:.3f} ms ({by})  "
                          f"({card})")
        del grids
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
    phase_var_residual3(prob_var3)
    record_var3d = phase_slice_var3(prob_var3, host3, setup3)
    prob_aniso, host_a, setup_a = aniso_setup()
    phase_aniso_kernels(errs, prob_aniso)
    record_aniso = phase_aniso_slice(prob_aniso, host_a, setup_a)
    phase_fas_kernels(errs)
    record_fas = phase_fas_slice()
    phase_periodic_kernels(errs)
    record_periodic = phase_periodic_slice()
    phase_dist_kernels(errs)
    record_dist = phase_dist_slice(card, record)
    phase_dist_fas_kernels(errs)
    record_dist_fas = phase_dist_fas_slice(card, record_fas)
    phase_dist3_kernels(errs)
    record_dist3 = phase_dist3_slice(card, prob_var3)
    times, work, library = phase_times(card, prob_var, prob_var3, prob_aniso)
    launches = {name: sum(c[name] for c in PATH_COUNTS.values())
                for name in REPLACES}
    for name, n in launches.items():
        check(n > 0, f"{name} was launched on none of the paths")
    print(f"[record] summary: {json.dumps(record)}")
    print(f"[refined3d] summary: {json.dumps(record3d)}")
    print(f"[var3d] summary: {json.dumps(record_var3d)}")
    print(f"[aniso] summary: {json.dumps(record_aniso)}")
    print(f"[fas] summary: {json.dumps(record_fas)}")
    print(f"[periodic] summary: {json.dumps(record_periodic)}")
    print(f"[dist] summary: {json.dumps(record_dist)}")
    print(f"[dist-fas] summary: {json.dumps(record_dist_fas)}")
    print(f"[dist3] summary: {json.dumps(record_dist3)}")
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
