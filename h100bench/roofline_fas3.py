"""The yardstick of K1f_3's and K2f_3's roofline shares on the pointwise
(Bratu) family, for the ``k1f_roofline.3d`` and ``k2f_roofline.3d``
readers.

A frozen copy, so that a later change to the program cannot move it: the
operations per node and :func:`fas3_work` are ``chip_smoke.py``'s
``FSTEP``, ``FRES``, ``FCAP`` and ``fas_work`` for the 3D pointwise family
(the rows 23-24 rule, counted from ``fas3d.cu`` when it was written, the
exponential counted as one operation): u over its (n+1)^3 reach (the
interior for K2f_3, which masks u + P e_c first), b over the interior, e_c
over the (n/2+1)^3 coarse nodes, every output in full (u', and the
injection u_c0 and the coarse right-hand side b_c for K1f_3); the
operations over the interior nodes, and for K1f_3 the coarse operator and
the restricted residual over the coarse interior.  The peaks and the bound
are ``roofline.py``'s.

The kernels are read from the trace by their identifier and by their
operator, ``BratuOp3``, as the trace prints its template argument: the
7-point K1_3 / K2_3 instances share their identifiers and are not counted.
"""

from __future__ import annotations

from typing import Optional

import devtrace
import roofline

# Float32 operations per node: a Jacobi-Newton step (the 7-point neighbour
# sum, phi, A u + h^2 phi, the denominator, the update), the nonlinear
# residual, and per coarse node the coarse operator on the injection plus
# the restricted residual.
FSTEP3, FRES3, FCAP3 = 16, 12, 12
FW3, PRO3 = roofline.FW3, roofline.PRO3
F32 = roofline.F32
OPERATOR = "BratuOp3"


def fas3_work(shape, shape_c, n, sweeps):
    """(bytes, operations) of K1f_3, K2f_3 and K2f_3-resnorm at one level
    pair, by their launch counters' names."""
    cells = shape[0] * shape[1] * shape[2]
    ccells = shape_c[0] * shape_c[1] * shape_c[2]
    reach, inner = (n + 1) ** 3, (n - 1) ** 3
    creach, cinner = (n // 2 + 1) ** 3, (n // 2 - 1) ** 3
    sweep = sweeps * FSTEP3 * inner
    k2 = F32 * (2 * inner + creach + cells)
    return {
        "fas_smooth_restrict3": (
            F32 * (reach + inner + cells + 2 * ccells),
            sweep + FRES3 * inner + (FW3 + FCAP3) * cinner),
        "fas_prolong_smooth3": (k2, sweep + PRO3 * inner),
        "fas_prolong_smooth_resnorm3": (
            k2 + F32, sweep + (PRO3 + FRES3 + 2) * inner)}


def seconds_of(trace, kernels) -> float:
    """Device seconds of the Bratu instances of ``kernels``
    (identifiers)."""
    return sum(e - s for name, s, e in trace.device
               if devtrace.base_name(name) in kernels
               and OPERATOR in devtrace.short_name(name)) * 1e-6


def share(run, kernels, counters, sweeps_key: str) -> Optional[float]:
    """% of the roofline of the kernel whose launch counters are
    ``counters`` (K1f_3's, or K2f_3's and its resnorm form's) over the
    traced window: the least time of the level visits made, against the
    kernels' device time.  A V-cycle visits each fused pair once, the
    finest ones, so the pairs visited are the finest ``launches /
    cycles``; where that is no whole number there is nothing to read.
    ``sweeps_key``: the schedule's field of the kernel's sweeps (``nu1``
    or ``nu2``)."""
    t = run.trace
    if t is None or run.config["ndim"] != 3:
        return None
    levels = run.config["levels"]
    counts = [t.launches.get(c, 0) for c in counters]
    cycles = sum(s["cycles"] for s in run.solves)
    device_s = seconds_of(t, kernels)
    if (cycles <= 0 or sum(counts) <= 0 or sum(counts) % cycles
            or sum(counts) // cycles >= len(levels) or device_s <= 0):
        return None
    sweeps = run.config["multigrid"][sweeps_key]
    need = 0.0
    for i in range(sum(counts) // cycles):
        (n, shape), (_, shape_c) = levels[i], levels[i + 1]
        work = fas3_work(shape, shape_c, n, sweeps)
        if i == 0:
            # The resnorm visits are the finest pair's.
            for name, count in zip(counters[1:], counts[1:]):
                need += count * roofline.bound(*work[name])[0]
            visits = cycles - sum(counts[1:])
        else:
            visits = cycles
        need += visits * roofline.bound(*work[counters[0]])[0]
    return 100.0 * need / device_s
