"""The yardstick of K1v_3's and K2v_3's roofline shares, for the
``k1v_roofline.3d`` and ``k2v_roofline.3d`` readers.

A frozen copy, so that a later change to the program cannot move it: the
operations per node and :func:`var3_work` are ``chip_smoke.py``'s
``VDIAG3`` to ``VRES3`` and ``var3_work`` (the rows 8-10 rule, counted from
``vartransfer3d.cu`` when it was written): u over its (n+1)^3 reach (in
full for RB-GS; the interior for K2v_3, which masks u + P e_c first), b
over the interior, each coefficient plane over the reach, e_c over
(n/2+1)^3, outputs in full.  The peaks and the bound are ``roofline.py``'s.

The kernels are read from the trace by their identifier and by their
operator, ``VarOp3``, as the trace prints its template argument: the
constant K1_3 / K2_3 instances (``ConstOp3``) share K2v_3's identifier and
are not counted.  The configuration's flux stencil has 3 coefficient
planes.
"""

from __future__ import annotations

from typing import Optional

import devtrace
import roofline

# Float32 operations per node: the diagonal (5 adds, 6 with c2), the
# off-diagonal sum (6 multiplies, 5 adds), 1/diag, and a Jacobi step's 5
# more; an RB-GS half-step's 2 more on half the nodes; the residual's 3
# more.
VDIAG3, VOFF3 = 5, 11
VJAC3 = VDIAG3 + VOFF3 + 1 + 5
VHALF3 = (VDIAG3 + VOFF3 + 1 + 2) / 2
VRES3 = VDIAG3 + VOFF3 + 3
FW3, PRO3 = roofline.FW3, roofline.PRO3
PLANES = 3
OPERATOR = "VarOp3<"


def var3_work(shape, shape_c, n, nplanes, sm, s1, s2):
    """(bytes, operations) of K1v_3, K2v_3 and K2v_3-resnorm at one level
    pair, by their launch counters' names."""
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


def seconds_of(trace, kernels) -> float:
    """Device seconds of the var instances of ``kernels`` (identifiers)."""
    return sum(e - s for name, s, e in trace.device
               if devtrace.base_name(name) in kernels
               and OPERATOR in devtrace.short_name(name)) * 1e-6


def share(run, kernels, counters) -> Optional[float]:
    """% of the roofline of the kernel whose launch counters are
    ``counters`` (K1v_3's, or K2v_3's and its resnorm form's) over the
    traced window: the least time of the level visits made, against the
    kernels' device time.  A V-cycle visits each fused pair once, the
    finest ones, so the pairs visited are the finest ``launches / cycles``;
    where that is no whole number, or the schedule is not of the Jacobi
    family, there is nothing to read."""
    t = run.trace
    mg, levels = run.config["multigrid"], run.config["levels"]
    if (t is None or run.config["ndim"] != 3
            or mg["smoother"] not in ("jacobi", "chebyshev")):
        return None
    counts = [t.launches.get(c, 0) for c in counters]
    cycles = sum(s["cycles"] for s in run.solves)
    device_s = seconds_of(t, kernels)
    if (cycles <= 0 or sum(counts) <= 0 or sum(counts) % cycles
            or sum(counts) // cycles >= len(levels) or device_s <= 0):
        return None
    need = 0.0
    for i in range(sum(counts) // cycles):
        (n, shape), (_, shape_c) = levels[i], levels[i + 1]
        work = var3_work(shape, shape_c, n, PLANES, "jacobi", mg["nu1"],
                         mg["nu2"])
        if i == 0:
            # The resnorm visits are the finest pair's.
            for name, count in zip(counters[1:], counts[1:]):
                need += count * roofline.bound(*work[name])[0]
            visits = cycles - sum(counts[1:])
        else:
            visits = cycles
        need += visits * roofline.bound(*work[counters[0]])[0]
    return 100.0 * need / device_s
