"""The yardstick of the kernel rooflines: peaks, operations per node, bytes.

A frozen copy, so that a later change to the program cannot move it:

* ``PEAK_BYTES_PER_S``, ``PEAK_F32_PER_S`` and :func:`bound` are
  ``chip_smoke.py`` lines 300-303 and 4258-4263 (the card's published peaks,
  H100 SXM, NVIDIA's data sheet; the least time to move the bytes and do the
  float32 operations);
* the operations per node are ``chip_smoke.py`` lines 4266-4275 (2D) and
  4064-4071 (3D), counted from the kernels' sources when they were written;
* the byte and operation rules of K1, K2 and K2-resnorm are those of
  ``chip_smoke.py`` lines 4278-4283 and 4337-4354 (2D) and 4109-4127 (3D):
  u over the (n+1)^d nodes the interior's stencils reach (the interior for
  K2, which masks u + P e_c first), b over the interior, e_c over the
  (n/2+1)^d coarse nodes that P reads, every output in full (padded), and
  the operations over the interior nodes.

The count is of the work a level visit needs, not of how a kernel does it,
so a redesigned kernel is read against the same numbers.  Only the Jacobi
family (Jacobi, Chebyshev) is counted; RB-GS reads u in full and is not.
"""

from __future__ import annotations

import math

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12

# 2D, per node: a Jacobi step of the 5-point stencil (4 adds, 3 multiplies),
# the residual (6), full weighting per coarse node (12), bilinear
# prolongation plus the add per fine node (3).
JAC, RES, FW, PRO = 7, 6, 12, 3
# 3D, per node: a Jacobi step of the 7-point stencil, the residual, full
# weighting per coarse node, trilinear prolongation plus the add.
JAC3, RES3, FW3, PRO3 = 9, 8, 40, 7
F32 = 4


def bound(nbytes: float, flops: float):
    """(seconds, "bytes" or "operations"): the least time the card could
    take to move ``nbytes`` and do ``flops`` float32 operations."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_F32_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _counts(fine, coarse):
    """(cells, coarse cells, reach, interior, coarse reach, coarse
    interior) of a level pair, each level given as [n, shape]."""
    n, shape = fine
    _, shape_c = coarse
    d = len(shape)
    return (math.prod(shape), math.prod(shape_c), (n + 1) ** d,
            (n - 1) ** d, (n // 2 + 1) ** d, (n // 2 - 1) ** d)


def _per_node(d: int):
    return (JAC, RES, FW, PRO) if d == 2 else (JAC3, RES3, FW3, PRO3)


def k1_work(fine, coarse, nu1: int):
    """(bytes, operations) of K1: nu1 Jacobi steps, the residual and full
    weighting on the level pair."""
    cells, ccells, reach, inner, _, cinner = _counts(fine, coarse)
    jac, res, fw, _ = _per_node(len(fine[1]))
    return (F32 * (reach + inner + cells + ccells),
            (nu1 * jac + res) * inner + fw * cinner)


def k2_work(fine, coarse, nu2: int, resnorm: bool = False):
    """(bytes, operations) of K2: prolongation, the add and nu2 Jacobi
    steps; with ``resnorm`` also the residual and its squared norm."""
    cells, _, _, inner, creach, _ = _counts(fine, coarse)
    jac, res, _, pro = _per_node(len(fine[1]))
    nbytes = F32 * (2 * inner + creach + cells)
    flops = (pro + nu2 * jac) * inner
    if resnorm:
        return nbytes + F32, flops + (res + 2) * inner
    return nbytes, flops
