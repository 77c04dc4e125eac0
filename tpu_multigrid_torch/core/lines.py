"""Line (zebra) relaxation by parallel cyclic reduction.

Anisotropic operators (-a u_xx - c u_yy with a != c) defeat point
smoothers: the error smooths only along the strongly coupled axis.  Line
relaxation along that axis solves each grid line's tridiagonal system
exactly, with the off-line (and 9-point corner) terms moved to the right-
hand side.  Zebra ordering (all odd lines, then all even lines) keeps every
line solve independent of the others in its half-sweep.

The tridiagonal solves use parallel cyclic reduction (PCR): ``ceil(log2
S)`` steps of whole-line shifts over the full padded line.  Out-of-range
shifts read the identity row (d = 1, off-diagonals 0, right-hand side 0),
so padding and the Dirichlet exterior solve to zero.  The operations and
their order are the JAX package's ``core.lines``.
"""

from __future__ import annotations

import math

import torch

from . import ops


def _shift(x: torch.Tensor, s: int, fill: float) -> torch.Tensor:
    """x[..., j + s] along the last axis, ``fill`` where j + s is outside
    [0, S)."""
    S = x.shape[-1]
    out = torch.full_like(x, fill)
    if s > 0:
        out[..., :S - s] = x[..., s:]
    elif s < 0:
        out[..., -s:] = x[..., :S + s]
    else:
        out.copy_(x)
    return out


def pcr_steps(S: int) -> int:
    """PCR steps of a line of length S: ``max(1, ceil(log2 S))``."""
    return max(1, math.ceil(math.log2(S)))


def tridiag_pcr(dl, d, du, b):
    """Solve T x = b along the LAST axis, batched over leading axes.

    ``dl[j]`` multiplies x[j-1], ``d[j]`` x[j], ``du[j]`` x[j+1].  Rows
    outside the system must be set to the identity (d = 1, dl = du = 0,
    b = 0).  PCR is a direct method and does not pivot: T must be well
    posed (diagonally dominant rows, as every line of these operators).
    """
    for k in range(pcr_steps(b.shape[-1])):
        s = 1 << k
        d_m, d_p = _shift(d, -s, 1.0), _shift(d, s, 1.0)
        dl_m, du_p = _shift(dl, -s, 0.0), _shift(du, s, 0.0)
        du_m, dl_p = _shift(du, -s, 0.0), _shift(dl, s, 0.0)
        b_m, b_p = _shift(b, -s, 0.0), _shift(b, s, 0.0)
        alpha = -dl / d_m
        beta = -du / d_p
        d = d + alpha * du_m + beta * dl_p
        b = b + alpha * b_m + beta * b_p
        dl = alpha * dl_m
        du = beta * du_p
    return b / d


def _line_system(coef, b_eff, inter, axis: int):
    """Tridiagonal pieces (dl, d, du, rhs) for lines along ``axis`` (1 =
    rows, coupling along x), the identity outside the interior."""
    if axis == 1:
        dl, du = coef[1, 0], coef[1, 2]
    else:
        dl, du = coef[0, 1], coef[2, 1]
    d = torch.where(inter, coef[1, 1], 1.0)
    dl = torch.where(inter, dl, 0.0)
    du = torch.where(inter, du, 0.0)
    b_eff = torch.where(inter, b_eff, 0.0)
    return dl, d, du, b_eff


def zebra_coef(coef, n: int, u, b, sweeps: int, axis: int = 1):
    """``sweeps`` zebra sweeps of the 9-point stencil ``coef`` (3, 3, S, S)
    with the Dirichlet interior ``1..n-1``: each sweep solves every odd
    line exactly (off-line terms at their current values), then every even
    line."""
    inter = ops.interior_mask(u.shape[-1], n, u.device)
    idx = torch.arange(u.shape[-2] if axis == 1 else u.shape[-1],
                       device=u.device)
    line_idx = idx[:, None] if axis == 1 else idx[None, :]

    def offline_apply(v):
        """All stencil terms except the in-line tridiagonal ones."""
        acc = torch.zeros_like(v)
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                if (di == 0 and dj == 0) or (axis == 1 and di == 0) \
                        or (axis == 0 and dj == 0):
                    continue
                acc = acc + coef[di + 1, dj + 1] * _shift2(v, di, dj)
        return acc

    def half(v, parity):
        dl, d, du, rhs = _line_system(coef, b - offline_apply(v), inter, axis)
        if axis == 0:
            sol = tridiag_pcr(dl.T, d.T, du.T, rhs.T).T
        else:
            sol = tridiag_pcr(dl, d, du, rhs)
        upd = inter & (line_idx % 2 == parity)
        return torch.where(upd, sol.to(v.dtype), v)

    for _ in range(sweeps):
        u = half(u, 1)
        u = half(u, 0)
    return u


def zebra_sweeps(op, u, b, sweeps: int, axis: int = 1):
    """``sweeps`` zebra line-relaxation sweeps of a ``VarStencilOp``:
    ``axis=1`` takes lines along x (grid rows; strong coupling in x),
    ``axis=0`` lines along y (columns)."""
    if getattr(op, "box", None) is not None:
        raise NotImplementedError("box operators (mixed boundary "
                                  "conditions) are not ported yet")
    return zebra_coef(op.coef, op.n, u, b, sweeps, axis)


def _shift2(u, di: int, dj: int):
    """u[i+di, j+dj] with wrap-around (only non-interior nodes read a
    wrapped value)."""
    out = u
    if di:
        out = torch.roll(out, -di, -2)
    if dj:
        out = torch.roll(out, -dj, -1)
    return out
