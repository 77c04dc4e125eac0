"""K1 and K2 on ghost-extended blocks, K1-local and K2-local, and the
streaming smoother on such blocks, K0-local.

A ghost-extended block is an ``(R, C) = (lr + 2 GR, lc + 2 GC)`` array, an
``(lr, lc)`` owned region inside ``GR = 16`` ghost rows and ``GC = 256``
ghost columns a side, whose cell ``(i, j)`` has the global coordinates
``origin + (i, j)``.  The interior mask (global coordinates in ``1..n-1``)
and the RB-GS colours come from the global coordinates, so one launch
serves a shard at any position of a decomposed grid; the periodic fused
tier (``cycles.periodic_fused``) passes ``origin = (2, 2)`` and a virtual
``n`` so large that every cell is a live unknown.  The coarse block is
``(R/2 + GR, C/2 + GC)``: fine cell ``(i, j)`` (both even) restricts to
coarse cell ``(i/2 + GR/2, j/2 + GC/2)``.

* K1-local, :func:`smooth_restrict_ext`: smoothing steps, the residual and
  its full-weighting restriction into the coarse block, in one launch.
* K2-local, :func:`prolong_smooth_ext`: ``where(live, u + P ec, 0)`` and
  the smoothing steps, optionally with the sum of squares of the residual
  over the owned live cells (``want_resnorm``).
* K0-local, :func:`smooth_ext` and :func:`residual_ext`: the smoothing
  steps alone, or the residual ``where(live, b - A u, 0)`` alone.

They replace the Pallas TPU kernels ``tpu_multigrid/kernels/local.py::
_k1_local``, ``::_k2_local`` and ``::_streamed_local`` (``csrc/local.cu``),
whose entries they keep: ``origin`` is a pair of host ints.  Each entry runs
its plain torch version (``*_plain``) on CPU tensors and launches its CUDA
kernel on CUDA tensors, never falling back.  Every output is defined on the whole array:
cells outside the array read as zero and are never updated, and the coarse
cells no fine cell restricts to are zero.  The TPU kernels leave the ghost
ring undefined, so the two packages agree on the owned region (fine rows
``GR..R-GR-1`` and columns ``GC..C-GC-1``, and the same on the coarse
block), which is all a caller reads after refreshing the ghosts.
``LAUNCHES`` counts kernel launches per entry.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .transfer import _launch_args

GR = 16       # ghost rows per side (>= steps + 2 for every fused kernel)
GC = 256      # ghost columns per side

LAUNCHES = {"smooth_restrict_ext": 0, "prolong_smooth_ext": 0,
            "prolong_smooth_ext_resnorm": 0, "smooth_ext": 0,
            "residual_ext": 0}


def supported_local(R: int, C: int, steps: int, dtype) -> bool:
    """Whether the extended-block kernels take an (R, C) block with
    ``steps`` window-shrink steps (sweeps times the smoother's multiplicity
    plus the fused extras): the shape and depth rules of ``tpu_multigrid.
    kernels.local.supported_local``.  (That gate also caps C by the TPU's
    on-chip memory; the kernels here take any width.)"""
    if dtype != torch.float32:
        return False
    if (R - 2 * GR) <= 0 or (R - 2 * GR) % 16 or (C - 2 * GC) % 256:
        return False
    if (C - 2 * GC) <= 0:
        return False
    return steps + 2 <= GR


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _masks(R: int, C: int, origin, n: int, device):
    """(live, colour) of an (R, C) block at global ``origin``."""
    gi = torch.arange(R, device=device) + int(origin[0])
    gj = torch.arange(C, device=device) + int(origin[1])
    live = (((gi >= 1) & (gi <= n - 1))[:, None]
            & ((gj >= 1) & (gj <= n - 1))[None, :])
    return live, (gi[:, None] + gj[None, :]) % 2


def _nbr(v):
    """u[i-1,j] + u[i+1,j] + u[i,j-1] + u[i,j+1], cells outside reading 0."""
    p = F.pad(v, (1, 1, 1, 1))
    return ((p[:-2, 1:-1] + p[2:, 1:-1]) + p[1:-1, :-2]) + p[1:-1, 2:]


def _smooth_plain(v, b, live, color, sweeps, smoother, omega):
    if smoother == "rbgs":
        for s in range(2 * sweeps):
            upd = live & (color == s % 2)
            v = torch.where(upd, 0.25 * (b + _nbr(v)), v)
        return v
    ws = omega if isinstance(omega, tuple) else (omega,)
    for s in range(sweeps):
        w = ws[s % len(ws)]
        v = torch.where(live, (1.0 - w) * v + (0.25 * w) * (b + _nbr(v)),
                        0.0)
    return v


def _residual_plain(v, b, live):
    return torch.where(live, (b - 4.0 * v) + _nbr(v), 0.0)


def _check(entry, u, smoother):
    if u.dtype != torch.float32:
        raise NotImplementedError(f"{entry}: float32 only, got {u.dtype}")
    if smoother not in ("jacobi", "rbgs"):
        raise ValueError(f"unknown smoother {smoother!r}")
    R, C = u.shape
    if R % 2 or C % 2:
        raise ValueError(f"{entry}: the block's sides must be even, got "
                         f"{tuple(u.shape)}")


def coarse_shape(R: int, C: int):
    """The coarse block of an (R, C) fine block."""
    return R // 2 + GR, C // 2 + GC


def smooth_restrict_ext_plain(u, b, origin, n: int, sweeps: int,
                              smoother: str = "jacobi", omega=2.0 / 3.0):
    """K1-local's plain version: (u', rc_ext).  The full-weighting aggregate
    is taken in the TPU kernel's order (``_fw_aggregate``)."""
    R, C = u.shape
    live, color = _masks(R, C, origin, n, u.device)
    v = _smooth_plain(u, b, live, color, sweeps, smoother, omega)
    cmask = coarse_mask(R, C, origin, n, u.device)
    return v, into_coarse(torch.where(cmask, fw_even(_residual_plain(
        v, b, live)), 0.0))


def coarse_mask(R: int, C: int, origin, n: int, device):
    """The coarse interior (global coordinates ``origin // 2 + (I, J)`` in
    ``1..n/2-1``) of the (R/2, C/2) cells an (R, C) block restricts to."""
    hi = torch.arange(R // 2, device=device) + int(origin[0]) // 2
    hj = torch.arange(C // 2, device=device) + int(origin[1]) // 2
    nc = n // 2
    return (((hi >= 1) & (hi <= nc - 1))[:, None]
            & ((hj >= 1) & (hj <= nc - 1))[None, :])


def fw_even(r):
    """The full-weighting aggregate of r at its even cells, in the TPU
    kernel's order (``_fw_aggregate``), cells outside reading 0."""
    p = F.pad(r, (1, 1, 1, 1))
    row3 = (p[:-2] + 2.0 * p[1:-1]) + p[2:]
    agg = 0.25 * ((row3[:, :-2] + 2.0 * row3[:, 1:-1]) + row3[:, 2:])
    return agg[0::2, 0::2]


def into_coarse(inner):
    """The (R/2 + GR, C/2 + GC) coarse block holding ``inner`` (R/2, C/2)
    at the cells the fine block restricts to, zero in its frame."""
    r, c = inner.shape
    out = inner.new_zeros(coarse_shape(2 * r, 2 * c))
    out[GR // 2:GR // 2 + r, GC // 2:GC // 2 + c] = inner
    return out


def _prolonged(ec, R: int, C: int):
    """P ec on the (R, C) fine block, in the TPU kernel's order
    (``_bilinear_prolong``): 2x2 replication, the average with the next
    row, then with the next column."""
    c = ec[GR // 2:GR // 2 + R // 2 + 1, GC // 2:GC // 2 + C // 2 + 1]
    e = c.repeat_interleave(2, 0).repeat_interleave(2, 1)
    f = 0.5 * (e[:-1] + e[1:])
    return (0.5 * (f[:, :-1] + f[:, 1:]))[:R, :C]


def _k2_plain(u, b, ec, origin, n, sweeps, smoother, omega):
    R, C = u.shape
    live, color = _masks(R, C, origin, n, u.device)
    v = torch.where(live, u + _prolonged(ec, R, C), 0.0)
    return _smooth_plain(v, b, live, color, sweeps, smoother, omega), live


def prolong_smooth_ext_plain(u, b, ec, origin, n: int, sweeps: int,
                             smoother: str = "jacobi", omega=2.0 / 3.0):
    """K2-local's plain version: u'."""
    return _k2_plain(u, b, ec, origin, n, sweeps, smoother, omega)[0]


def prolong_smooth_ext_resnorm_plain(u, b, ec, origin, n: int, sweeps: int,
                                     smoother: str = "jacobi",
                                     omega=2.0 / 3.0):
    """K2-local-resnorm's plain version: (u', sum of (b - A u')^2 over the
    owned live cells, 0-d float32)."""
    v, live = _k2_plain(u, b, ec, origin, n, sweeps, smoother, omega)
    r = _residual_plain(v, b, live)[GR:-GR, GC:-GC]
    return v, torch.sum(r * r)


def smooth_ext_plain(u, b, origin, n: int, sweeps: int,
                     smoother: str = "jacobi", omega=2.0 / 3.0):
    """K0-local's plain version: u after ``sweeps`` sweeps."""
    R, C = u.shape
    live, color = _masks(R, C, origin, n, u.device)
    return _smooth_plain(u, b, live, color, sweeps, smoother, omega)


def residual_ext_plain(u, b, origin, n: int):
    """K0-local's plain version with no steps: where(live, b - A u, 0)."""
    R, C = u.shape
    return _residual_plain(u, b, _masks(R, C, origin, n, u.device)[0])


# ---------------------------------------------------------------------------
# Entries
# ---------------------------------------------------------------------------

def _streamed_ext(entry, u, b, origin, n, sweeps, smoother, omega, want_u):
    R, C = u.shape
    _build.check_inputs(entry, (u, b), ((R, C), (R, C)))
    lib = _build.lib()
    steps, rbgs, weights = _launch_args(entry, lib, smoother, omega, sweeps)
    out = torch.empty_like(u)
    with torch.cuda.device(u.device):
        err = lib.tmt_streamed_ext(
            u.data_ptr(), b.data_ptr(), out.data_ptr() if want_u else None,
            None if want_u else out.data_ptr(), R, C, int(origin[0]),
            int(origin[1]), n, steps, rbgs, weights.ctypes.data,
            weights.size // 2, torch.cuda.current_stream().cuda_stream)
    _build.check(err, entry)
    LAUNCHES[entry] += 1
    return out


def smooth_ext(u, b, origin, n: int, sweeps: int, smoother: str = "jacobi",
               omega=2.0 / 3.0):
    """K0-local: u after ``sweeps`` sweeps (u itself when ``sweeps`` <= 0)."""
    _check("smooth_ext", u, smoother)
    if sweeps <= 0:
        return u
    if u.device.type == "cpu":
        return smooth_ext_plain(u, b, origin, n, sweeps, smoother, omega)
    return _streamed_ext("smooth_ext", u, b, origin, n, sweeps, smoother,
                         omega, True)


def residual_ext(u, b, origin, n: int):
    """K0-local with no steps: r = where(live, b - A u, 0)."""
    _check("residual_ext", u, "jacobi")
    if u.device.type == "cpu":
        return residual_ext_plain(u, b, origin, n)
    return _streamed_ext("residual_ext", u, b, origin, n, 0, "jacobi", 1.0,
                         False)


def smooth_restrict_ext(u, b, origin, n: int, sweeps: int,
                        smoother: str = "jacobi", omega=2.0 / 3.0):
    """K1-local: (u after ``sweeps`` sweeps, the coarse block (R/2 + GR,
    C/2 + GC) holding the restricted residual)."""
    _check("smooth_restrict_ext", u, smoother)
    if u.device.type == "cpu":
        return smooth_restrict_ext_plain(u, b, origin, n, sweeps, smoother,
                                         omega)
    R, C = u.shape
    _build.check_inputs("smooth_restrict_ext", (u, b), ((R, C), (R, C)))
    lib = _build.lib()
    steps, rbgs, weights = _launch_args("smooth_restrict_ext", lib, smoother,
                                        omega, sweeps)
    u_out = torch.empty_like(u)
    rc = torch.empty(coarse_shape(R, C), dtype=u.dtype, device=u.device)
    with torch.cuda.device(u.device):
        err = lib.tmt_smooth_restrict_ext(
            u.data_ptr(), b.data_ptr(), u_out.data_ptr(), rc.data_ptr(), R, C,
            int(origin[0]), int(origin[1]), n, steps, rbgs,
            weights.ctypes.data, weights.size // 2,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "smooth_restrict_ext")
    LAUNCHES["smooth_restrict_ext"] += 1
    return u_out, rc


def prolong_smooth_ext(u, b, ec, origin, n: int, sweeps: int,
                       smoother: str = "jacobi", omega=2.0 / 3.0,
                       want_resnorm: bool = False):
    """K2-local: u <- smooth(where(live, u + P ec, 0), b).  With
    ``want_resnorm`` also the sum of squares of b - A u' over the owned live
    cells as a 0-d float32 tensor, summed in a fixed order (the caller takes
    its square root, or adds the shards' sums first)."""
    entry = ("prolong_smooth_ext_resnorm" if want_resnorm
             else "prolong_smooth_ext")
    _check(entry, u, smoother)
    if u.device.type == "cpu":
        if want_resnorm:
            return prolong_smooth_ext_resnorm_plain(u, b, ec, origin, n,
                                                    sweeps, smoother, omega)
        return prolong_smooth_ext_plain(u, b, ec, origin, n, sweeps,
                                        smoother, omega)
    R, C = u.shape
    _build.check_inputs(entry, (u, b, ec), ((R, C), (R, C),
                                            coarse_shape(R, C)))
    lib = _build.lib()
    steps, rbgs, weights = _launch_args(entry, lib, smoother, omega, sweeps)
    u_out = torch.empty_like(u)
    partials = out_sum = None
    if want_resnorm:
        tile = lib.transfer_tile
        partials = torch.empty(-(-R // tile) * -(-C // tile),
                               dtype=torch.float32, device=u.device)
        out_sum = torch.empty((), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        err = lib.tmt_prolong_smooth_ext(
            u.data_ptr(), b.data_ptr(), ec.data_ptr(), u_out.data_ptr(),
            None if partials is None else partials.data_ptr(),
            None if out_sum is None else out_sum.data_ptr(), R, C,
            int(origin[0]), int(origin[1]), n, steps, rbgs,
            weights.ctypes.data, weights.size // 2,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, entry)
    LAUNCHES[entry] += 1
    if want_resnorm:
        return u_out, out_sum
    return u_out
