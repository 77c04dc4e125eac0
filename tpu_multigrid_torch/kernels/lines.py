"""Zebra line relaxation on the card: the zebra_x smoother and the two
kernels of an anisotropic multigrid level visit, K1z and K2z.

* :func:`zebra_sweeps`: ``sweeps`` zebra_x sweeps (the odd rows, then the
  even rows), each row a tridiagonal system along x solved by parallel
  cyclic reduction (PCR).
* K1z, :func:`zebra_smooth_restrict`: the sweeps, the 9-point residual and
  its full-weighting restriction, zero outside the coarse interior.
* K2z, :func:`prolong_zebra_smooth` / :func:`prolong_zebra_smooth_resnorm`:
  ``mask(u + P e_c)`` with bilinear P, then the sweeps, optionally with
  ``||b - A u'||_2``.

They replace the Pallas TPU kernels ``tpu_multigrid/kernels/lines.py::
_zebra_streamed``, ``::_zebra_smooth_restrict`` and
``::_prolong_zebra_smooth`` (``csrc/lines.cu``).  The coefficients are the
operator's nine planes ``op.coef.reshape(9, S, S)``, plane k the coupling
to ``u[i + k//3 - 1, j + k%3 - 1]``.  Each entry runs its plain torch
version (``*_plain``, in the Pallas kernels' order) on CPU tensors and
launches its CUDA kernels on CUDA tensors; on a CUDA tensor it never falls
back.  A call is several launches (:func:`launches`): one per half-sweep,
one for K1z's residual and restriction, one for K2z's prolongation, two for
the resnorm.  ``LAUNCHES`` counts them per entry.
"""

from __future__ import annotations

import torch

from ..core import ops
from ..core.lines import zebra_coef
from . import _build

LAUNCHES = {"zebra_sweeps": 0, "zebra_smooth_restrict": 0,
            "prolong_zebra_smooth": 0, "prolong_zebra_smooth_resnorm": 0}

# A line's four PCR arrays (dl, d, du, rhs) of S floats sit in the shared
# memory of one block: 16 S bytes within the 227 KiB of one SM.
_SMEM_BYTES = 227 * 1024

# Launches of one call beyond the two per sweep.
_EXTRA = {"zebra_sweeps": 0, "zebra_smooth_restrict": 1,
          "prolong_zebra_smooth": 1, "prolong_zebra_smooth_resnorm": 3}


def launches(entry: str, sweeps: int) -> int:
    """CUDA launches of one call of ``entry`` with ``sweeps`` sweeps: one per
    half-sweep, plus K1z's residual-restriction launch, K2z's prolongation
    launch, and the resnorm's row sums and their total.  (``zebra_sweeps``
    with no sweeps returns its input and launches nothing.)"""
    if entry == "zebra_sweeps" and sweeps <= 0:
        return 0
    return 2 * max(sweeps, 0) + _EXTRA[entry]


def _line_fits(S: int) -> bool:
    return 16 * S <= _SMEM_BYTES


def supported_zebra(S: int, sweeps: int, dtype) -> bool:
    """Whether the zebra_x smoother kernel takes an (S, S) grid: float32, S
    a multiple of 128 (the JAX package's shape rule), and a line that fits
    in one block's shared memory (S <= 14464).  Every grid the JAX kernel
    takes is taken; beyond its VMEM budget (S = 16640 at level 14, any
    sweeps) the line does not fit here either."""
    if dtype != torch.float32:
        return False
    if S % 128 or S < 128 or S % 2:
        return False
    return _line_fits(S)


def supported_zebra_fused(S: int, Sc: int, sweeps: int, dtype) -> bool:
    """Whether the (S, Sc) level pair goes to K1z/K2z: float32, S a multiple
    of 256, Sc a multiple of 128 covering S/2 + 128 (the JAX package's
    shape rules) and a line that fits in shared memory.  The TPU kernels'
    VMEM budget and their ``2 sweeps + 2 <= 16`` halo do not apply: here
    each half-sweep is its own launch, so the pair is fused at every depth,
    and at S = 8448 (level 13), which the JAX package leaves unfused."""
    if dtype != torch.float32:
        return False
    if S % 256 or S < 256 or Sc % 128:
        return False
    if Sc < S // 2 + 128:
        return False
    return _line_fits(S)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _planes33(coef):
    S = coef.shape[-1]
    return coef.reshape(3, 3, S, S)


def zebra_sweeps_plain(u, b, coef, n: int, sweeps: int):
    """The smoother's plain version: ``core.lines``' zebra_x sweeps, the
    Pallas kernel's operations in its order."""
    return zebra_coef(_planes33(coef), n, u, b, sweeps, axis=1)


def residual9_plain(u, b, coef, n: int):
    """The kernels' 9-point residual, masked to the interior: three row
    terms ``c_m x[j-1] + c_0 x[j] + c_p x[j+1]`` for the north, centre and
    south rows, summed in that order (not ``VarStencilOp.residual``'s)."""
    def row_term(cm, c0, cp, x):
        return (cm * torch.roll(x, 1, -1) + c0 * x
                + cp * torch.roll(x, -1, -1))

    un, us = torch.roll(u, 1, -2), torch.roll(u, -1, -2)
    au = (row_term(coef[0], coef[1], coef[2], un)
          + row_term(coef[3], coef[4], coef[5], u)
          + row_term(coef[6], coef[7], coef[8], us))
    return ops.mask_interior(b - au, n)


def _fit(x, side: int):
    """Crop or zero-pad an (R, R) grid to (side, side)."""
    out = x.new_zeros((side, side))
    k = min(side, x.shape[-1])
    out[:k, :k] = x[:k, :k]
    return out


def restrict_fw_plain(r, n: int, Sc: int):
    """Full weighting in the Pallas order: ``(r[i-1] + 2 r[i]) + r[i+1]``
    down the columns, then ``0.25 ((t[j-1] + 2 t[j]) + t[j+1])`` along the
    rows, at the even nodes, masked to the coarse interior, on (Sc, Sc)."""
    row3 = torch.roll(r, 1, -2) + 2.0 * r + torch.roll(r, -1, -2)
    agg = 0.25 * (torch.roll(row3, 1, -1) + 2.0 * row3
                  + torch.roll(row3, -1, -1))
    return ops.mask_interior(_fit(agg[::2, ::2], Sc), n // 2)


def prolong_plain(ec, S: int):
    """Bilinear prolongation in the Pallas order: each coarse value fills a
    2 x 2 block, then rows average with the next row, then columns with the
    next column; coarse nodes past ``ec`` read 0."""
    e = _fit(ec, S // 2 + 1)
    E = e.repeat_interleave(2, 0).repeat_interleave(2, 1)
    F = 0.5 * (E[:-1] + E[1:])
    return (0.5 * (F[:, :-1] + F[:, 1:]))[:S, :S]


def zebra_smooth_restrict_plain(u, b, coef, n: int, Sc: int, sweeps: int):
    """K1z's plain version: sweeps -> residual -> full weighting."""
    v = zebra_sweeps_plain(u, b, coef, n, sweeps)
    return v, restrict_fw_plain(residual9_plain(v, b, coef, n), n, Sc)


def prolong_zebra_smooth_plain(u, b, ec, coef, n: int, sweeps: int):
    """K2z's plain version: mask(u + P ec) -> sweeps."""
    v = ops.mask_interior(u + prolong_plain(ec, u.shape[-1]), n)
    return zebra_sweeps_plain(v, b, coef, n, sweeps)


def prolong_zebra_smooth_resnorm_plain(u, b, ec, coef, n: int, sweeps: int):
    """K2z-resnorm's plain version: (u', ||b - A u'||_2 as 0-d float32)."""
    v = prolong_zebra_smooth_plain(u, b, ec, coef, n, sweeps)
    return v, ops.norm2(residual9_plain(v, b, coef, n))


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

def _check(entry: str, u, coef) -> None:
    """What the kernels do not take raises, on either device."""
    if u.dtype != torch.float32:
        raise NotImplementedError(f"{entry}: float32 only, got {u.dtype}")
    S = u.shape[-1]
    if tuple(coef.shape) != (9, S, S):
        raise ValueError(f"{entry}: coefficient planes must be (9, {S}, "
                         f"{S}), got {tuple(coef.shape)}")


def _check_cuda(entry: str, tensors, shapes) -> None:
    _build.check_inputs(entry, tensors, shapes)
    S = tensors[0].shape[-1]
    if not supported_zebra(S, 1, torch.float32):
        raise ValueError(f"{entry}: S = {S} is not a multiple of 128 whose "
                         "line fits in shared memory")


def _count(entry: str, err: int, sweeps: int) -> None:
    _build.check(err, entry)
    LAUNCHES[entry] += launches(entry, sweeps)


def zebra_sweeps(u, b, coef, n: int, sweeps: int):
    """``sweeps`` zebra_x sweeps (odd lines, then even lines, each)."""
    entry = "zebra_sweeps"
    _check(entry, u, coef)
    if sweeps <= 0:
        return u
    if u.device.type == "cpu":
        return zebra_sweeps_plain(u, b, coef, n, sweeps)
    S = u.shape[-1]
    _check_cuda(entry, (u, b, coef), ((S, S), (S, S), (9, S, S)))
    lib = _build.lib()
    u_out = torch.empty_like(u)
    with torch.cuda.device(u.device):
        err = lib.tmt_zebra_sweeps(
            u.data_ptr(), b.data_ptr(), coef.data_ptr(), u_out.data_ptr(), S,
            n, sweeps, torch.cuda.current_stream().cuda_stream)
    _count(entry, err, sweeps)
    return u_out


def zebra_smooth_restrict(u, b, coef, n: int, Sc: int, sweeps: int):
    """K1z: (u after ``sweeps`` sweeps, the restricted residual (Sc, Sc),
    zero outside the coarse interior and so past S/2)."""
    entry = "zebra_smooth_restrict"
    _check(entry, u, coef)
    if u.device.type == "cpu":
        return zebra_smooth_restrict_plain(u, b, coef, n, Sc, sweeps)
    S = u.shape[-1]
    _check_cuda(entry, (u, b, coef), ((S, S), (S, S), (9, S, S)))
    if 2 * Sc < S:
        raise ValueError(f"{entry}: the coarse grid must cover S/2")
    sweeps = max(sweeps, 0)
    lib = _build.lib()
    u_out = torch.empty_like(u) if sweeps else u
    rc = torch.empty((Sc, Sc), dtype=u.dtype, device=u.device)
    with torch.cuda.device(u.device):
        err = lib.tmt_zebra_smooth_restrict(
            u.data_ptr(), b.data_ptr(), coef.data_ptr(), u_out.data_ptr(),
            rc.data_ptr(), S, Sc, n, sweeps,
            torch.cuda.current_stream().cuda_stream)
    _count(entry, err, sweeps)
    return u_out, rc


def _prolong_smooth_cuda(entry, u, b, ec, coef, n, sweeps, resnorm):
    S, Sc = u.shape[-1], ec.shape[-1]
    _check_cuda(entry, (u, b, ec, coef), ((S, S), (S, S), (Sc, Sc),
                                          (9, S, S)))
    sweeps = max(sweeps, 0)
    lib = _build.lib()
    u_out = torch.empty_like(u)
    partials = out_sum = None
    if resnorm:
        partials = torch.empty(S, dtype=torch.float32, device=u.device)
        out_sum = torch.empty((), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        err = lib.tmt_zebra_prolong_smooth(
            u.data_ptr(), b.data_ptr(), ec.data_ptr(), coef.data_ptr(),
            u_out.data_ptr(),
            None if partials is None else partials.data_ptr(),
            None if out_sum is None else out_sum.data_ptr(),
            S, Sc, n, sweeps, torch.cuda.current_stream().cuda_stream)
    _count(entry, err, sweeps)
    return u_out, out_sum


def prolong_zebra_smooth(u, b, ec, coef, n: int, sweeps: int):
    """K2z: u <- zebra-smooth(mask(u + P ec), b) with ``sweeps`` sweeps."""
    entry = "prolong_zebra_smooth"
    _check(entry, u, coef)
    if u.device.type == "cpu":
        return prolong_zebra_smooth_plain(u, b, ec, coef, n, sweeps)
    return _prolong_smooth_cuda(entry, u, b, ec, coef, n, sweeps, False)[0]


def prolong_zebra_smooth_resnorm(u, b, ec, coef, n: int, sweeps: int):
    """Like :func:`prolong_zebra_smooth`, and also ``||b - A u'||_2`` as a
    0-d float32 tensor, summed in a fixed order."""
    entry = "prolong_zebra_smooth_resnorm"
    _check(entry, u, coef)
    if u.device.type == "cpu":
        return prolong_zebra_smooth_resnorm_plain(u, b, ec, coef, n, sweeps)
    u_out, ss = _prolong_smooth_cuda(entry, u, b, ec, coef, n, sweeps, True)
    return u_out, torch.sqrt(ss)
