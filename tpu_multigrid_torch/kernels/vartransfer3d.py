"""The two kernels of a 3D variable-coefficient multigrid level visit, K1v_3
and K2v_3.

* K1v_3, :func:`var_smooth_restrict3`: flux-stencil smoothing steps, the
  residual and its full-weighting restriction, in one launch
  (``csrc/vartransfer3d.cu``).
* K2v_3, :func:`var_prolong_smooth3` / :func:`var_prolong_smooth_resnorm3`:
  trilinear prolongation of the coarse correction, the correction add and
  the smoothing steps, optionally with ``||b - A u'||_2``.

They replace the Pallas TPU kernels ``tpu_multigrid/kernels/
vartransfer3d.py::_var_smooth_restrict3`` and ``::_var_prolong_smooth3``.
The coefficients come as one (C, Sz, Sy, Sx) stack (:func:`_flat_coef3`):
C = 3 transmissibility planes [tz, ty, tx] of a ``VarStencilOp3D``, 4 with
its reaction plane c2, or 6 directional planes [cp_z, cp_y, cp_x, cm_z,
cm_y, cm_x] of a variable-wind ``Directional7Op``.  Each entry runs its
plain torch version (``*_plain``, in the Pallas kernels' order) on CPU
tensors and launches its CUDA kernel on CUDA tensors; on a CUDA tensor it
never falls back.  A depth whose halo does not fit in the 3D window is
split into launches as ``kernels.transfer3d`` splits K1_3 / K2_3.
``LAUNCHES`` counts kernel launches per entry, each launch of a split call
included.

The plain versions and the kernels derive the diagonal and its inverse from
the planes (``(tz + tzm) + (ty + tym) + (tx + txm)``, + c2; the stored
``inv_diag`` is not read) and sum the off-diagonal x+, x-, y+, y-, z+, z-;
the operators keep the JAX package's jnp order, so the kernel path and the
plain operator path agree to f32 roundoff.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import ops, ops3d
from . import _build
from .transfer3d import (launch_args, prolong3_plain, restrict3_plain,
                         run_launches, split_plan)

LAUNCHES = {"var_smooth_restrict3": 0, "var_prolong_smooth3": 0,
            "var_prolong_smooth_resnorm3": 0}


def supported_var3(shape, shape_c, steps: int, dtype,
                   nplanes: int = 3) -> bool:
    """Whether a fine/coarse level pair with ``steps`` smoothing steps (the
    larger of the two visits') and ``nplanes`` coefficient planes goes to
    K1v_3 / K2v_3: the shape and depth rules of ``tpu_multigrid.kernels.
    vartransfer3d.supported_var3`` (f32, lane-aligned x of at least 256, y a
    multiple of 16, even z, steps + 2 <= 16), so both packages fuse the same
    level pairs.  (That gate also asks the TPU kernels' VMEM tiling to
    exist.)"""
    Sz, Sy, Sx = shape
    Szc, Syc, Scx = shape_c
    if dtype != torch.float32 or nplanes not in (3, 4, 6):
        return False
    if Sx % 128 or Scx % 128 or Sx < 256:
        return False
    if Sy % 16 or Syc % 8 or Sz % 2:
        return False
    if steps + 2 > 16:
        return False
    return 2 * Szc >= Sz and 2 * Syc >= Sy and 2 * Scx >= Sx


def _flat_coef3(op):
    """An operator's (C, Sz, Sy, Sx) coefficient stack: its set-up
    ``coef_stack`` when it has one, else the planes stacked."""
    if op.coef_stack is not None:
        return op.coef_stack
    if hasattr(op, "cp"):
        return torch.stack([*op.cp, *op.cm])
    planes = [op.tz, op.ty, op.tx] + ([op.c2] if op.c2 is not None else [])
    return torch.stack(planes)


# ---------------------------------------------------------------------------
# Plain versions, in the Pallas kernels' order
# ---------------------------------------------------------------------------

def expand3(coef):
    """(diag, invd, planes) of a coefficient stack: ``planes`` the couplings
    to x+, x-, y+, y-, z+, z- (the minus planes of a flux stack are the
    stored ones rolled one node on), invd = 1 / diag where diag != 0."""
    if coef.shape[0] == 6:
        cpz, cpy, cpx, cmz, cmy, cmx = coef
        diag = ((cpz + cmz) + (cpy + cmy)) + (cpx + cmx)
        planes = (cpx, cmx, cpy, cmy, cpz, cmz)
    else:
        tz, ty, tx = coef[0], coef[1], coef[2]
        tzm = torch.roll(tz, 1, -3)
        tym = torch.roll(ty, 1, -2)
        txm = torch.roll(tx, 1, -1)
        diag = ((tz + tzm) + (ty + tym)) + (tx + txm)
        if coef.shape[0] == 4:
            diag = diag + coef[3]
        planes = (tx, txm, ty, tym, tz, tzm)
    nz = diag != 0.0
    invd = torch.where(nz, 1.0 / torch.where(nz, diag, 1.0), 0.0)
    return diag, invd, planes


def off3(planes, v):
    """x+ v(x+1) + x- v(x-1) + y+ v(y+1) + ..., summed from the left."""
    shifts = ((-1, -1), (1, -1), (-1, -2), (1, -2), (-1, -3), (1, -3))
    acc = None
    for c, (s, ax) in zip(planes, shifts):
        t = c * torch.roll(v, s, ax)
        acc = t if acc is None else acc + t
    return acc


def var_smooth3_plain(u, b, coef, n: int, steps: int, smoother: str, omega,
                      first_step: int = 0):
    """``steps`` Jacobi steps (weight ``omega[j % len]`` or ``omega`` at step
    j) or RB-GS half-steps (half-step j updates parity (first_step + j) %
    2)."""
    if steps <= 0:
        return u
    _, invd, planes = expand3(coef)
    interior = ops3d.interior_mask3(u.shape, n, u.device)
    parity = ops3d.parity3(u.shape, u.device)
    v = u
    for j in range(steps):
        f = b + off3(planes, v)
        if smoother == "rbgs":
            color = interior & (parity == (first_step + j) % 2)
            v = torch.where(color, invd * f, v)
        else:
            w = omega[j % len(omega)] if isinstance(omega, tuple) else omega
            v = torch.where(interior, (1.0 - w) * v + (w * invd) * f, 0.0)
    return v


def var_residual3_plain(u, b, coef, n: int):
    """(b - diag u) + off, masked to the interior."""
    diag, _, planes = expand3(coef)
    return ops3d.mask_interior3((b - diag * u) + off3(planes, u), n)


def var_smooth_restrict3_plain(u, b, coef, n: int, shape_c, sweeps: int,
                               smoother: str = "jacobi", omega=2.0 / 3.0):
    """K1v_3's plain version: sweeps -> residual -> restriction, zero
    outside the coarse interior (and so past S/2)."""
    steps = 2 * sweeps if smoother == "rbgs" else sweeps
    v = var_smooth3_plain(u, b, coef, n, steps, smoother, omega)
    return v, restrict3_plain(var_residual3_plain(v, b, coef, n), n, shape_c)


def var_prolong_smooth3_plain(u, b, ec, coef, n: int, sweeps: int,
                              smoother: str = "jacobi", omega=2.0 / 3.0):
    """K2v_3's plain version: mask(u + P ec) -> sweeps."""
    steps = 2 * sweeps if smoother == "rbgs" else sweeps
    state = ops3d.mask_interior3(u + prolong3_plain(ec, u.shape), n)
    return var_smooth3_plain(state, b, coef, n, steps, smoother, omega)


def var_prolong_smooth_resnorm3_plain(u, b, ec, coef, n: int, sweeps: int,
                                      smoother: str = "jacobi",
                                      omega=2.0 / 3.0):
    """K2v_3-resnorm's plain version: (u', ||b - A u'||_2 as 0-d float32)."""
    v = var_prolong_smooth3_plain(u, b, ec, coef, n, sweeps, smoother, omega)
    return v, ops.norm2(var_residual3_plain(v, b, coef, n))


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def var_weights3(ws: tuple) -> np.ndarray:
    """Host weight array [c1..., c2...] of per-step Jacobi weights ``ws``:
    c1 = 1 - w, c2 = w, each rounded to float32 from its float64 value."""
    return np.array([1.0 - w for w in ws] + list(ws), np.float32)


def _check(entry, u, coef, smoother, box=None, cbox=None) -> None:
    if box is not None or cbox is not None:
        raise NotImplementedError(f"{entry}: box operators (mixed boundary "
                                  "conditions) are not ported yet")
    if u.dtype != torch.float32:
        raise NotImplementedError(f"{entry}: float32 only, got {u.dtype}")
    if smoother not in ("jacobi", "rbgs"):
        raise ValueError(f"unknown smoother {smoother!r}")
    if coef.dim() != 4 or coef.shape[0] not in (3, 4, 6) \
            or tuple(coef.shape[1:]) != tuple(u.shape):
        raise ValueError(f"{entry}: expected a (3, 4 or 6, *{tuple(u.shape)})"
                         f" coefficient stack, got {tuple(coef.shape)}")


def _plan(entry, lib, smoother, omega, sweeps, extra):
    """(rbgs flag, launch plan) of a C entry (RB-GS takes no weights)."""
    steps, rbgs, ws, _ = launch_args(entry, smoother, omega, sweeps, None)
    return rbgs, split_plan(steps, extra, lib.window3_max_halo, ws)


def var_smooth_restrict3(u, b, coef, n: int, shape_c, sweeps: int,
                         smoother: str = "jacobi", omega=2.0 / 3.0, box=None,
                         cbox=None):
    """K1v_3: (u after ``sweeps`` sweeps, restricted residual of shape
    ``shape_c``).  ``box`` / ``cbox`` (mixed boundary conditions) raise."""
    entry = "var_smooth_restrict3"
    _check(entry, u, coef, smoother, box, cbox)
    if u.device.type == "cpu":
        return var_smooth_restrict3_plain(u, b, coef, n, shape_c, sweeps,
                                          smoother, omega)
    shape = tuple(u.shape)
    shape_c = ops3d._shape3(shape_c)
    _build.check_inputs(entry, (u, b, coef),
                        (shape, shape, tuple(coef.shape)))
    if any(2 * c < f for f, c in zip(shape, shape_c)):
        raise ValueError(f"{entry}: the coarse grid must cover S/2")
    lib = _build.lib()
    rbgs, plan = _plan(entry, lib, smoother, omega, sweeps, 2)
    rc = torch.empty(shape_c, dtype=u.dtype, device=u.device)

    def launch(i, src, out, first, k, ws, stream):
        wt = var_weights3(ws)
        rest = (*shape, *shape_c, n, k, first, rbgs, coef.shape[0],
                wt.ctypes.data, wt.size // 2, stream)
        if i < len(plan) - 1:      # a leading smoothing pass
            return lib.tmt_var_prolong_smooth3(
                src.data_ptr(), b.data_ptr(), None, coef.data_ptr(),
                out.data_ptr(), None, None, *rest)
        return lib.tmt_var_smooth_restrict3(
            src.data_ptr(), b.data_ptr(), coef.data_ptr(), out.data_ptr(),
            rc.data_ptr(), *rest)
    return run_launches(entry, LAUNCHES, u, plan, launch), rc


def _var_prolong_smooth3_cuda(entry, u, b, ec, coef, n, sweeps, smoother,
                              omega, resnorm):
    shape, shape_c = tuple(u.shape), tuple(ec.shape)
    if len(shape) != 3 or len(shape_c) != 3:
        raise ValueError(f"{entry}: expected (Sz, Sy, Sx) grids")
    _build.check_inputs(entry, (u, b, ec, coef),
                        (shape, shape, shape_c, tuple(coef.shape)))
    lib = _build.lib()
    rbgs, plan = _plan(entry, lib, smoother, omega, sweeps, int(resnorm))
    partials = out_sum = None
    if resnorm:
        blocks = lib.tmt_prolong_smooth3_blocks(*shape, plan[-1][1])
        partials = torch.empty(blocks, dtype=torch.float32, device=u.device)
        out_sum = torch.empty((), dtype=torch.float32, device=u.device)

    def launch(i, src, out, first, k, ws, stream):
        wt = var_weights3(ws)
        norm = resnorm and i == len(plan) - 1
        return lib.tmt_var_prolong_smooth3(
            src.data_ptr(), b.data_ptr(), ec.data_ptr() if i == 0 else None,
            coef.data_ptr(), out.data_ptr(),
            partials.data_ptr() if norm else None,
            out_sum.data_ptr() if norm else None, *shape, *shape_c, n, k,
            first, rbgs, coef.shape[0], wt.ctypes.data, wt.size // 2, stream)
    return run_launches(entry, LAUNCHES, u, plan, launch), out_sum


def var_prolong_smooth3(u, b, ec, coef, n: int, sweeps: int,
                        smoother: str = "jacobi", omega=2.0 / 3.0, box=None):
    """K2v_3: u <- var-smooth(mask(u + P ec), b) with ``sweeps`` sweeps."""
    entry = "var_prolong_smooth3"
    _check(entry, u, coef, smoother, box)
    if u.device.type == "cpu":
        return var_prolong_smooth3_plain(u, b, ec, coef, n, sweeps, smoother,
                                         omega)
    return _var_prolong_smooth3_cuda(entry, u, b, ec, coef, n, sweeps,
                                     smoother, omega, False)[0]


def var_prolong_smooth_resnorm3(u, b, ec, coef, n: int, sweeps: int,
                                smoother: str = "jacobi", omega=2.0 / 3.0,
                                box=None):
    """Like :func:`var_prolong_smooth3`, and also ``||b - A u'||_2`` as a
    0-d float32 tensor, summed in a fixed order."""
    entry = "var_prolong_smooth_resnorm3"
    _check(entry, u, coef, smoother, box)
    if u.device.type == "cpu":
        return var_prolong_smooth_resnorm3_plain(u, b, ec, coef, n, sweeps,
                                                 smoother, omega)
    u_out, ss = _var_prolong_smooth3_cuda(entry, u, b, ec, coef, n, sweeps,
                                          smoother, omega, True)
    return u_out, torch.sqrt(ss)


def var_smooth_restrict_ext3(*args, **kwargs):
    """K1v_3 on a ghost-extended shard block (``origin`` / ``ghost``): the
    distributed path, not ported yet."""
    raise NotImplementedError("var_smooth_restrict_ext3: ghost-extended "
                              "blocks (distributed solves) are not ported "
                              "yet")


def var_prolong_smooth_ext3(*args, **kwargs):
    """K2v_3 on a ghost-extended shard block: not ported yet."""
    raise NotImplementedError("var_prolong_smooth_ext3: ghost-extended "
                              "blocks (distributed solves) are not ported "
                              "yet")
