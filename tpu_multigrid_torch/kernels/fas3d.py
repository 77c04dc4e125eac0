"""The two kernels of a 3D FAS level visit, K1f_3 and K2f_3.

* K1f_3, :func:`fas_smooth_restrict3` / :func:`qfas_smooth_restrict3`:
  nonlinear pre-smoothing, the nonlinear residual, the solution injection
  and the FAS coarse right-hand side ``bc = N_c(inject u') + R r`` (``R =
  P^T / 2``) in one launch (``csrc/fas3d.cu``).
* K2f_3, :func:`fas_prolong_smooth3` / :func:`qfas_prolong_smooth3` (and the
  ``_resnorm3`` variants): trilinear prolongation of the coarse correction,
  the correction add and nonlinear post-smoothing.

The ``fas_*`` entries take ``PointwiseNonlinearOp`` over the 7-point
stencil (Jacobi–Newton, diag 6), the ``qfas_*`` entries
``QuasilinearFluxOp3`` (Picard–Jacobi, six edges); both on the (S, S, Sx)
layout of ``kernels.transfer3d``.  They replace the Pallas TPU kernels
``tpu_multigrid/kernels/fas3d.py::_fas_smooth_restrict3`` and
``::_fas_prolong_smooth3`` and keep their entries' signatures.

Each entry runs its plain torch version (``*_plain``, in the Pallas
kernels' order: neighbour sums x, y, z; the restriction and prolongation of
``kernels.transfer3d``) on CPU tensors, with any callable, and launches its
CUDA kernel on CUDA tensors, where it takes only the carried
nonlinearities of ``kernels.fas``.  A halo deeper than the 3D window holds
is split into launches as K1_3's is (``transfer3d.split_plan``): K1f_3 runs
its leading steps as smoothing passes (K2f_3 with no correction), K2f_3 its
trailing ones, the resnorm fused into the last.  ``LAUNCHES`` counts kernel
launches per entry, each launch of a split call included.
"""

from __future__ import annotations

import torch

from ..core import ops, ops3d
from ..core.nonlinear import inject_solution3
from . import _build
from . import transfer3d as _t3
from .fas import (jn_step, nl_residual, pq_capply, pq_residual, pq_step,
                  pw_capply, selector)
from .stencil3d import nbr3

LAUNCHES = {"fas_smooth_restrict3": 0, "fas_prolong_smooth3": 0,
            "fas_prolong_smooth_resnorm3": 0, "qfas_smooth_restrict3": 0,
            "qfas_prolong_smooth3": 0, "qfas_prolong_smooth_resnorm3": 0}


def fas3_supported(shape, shape_c, steps: int, dtype) -> bool:
    """Geometry gate: K1_3/K2_3's (``transfer3d.supported3``), as
    ``tpu_multigrid.kernels.fas3d.fas3_supported`` is."""
    return _t3.supported3(shape, shape_c, steps, dtype)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

# (d, axis) of the six edges: z+1, z-1, y+1, y-1, x+1, x-1.
_EDGES3 = tuple((d, ax) for ax in (-3, -2, -1) for d in (1, -1))


def flux_diag3(state, a):
    """(Σ_e a(mid)(u - u_nbr), Σ_e a(mid)) over the six edges, in
    ``QuasilinearFluxOp3``'s order."""
    flux = torch.zeros_like(state)
    diag = torch.zeros_like(state)
    for d, ax in _EDGES3:
        un = torch.roll(state, -d, ax)
        ae = a(0.5 * (state + un)).to(state.dtype)
        flux = flux + ae * (state - un)
        diag = diag + ae
    return flux, diag


def _pw3(omega, h2, diag, phi, dphi):
    """(step, resid, capply) of the pointwise family: the 2D closures with
    the 3D neighbour sum (x, y, z)."""
    h2c = 4.0 * h2
    return (lambda s, b, m: jn_step(s, b, m, omega, h2, diag, phi, dphi,
                                    nbr=nbr3),
            lambda s, b, m: nl_residual(s, b, m, h2, diag, phi, nbr=nbr3),
            lambda c, m: pw_capply(c, m, h2c, diag, phi, nbr=nbr3))


def _pq3(omega, a):
    return (lambda s, b, m: pq_step(s, b, m, omega, a, fluxes=flux_diag3),
            lambda s, b, m: pq_residual(s, b, m, a, fluxes=flux_diag3),
            lambda c, m: pq_capply(c, m, a, fluxes=flux_diag3))


def _k1f3_plain(u, b, n, shape_c, sweeps, step, resid, capply):
    shape_c = ops3d._shape3(shape_c)
    inter = ops3d.interior_mask3(u.shape, n, u.device)
    v = u
    for _ in range(sweeps):
        v = step(v, b, inter)
    rc = _t3.restrict3_plain(resid(v, b, inter), n, shape_c)
    uc0 = inject_solution3(v, n, shape_c)
    cmask = ops3d.interior_mask3(shape_c, n // 2, u.device)
    return v, uc0, torch.where(cmask, capply(uc0, cmask) + rc, 0.0)


def _k2f3_plain(u, b, ec, n, sweeps, step, resid, resnorm):
    inter = ops3d.interior_mask3(u.shape, n, u.device)
    v = ops3d.mask_interior3(u + _t3.prolong3_plain(ec, u.shape), n)
    for _ in range(sweeps):
        v = step(v, b, inter)
    if not resnorm:
        return v
    return v, ops.norm2(resid(v, b, inter))


def fas_smooth_restrict3_plain(u, b, n: int, shape_c, sweeps: int,
                               omega: float, phi, dphi, h2: float,
                               diag: float = 6.0):
    """K1f_3's plain version (pointwise): (u', uc0, bc)."""
    return _k1f3_plain(u, b, n, shape_c, sweeps,
                       *_pw3(omega, h2, diag, phi, dphi))


def fas_prolong_smooth3_plain(u, b, ec, n: int, sweeps: int, omega: float,
                              phi, dphi, h2: float, diag: float = 6.0):
    step, resid, _ = _pw3(omega, h2, diag, phi, dphi)
    return _k2f3_plain(u, b, ec, n, sweeps, step, resid, False)


def fas_prolong_smooth_resnorm3_plain(u, b, ec, n: int, sweeps: int,
                                      omega: float, phi, dphi, h2: float,
                                      diag: float = 6.0):
    step, resid, _ = _pw3(omega, h2, diag, phi, dphi)
    return _k2f3_plain(u, b, ec, n, sweeps, step, resid, True)


def qfas_smooth_restrict3_plain(u, b, n: int, shape_c, sweeps: int,
                                omega: float, a):
    """K1f_3's plain version (quasilinear): (u', uc0, bc)."""
    return _k1f3_plain(u, b, n, shape_c, sweeps, *_pq3(omega, a))


def qfas_prolong_smooth3_plain(u, b, ec, n: int, sweeps: int, omega: float,
                               a):
    step, resid, _ = _pq3(omega, a)
    return _k2f3_plain(u, b, ec, n, sweeps, step, resid, False)


def qfas_prolong_smooth_resnorm3_plain(u, b, ec, n: int, sweeps: int,
                                       omega: float, a):
    step, resid, _ = _pq3(omega, a)
    return _k2f3_plain(u, b, ec, n, sweeps, step, resid, True)


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

def _shape(entry, x) -> tuple:
    if x.dim() != 3:
        raise ValueError(f"{entry}: expected an (Sz, Sy, Sx) grid, got "
                         f"{tuple(x.shape)}")
    return tuple(x.shape)


def _k1f3_cuda(entry, u, b, n, shape_c, sweeps, kind, scalar, omega, h2,
               diag):
    shape = _shape(entry, u)
    shape_c = ops3d._shape3(shape_c)
    _build.check_inputs(entry, (u, b), (shape, shape))
    if any(2 * c < f for f, c in zip(shape, shape_c)):
        raise ValueError(f"{entry}: the coarse grid must cover S/2")
    lib = _build.lib()
    plan = _t3.split_plan(sweeps, 2, lib.window3_max_halo, (omega,))
    uc0 = torch.empty(shape_c, dtype=u.dtype, device=u.device)
    bc = torch.empty_like(uc0)

    def launch(i, src, out, first, k, ws, stream):
        rest = (*shape, *shape_c, n, k, kind, scalar, omega, h2, diag,
                stream)
        if i < len(plan) - 1:      # a leading smoothing pass
            return lib.tmt_fas_prolong_smooth3(src.data_ptr(), b.data_ptr(),
                                               None, out.data_ptr(), None,
                                               None, *rest)
        return lib.tmt_fas_smooth_restrict3(src.data_ptr(), b.data_ptr(),
                                            out.data_ptr(), uc0.data_ptr(),
                                            bc.data_ptr(), *rest)
    return _t3.run_launches(entry, LAUNCHES, u, plan, launch), uc0, bc


def _k2f3_cuda(entry, u, b, ec, n, sweeps, kind, scalar, omega, h2, diag,
               resnorm):
    shape, shape_c = _shape(entry, u), _shape(entry, ec)
    _build.check_inputs(entry, (u, b, ec), (shape, shape, shape_c))
    lib = _build.lib()
    plan = _t3.split_plan(sweeps, int(resnorm), lib.window3_max_halo,
                          (omega,))
    partials = out_sum = None
    if resnorm:
        blocks = lib.tmt_prolong_smooth3_blocks(*shape, plan[-1][1])
        partials = torch.empty(blocks, dtype=torch.float32, device=u.device)
        out_sum = torch.empty((), dtype=torch.float32, device=u.device)

    def launch(i, src, out, first, k, ws, stream):
        norm = resnorm and i == len(plan) - 1
        return lib.tmt_fas_prolong_smooth3(
            src.data_ptr(), b.data_ptr(), ec.data_ptr() if i == 0 else None,
            out.data_ptr(), partials.data_ptr() if norm else None,
            out_sum.data_ptr() if norm else None, *shape, *shape_c, n, k,
            kind, scalar, omega, h2, diag, stream)
    u_out = _t3.run_launches(entry, LAUNCHES, u, plan, launch)
    return (u_out, torch.sqrt(out_sum)) if resnorm else u_out


def fas_smooth_restrict3(u, b, n: int, shape_c, sweeps: int, omega: float,
                         phi, dphi, h2: float, diag: float = 6.0):
    """3D FAS K1f_3 (pointwise family): (u', uc0, bc)."""
    if u.device.type == "cpu":
        return fas_smooth_restrict3_plain(u, b, n, shape_c, sweeps, omega,
                                          phi, dphi, h2, diag)
    kind, scalar = selector("fas_smooth_restrict3", phi, dphi)
    return _k1f3_cuda("fas_smooth_restrict3", u, b, n, shape_c, sweeps, kind,
                      scalar, omega, h2, diag)


def fas_prolong_smooth3(u, b, ec, n: int, sweeps: int, omega: float, phi,
                        dphi, h2: float, diag: float = 6.0):
    """3D FAS K2f_3 (pointwise family)."""
    if u.device.type == "cpu":
        return fas_prolong_smooth3_plain(u, b, ec, n, sweeps, omega, phi,
                                         dphi, h2, diag)
    kind, scalar = selector("fas_prolong_smooth3", phi, dphi)
    return _k2f3_cuda("fas_prolong_smooth3", u, b, ec, n, sweeps, kind,
                      scalar, omega, h2, diag, False)


def fas_prolong_smooth_resnorm3(u, b, ec, n: int, sweeps: int, omega: float,
                                phi, dphi, h2: float, diag: float = 6.0):
    """K2f_3 and the nonlinear residual norm as a 0-d float32 tensor."""
    if u.device.type == "cpu":
        return fas_prolong_smooth_resnorm3_plain(u, b, ec, n, sweeps, omega,
                                                 phi, dphi, h2, diag)
    kind, scalar = selector("fas_prolong_smooth_resnorm3", phi, dphi)
    return _k2f3_cuda("fas_prolong_smooth_resnorm3", u, b, ec, n, sweeps,
                      kind, scalar, omega, h2, diag, True)


def qfas_smooth_restrict3(u, b, n: int, shape_c, sweeps: int, omega: float,
                          a):
    """3D quasilinear FAS K1f_3 (Picard–Jacobi)."""
    if u.device.type == "cpu":
        return qfas_smooth_restrict3_plain(u, b, n, shape_c, sweeps, omega, a)
    kind, scalar = selector("qfas_smooth_restrict3", a)
    return _k1f3_cuda("qfas_smooth_restrict3", u, b, n, shape_c, sweeps,
                      kind, scalar, omega, 0.0, 0.0)


def qfas_prolong_smooth3(u, b, ec, n: int, sweeps: int, omega: float, a):
    if u.device.type == "cpu":
        return qfas_prolong_smooth3_plain(u, b, ec, n, sweeps, omega, a)
    kind, scalar = selector("qfas_prolong_smooth3", a)
    return _k2f3_cuda("qfas_prolong_smooth3", u, b, ec, n, sweeps, kind,
                      scalar, omega, 0.0, 0.0, False)


def qfas_prolong_smooth_resnorm3(u, b, ec, n: int, sweeps: int, omega: float,
                                 a):
    if u.device.type == "cpu":
        return qfas_prolong_smooth_resnorm3_plain(u, b, ec, n, sweeps, omega,
                                                  a)
    kind, scalar = selector("qfas_prolong_smooth_resnorm3", a)
    return _k2f3_cuda("qfas_prolong_smooth_resnorm3", u, b, ec, n, sweeps,
                      kind, scalar, omega, 0.0, 0.0, True)
