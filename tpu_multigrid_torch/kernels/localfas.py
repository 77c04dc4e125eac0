"""The two kernels of a FAS level visit on a ghost-extended block,
K1f-local and K2f-local.

The block is :mod:`.local`'s: an ``(R, C) = (lr + 2 GR, lc + 2 GC)`` array
whose cell ``(i, j)`` has the global coordinates ``origin + (i, j)``; the
coarse blocks are ``(R/2 + GR, C/2 + GC)``.

* K1f-local, :func:`fas_smooth_restrict_ext` /
  :func:`qfas_smooth_restrict_ext`: nonlinear smoothing steps, the
  nonlinear residual, the solution injection ``uc0`` and the FAS coarse
  right-hand side ``bc = N_c(uc0) + FW(b - N(u'))``, in one launch;
  returns ``(u', uc0, bc)``.
* K2f-local, :func:`fas_prolong_smooth_ext` /
  :func:`qfas_prolong_smooth_ext`: ``where(live, u + P ec, 0)`` and the
  nonlinear smoothing steps; with ``want_resnorm`` also the sum of squares
  of ``b - N(u')`` over the owned live cells, which the caller adds over
  the mesh.

The ``fas_*`` entries take the pointwise family (Jacobi–Newton over the
5-point stencil), the ``qfas_*`` entries the quasilinear flux family
(Picard–Jacobi).  They replace the Pallas TPU kernels ``tpu_multigrid/
kernels/localfas.py::_k1f_local`` and ``::_k2f_local`` (``csrc/
localfas.cu``) and keep their entries' signatures; ``origin`` is a pair of
host ints.

Each entry runs its plain torch version (``*_plain``) on CPU tensors, with
any callable ``phi``/``a``, and launches its CUDA kernel on CUDA tensors,
never falling back: a block outside :func:`fas_supported_local`, or a
nonlinearity the kernels do not carry (``core.nonlinear.kernel_selector``),
raises.  The plain versions evaluate :mod:`.fas`'s step, residual and coarse
apply in the Pallas kernels' order, with :mod:`.local`'s global masks,
full-weighting aggregate and prolongation; cells outside the array read as
zero, so every output is defined on the whole array and the kernels match
it bitwise there.  ``LAUNCHES`` counts kernel launches per entry.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from . import local as KL
from .fas import (jn_step, nl_residual, pq_capply, pq_residual, pq_step,
                  pw_capply, selector)

GR, GC = KL.GR, KL.GC
# How a caller runs a nonlinearity the kernels do not carry.
_PLAIN = "a mesh on CPU tensors"

LAUNCHES = {"fas_smooth_restrict_ext": 0, "fas_prolong_smooth_ext": 0,
            "fas_prolong_smooth_ext_resnorm": 0,
            "qfas_smooth_restrict_ext": 0, "qfas_prolong_smooth_ext": 0,
            "qfas_prolong_smooth_ext_resnorm": 0}


def fas_supported_local(R: int, C: int, steps: int, dtype) -> bool:
    """The linear extended-block kernels' gate (``local.supported_local``):
    the FAS payload's deepest read, the coarse apply's neighbours of the
    injection, is fine reach ``steps + 2``, the linear one's."""
    return KL.supported_local(R, C, steps, dtype)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

_EDGES2 = ((0, 1), (0, -1), (1, 0), (-1, 0))


def flux_diag_ext(state, a):
    """``kernels.fas.flux_diag`` with cells outside the block reading 0."""
    R, C = state.shape
    p = F.pad(state, (1, 1, 1, 1))
    flux = torch.zeros_like(state)
    diag = torch.zeros_like(state)
    for di, dj in _EDGES2:
        un = p[1 + di:1 + di + R, 1 + dj:1 + dj + C]
        ae = a(0.5 * (state + un)).to(state.dtype)
        flux = flux + ae * (state - un)
        diag = diag + ae
    return flux, diag


def _pw(omega, h2, diag, phi, dphi):
    """(step, resid, capply) of the pointwise family on a block."""
    h2c = 4.0 * h2
    return (lambda s, b, m: jn_step(s, b, m, omega, h2, diag, phi, dphi,
                                    nbr=KL._nbr),
            lambda s, b, m: nl_residual(s, b, m, h2, diag, phi, nbr=KL._nbr),
            lambda c, m: pw_capply(c, m, h2c, diag, phi, nbr=KL._nbr))


def _pq(omega, a):
    return (lambda s, b, m: pq_step(s, b, m, omega, a, fluxes=flux_diag_ext),
            lambda s, b, m: pq_residual(s, b, m, a, fluxes=flux_diag_ext),
            lambda c, m: pq_capply(c, m, a, fluxes=flux_diag_ext))


def _k1f_plain(u, b, origin, n, sweeps, step, resid, capply):
    R, C = u.shape
    live = KL._masks(R, C, origin, n, u.device)[0]
    v = u
    for _ in range(sweeps):
        v = step(v, b, live)
    rc = KL.into_coarse(KL.fw_even(resid(v, b, live)))
    cmask = KL.into_coarse(KL.coarse_mask(R, C, origin, n, u.device))
    uc0 = KL.into_coarse(v[0::2, 0::2])
    uc0 = torch.where(cmask, uc0, 0.0)
    bc = torch.where(cmask, capply(uc0, cmask) + torch.where(cmask, rc, 0.0),
                     0.0)
    return v, uc0, bc


def _k2f_plain(u, b, ec, origin, n, sweeps, step, resid, want_resnorm):
    R, C = u.shape
    live = KL._masks(R, C, origin, n, u.device)[0]
    v = torch.where(live, u + KL._prolonged(ec, R, C), 0.0)
    for _ in range(sweeps):
        v = step(v, b, live)
    if not want_resnorm:
        return v
    r = resid(v, b, live)[GR:R - GR, GC:C - GC]
    return v, torch.sum(r * r)


def fas_smooth_restrict_ext_plain(u, b, origin, n: int, sweeps: int,
                                  omega: float, phi, dphi, h2: float,
                                  diag: float = 4.0):
    """K1f-local's plain version (pointwise): (u', uc0, bc)."""
    return _k1f_plain(u, b, origin, n, sweeps,
                      *_pw(omega, h2, diag, phi, dphi))


def fas_prolong_smooth_ext_plain(u, b, ec, origin, n: int, sweeps: int,
                                 omega: float, phi, dphi, h2: float,
                                 diag: float = 4.0,
                                 want_resnorm: bool = False):
    """K2f-local's plain version (pointwise): u', and with
    ``want_resnorm`` the owned sum of squares (0-d float32)."""
    step, resid, _ = _pw(omega, h2, diag, phi, dphi)
    return _k2f_plain(u, b, ec, origin, n, sweeps, step, resid, want_resnorm)


def qfas_smooth_restrict_ext_plain(u, b, origin, n: int, sweeps: int,
                                   omega: float, a):
    """K1f-local's plain version (quasilinear): (u', uc0, bc)."""
    return _k1f_plain(u, b, origin, n, sweeps, *_pq(omega, a))


def qfas_prolong_smooth_ext_plain(u, b, ec, origin, n: int, sweeps: int,
                                  omega: float, a,
                                  want_resnorm: bool = False):
    step, resid, _ = _pq(omega, a)
    return _k2f_plain(u, b, ec, origin, n, sweeps, step, resid, want_resnorm)


# ---------------------------------------------------------------------------
# Entries
# ---------------------------------------------------------------------------

def _check(entry, u, sweeps):
    if u.dtype != torch.float32:
        raise NotImplementedError(f"{entry}: float32 only, got {u.dtype}")
    R, C = u.shape
    if sweeps < 0 or not fas_supported_local(R, C, sweeps, u.dtype):
        raise ValueError(f"{entry}: an ({R}, {C}) block with {sweeps} sweeps "
                         "is outside the kernels' gate (fas_supported_local)")


def _k1f_cuda(entry, u, b, origin, n, sweeps, kind, scalar, omega, h2,
              diag):
    R, C = u.shape
    _build.check_inputs(entry, (u, b), ((R, C), (R, C)))
    lib = _build.lib()
    u_out = torch.empty_like(u)
    uc0 = torch.empty(KL.coarse_shape(R, C), dtype=u.dtype, device=u.device)
    bc = torch.empty_like(uc0)
    with torch.cuda.device(u.device):
        err = lib.tmt_fas_smooth_restrict_ext(
            u.data_ptr(), b.data_ptr(), u_out.data_ptr(), uc0.data_ptr(),
            bc.data_ptr(), R, C, int(origin[0]), int(origin[1]), n, sweeps,
            kind, scalar, omega, h2, diag,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, entry)
    LAUNCHES[entry] += 1
    return u_out, uc0, bc


def _k2f_cuda(entry, u, b, ec, origin, n, sweeps, kind, scalar, omega, h2,
              diag, want_resnorm):
    R, C = u.shape
    _build.check_inputs(entry, (u, b, ec), ((R, C), (R, C),
                                            KL.coarse_shape(R, C)))
    lib = _build.lib()
    u_out = torch.empty_like(u)
    partials = out_sum = None
    if want_resnorm:
        tile = lib.transfer_tile
        partials = torch.empty(-(-R // tile) * -(-C // tile),
                               dtype=torch.float32, device=u.device)
        out_sum = torch.empty((), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        err = lib.tmt_fas_prolong_smooth_ext(
            u.data_ptr(), b.data_ptr(), ec.data_ptr(), u_out.data_ptr(),
            None if partials is None else partials.data_ptr(),
            None if out_sum is None else out_sum.data_ptr(), R, C,
            int(origin[0]), int(origin[1]), n, sweeps, kind, scalar, omega,
            h2, diag, torch.cuda.current_stream().cuda_stream)
    _build.check(err, entry)
    LAUNCHES[entry] += 1
    return (u_out, out_sum) if want_resnorm else u_out


def fas_smooth_restrict_ext(u, b, origin, n: int, sweeps: int, omega: float,
                            phi, dphi, h2: float, diag: float = 4.0):
    """K1f-local (pointwise family): ``sweeps`` Jacobi–Newton sweeps, then
    (u', uc0, bc) with the coarse blocks (R/2 + GR, C/2 + GC)."""
    entry = "fas_smooth_restrict_ext"
    _check(entry, u, sweeps)
    if u.device.type == "cpu":
        return fas_smooth_restrict_ext_plain(u, b, origin, n, sweeps, omega,
                                             phi, dphi, h2, diag)
    kind, scalar = selector(entry, phi, dphi, plain=_PLAIN)
    return _k1f_cuda(entry, u, b, origin, n, sweeps, kind, scalar, omega, h2,
                     diag)


def fas_prolong_smooth_ext(u, b, ec, origin, n: int, sweeps: int,
                           omega: float, phi, dphi, h2: float,
                           diag: float = 4.0, want_resnorm: bool = False):
    """K2f-local (pointwise family): u <- JN-smooth(where(live, u + P ec,
    0), b); with ``want_resnorm`` also the owned sum of squares of
    b - N(u') (0-d float32, summed in a fixed order)."""
    entry = ("fas_prolong_smooth_ext_resnorm" if want_resnorm
             else "fas_prolong_smooth_ext")
    _check(entry, u, sweeps)
    if u.device.type == "cpu":
        return fas_prolong_smooth_ext_plain(u, b, ec, origin, n, sweeps,
                                            omega, phi, dphi, h2, diag,
                                            want_resnorm)
    kind, scalar = selector(entry, phi, dphi, plain=_PLAIN)
    return _k2f_cuda(entry, u, b, ec, origin, n, sweeps, kind, scalar, omega,
                     h2, diag, want_resnorm)


def qfas_smooth_restrict_ext(u, b, origin, n: int, sweeps: int,
                             omega: float, a):
    """Quasilinear K1f-local: ``sweeps`` Picard–Jacobi sweeps, then
    (u', uc0, bc)."""
    entry = "qfas_smooth_restrict_ext"
    _check(entry, u, sweeps)
    if u.device.type == "cpu":
        return qfas_smooth_restrict_ext_plain(u, b, origin, n, sweeps, omega,
                                              a)
    kind, scalar = selector(entry, a, plain=_PLAIN)
    return _k1f_cuda(entry, u, b, origin, n, sweeps, kind, scalar, omega, 0.0,
                     0.0)


def qfas_prolong_smooth_ext(u, b, ec, origin, n: int, sweeps: int,
                            omega: float, a, want_resnorm: bool = False):
    """Quasilinear K2f-local, with the owned sum of squares as
    :func:`fas_prolong_smooth_ext`."""
    entry = ("qfas_prolong_smooth_ext_resnorm" if want_resnorm
             else "qfas_prolong_smooth_ext")
    _check(entry, u, sweeps)
    if u.device.type == "cpu":
        return qfas_prolong_smooth_ext_plain(u, b, ec, origin, n, sweeps,
                                             omega, a, want_resnorm)
    kind, scalar = selector(entry, a, plain=_PLAIN)
    return _k2f_cuda(entry, u, b, ec, origin, n, sweeps, kind, scalar, omega,
                     0.0, 0.0, want_resnorm)
