"""The two kernels of a 2D FAS level visit, K1f and K2f.

* K1f, :func:`fas_smooth_restrict` / :func:`qfas_smooth_restrict`: nonlinear
  pre-smoothing, the nonlinear residual, the solution injection and the FAS
  coarse right-hand side ``bc = N_c(inject u') + FW(b - N(u'))``, in one
  launch (``csrc/fas.cu``).
* K2f, :func:`fas_prolong_smooth` / :func:`qfas_prolong_smooth` (and the
  ``_resnorm`` variants, with ``||b - N(u')||_2``): bilinear prolongation of
  the coarse correction, the correction add and nonlinear post-smoothing.

The ``fas_*`` entries take the pointwise family (``PointwiseNonlinearOp``
over the 5-point stencil, Jacobi–Newton), the ``qfas_*`` entries the
quasilinear flux family (``QuasilinearFluxOp``, Picard–Jacobi).  They
replace the Pallas TPU kernels ``tpu_multigrid/kernels/fas.py::
_fas_smooth_restrict`` and ``::_fas_prolong_smooth`` and keep their
entries' signatures.

Each entry runs its plain torch version (``*_plain``) on CPU tensors, with
any callable ``phi``/``a``, and launches its CUDA kernel on CUDA tensors;
on a CUDA tensor it never falls back.  The kernel carries a closed set of
nonlinearities (``core.nonlinear``): φ a :class:`BratuNonlinearity` with
``dphi is phi``, or a a :class:`QuadraticCoefficient`; any other callable
raises ``ValueError`` there.  The plain versions evaluate the Pallas
kernels' nonlinear step, residual and coarse apply in their order, which
the CUDA kernels repeat bitwise; the restriction and prolongation are
K1/K2's (``core.ops`` order, ``kernels.transfer``).  ``LAUNCHES`` counts
kernel launches per entry.
"""

from __future__ import annotations

import torch

from ..core import ops
from ..core.nonlinear import CARRIED, inject_solution, kernel_selector
from . import _build
from . import transfer as _t

LAUNCHES = {"fas_smooth_restrict": 0, "fas_prolong_smooth": 0,
            "fas_prolong_smooth_resnorm": 0, "qfas_smooth_restrict": 0,
            "qfas_prolong_smooth": 0, "qfas_prolong_smooth_resnorm": 0}


def fas_supported(Sf: int, Sc: int, steps: int, dtype) -> bool:
    """Whether a level pair goes to K1f/K2f: float32 and K1/K2's geometry
    gate (``transfer.supported``), as ``tpu_multigrid.kernels.fas.
    fas_supported`` decides."""
    return dtype == torch.float32 and _t.supported(Sf, Sc, steps, dtype)


def selector(entry, *nl, plain: str = "use_kernels=False"):
    """(kind, scalar) of a carried nonlinearity (``nl`` is (phi, dphi) or
    (a,)) for a C entry; a caller's own callable raises ``ValueError``,
    which names ``plain``, how the caller reaches the plain path."""
    sel = kernel_selector(*nl)
    if sel is None:
        raise ValueError(f"{entry}: the CUDA kernel carries only {CARRIED}; "
                         f"got {nl!r} (run it on the plain path: {plain})")
    return sel


# ---------------------------------------------------------------------------
# Plain versions: the Pallas kernels' window closures on the whole grid
# ---------------------------------------------------------------------------

def jn_step(state, b, inter, omega, h2, diag, phi, dphi,
            nbr=ops.neighbor_sum):
    """One Jacobi–Newton step: ap = (diag u - nbr(u)) + h² φ(u), then
    u + ω (b - ap) / (diag + h² φ′(u)) on the interior, 0 elsewhere.
    ``nbr`` is the neighbour sum (``kernels.stencil3d.nbr3`` in 3D)."""
    pv = phi(state).to(state.dtype)
    dv = pv if dphi is phi else dphi(state).to(state.dtype)
    ap = torch.where(inter, diag * state - nbr(state) + h2 * pv, 0.0)
    denom = diag + h2 * dv
    upd = omega * (b - ap) / denom
    return torch.where(inter, state + upd, 0.0)


def nl_residual(state, b, inter, h2, diag, phi, nbr=ops.neighbor_sum):
    ap = torch.where(inter, diag * state - nbr(state)
                     + h2 * phi(state).to(state.dtype), 0.0)
    return torch.where(inter, b - ap, 0.0)


def pw_capply(uc0, cmask, h2c, diag, phi, nbr=ops.neighbor_sum):
    """N_c on the injected solution: (diag uc0 - nbr(uc0)) + h_c² φ(uc0)."""
    return torch.where(cmask, diag * uc0 - nbr(uc0)
                       + h2c * phi(uc0).to(uc0.dtype), 0.0)


_EDGES2 = ((0, 1), (0, -1), (1, 0), (-1, 0))


def flux_diag(state, a):
    """(Σ_e a(mid)(u - u_nbr), Σ_e a(mid)) over the four edges, in
    ``QuasilinearFluxOp``'s order."""
    flux = torch.zeros_like(state)
    diag = torch.zeros_like(state)
    for di, dj in _EDGES2:
        un = torch.roll(state, (-di, -dj), (-2, -1))
        ae = a(0.5 * (state + un)).to(state.dtype)
        flux = flux + ae * (state - un)
        diag = diag + ae
    return flux, diag


def pq_step(state, b, inter, omega, a, fluxes=flux_diag):
    """One Picard–Jacobi step on the frozen-coefficient operator, the
    diagonal guarded by where(d > 0, d, 1)."""
    flux, diag = fluxes(state, a)
    ap = torch.where(inter, flux, 0.0)
    safe = torch.where(diag > 0, diag, 1.0)
    return torch.where(inter, state + omega * (b - ap) / safe, 0.0)


def pq_residual(state, b, inter, a, fluxes=flux_diag):
    flux, _ = fluxes(state, a)
    return torch.where(inter, b - torch.where(inter, flux, 0.0), 0.0)


def pq_capply(uc0, cmask, a, fluxes=flux_diag):
    """The flux form on the injected solution (it is h-independent)."""
    return torch.where(cmask, fluxes(uc0, a)[0], 0.0)


def _k1f_plain(u, b, n, Sc, sweeps, step, resid, capply):
    inter = ops.interior_mask(u.shape[-1], n, u.device)
    v = u
    for _ in range(sweeps):
        v = step(v, b, inter)
    rc = ops.restrict_fw(resid(v, b, inter), n, Sc)
    uc0 = inject_solution(v, n, Sc)
    cmask = ops.interior_mask(Sc, n // 2, u.device)
    return v, uc0, torch.where(cmask, capply(uc0, cmask) + rc, 0.0)


def _k2f_plain(u, b, ec, n, sweeps, step, resid, resnorm):
    inter = ops.interior_mask(u.shape[-1], n, u.device)
    v = _t.prolong_add_plain(u, ec, n)
    for _ in range(sweeps):
        v = step(v, b, inter)
    if not resnorm:
        return v
    return v, ops.norm2(resid(v, b, inter))


def _pw(omega, h2, diag, phi, dphi):
    """(step, resid, capply) of the pointwise family."""
    h2c = 4.0 * h2
    return (lambda s, b, m: jn_step(s, b, m, omega, h2, diag, phi, dphi),
            lambda s, b, m: nl_residual(s, b, m, h2, diag, phi),
            lambda c, m: pw_capply(c, m, h2c, diag, phi))


def _pq(omega, a):
    return (lambda s, b, m: pq_step(s, b, m, omega, a),
            lambda s, b, m: pq_residual(s, b, m, a),
            lambda c, m: pq_capply(c, m, a))


def fas_smooth_restrict_plain(u, b, n: int, Sc: int, sweeps: int,
                              omega: float, phi, dphi, h2: float,
                              diag: float = 4.0):
    """K1f's plain version (pointwise): (u', uc0, bc)."""
    return _k1f_plain(u, b, n, Sc, sweeps, *_pw(omega, h2, diag, phi, dphi))


def fas_prolong_smooth_plain(u, b, ec, n: int, sweeps: int, omega: float,
                             phi, dphi, h2: float, diag: float = 4.0):
    step, resid, _ = _pw(omega, h2, diag, phi, dphi)
    return _k2f_plain(u, b, ec, n, sweeps, step, resid, False)


def fas_prolong_smooth_resnorm_plain(u, b, ec, n: int, sweeps: int,
                                     omega: float, phi, dphi, h2: float,
                                     diag: float = 4.0):
    step, resid, _ = _pw(omega, h2, diag, phi, dphi)
    return _k2f_plain(u, b, ec, n, sweeps, step, resid, True)


def qfas_smooth_restrict_plain(u, b, n: int, Sc: int, sweeps: int,
                               omega: float, a):
    """K1f's plain version (quasilinear): (u', uc0, bc)."""
    return _k1f_plain(u, b, n, Sc, sweeps, *_pq(omega, a))


def qfas_prolong_smooth_plain(u, b, ec, n: int, sweeps: int, omega: float,
                              a):
    step, resid, _ = _pq(omega, a)
    return _k2f_plain(u, b, ec, n, sweeps, step, resid, False)


def qfas_prolong_smooth_resnorm_plain(u, b, ec, n: int, sweeps: int,
                                      omega: float, a):
    step, resid, _ = _pq(omega, a)
    return _k2f_plain(u, b, ec, n, sweeps, step, resid, True)


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

def _check(entry, sweeps, lib):
    if not 0 <= sweeps <= lib.transfer_max_steps:
        raise ValueError(f"{entry}: {sweeps} sweeps do not fit in shared "
                         "memory")


def _k1f_cuda(entry, u, b, n, Sc, sweeps, kind, scalar, omega, h2, diag):
    S = u.shape[-1]
    _build.check_inputs(entry, (u, b), ((S, S), (S, S)))
    if 2 * Sc < S:
        raise ValueError(f"{entry}: the coarse grid must cover S/2")
    lib = _build.lib()
    _check(entry, sweeps, lib)
    u_out = torch.empty_like(u)
    uc0 = torch.empty((Sc, Sc), dtype=u.dtype, device=u.device)
    bc = torch.empty_like(uc0)
    with torch.cuda.device(u.device):
        err = lib.tmt_fas_smooth_restrict(
            u.data_ptr(), b.data_ptr(), u_out.data_ptr(), uc0.data_ptr(),
            bc.data_ptr(), S, Sc, n, sweeps, kind, scalar, omega, h2, diag,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, entry)
    LAUNCHES[entry] += 1
    return u_out, uc0, bc


def _k2f_cuda(entry, u, b, ec, n, sweeps, kind, scalar, omega, h2, diag,
              resnorm):
    S, Sc = u.shape[-1], ec.shape[-1]
    _build.check_inputs(entry, (u, b, ec), ((S, S), (S, S), (Sc, Sc)))
    lib = _build.lib()
    _check(entry, sweeps, lib)
    u_out = torch.empty_like(u)
    partials = out_sum = None
    if resnorm:
        tiles = -(-S // lib.transfer_tile)
        partials = torch.empty(tiles * tiles, dtype=torch.float32,
                               device=u.device)
        out_sum = torch.empty((), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        err = lib.tmt_fas_prolong_smooth(
            u.data_ptr(), b.data_ptr(), ec.data_ptr(), u_out.data_ptr(),
            None if partials is None else partials.data_ptr(),
            None if out_sum is None else out_sum.data_ptr(),
            S, Sc, n, sweeps, kind, scalar, omega, h2, diag,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, entry)
    LAUNCHES[entry] += 1
    return (u_out, torch.sqrt(out_sum)) if resnorm else u_out


def fas_smooth_restrict(u, b, n: int, Sc: int, sweeps: int, omega: float,
                        phi, dphi, h2: float, diag: float = 4.0):
    """FAS K1f (pointwise family): ``sweeps`` Jacobi–Newton sweeps, then
    (u', inject(u'), A_c inj + h_c² φ(inj) + FW(b - N(u')))."""
    if u.device.type == "cpu":
        return fas_smooth_restrict_plain(u, b, n, Sc, sweeps, omega, phi,
                                         dphi, h2, diag)
    kind, scalar = selector("fas_smooth_restrict", phi, dphi)
    return _k1f_cuda("fas_smooth_restrict", u, b, n, Sc, sweeps, kind, scalar,
                     omega, h2, diag)


def fas_prolong_smooth(u, b, ec, n: int, sweeps: int, omega: float, phi,
                       dphi, h2: float, diag: float = 4.0):
    """FAS K2f (pointwise family): u <- JN-smooth(mask(u + P ec), b)."""
    if u.device.type == "cpu":
        return fas_prolong_smooth_plain(u, b, ec, n, sweeps, omega, phi, dphi,
                                        h2, diag)
    kind, scalar = selector("fas_prolong_smooth", phi, dphi)
    return _k2f_cuda("fas_prolong_smooth", u, b, ec, n, sweeps, kind, scalar,
                     omega, h2, diag, False)


def fas_prolong_smooth_resnorm(u, b, ec, n: int, sweeps: int, omega: float,
                               phi, dphi, h2: float, diag: float = 4.0):
    """K2f and ``||b - N(u')||_2`` as a 0-d float32 tensor, summed in a
    fixed order."""
    if u.device.type == "cpu":
        return fas_prolong_smooth_resnorm_plain(u, b, ec, n, sweeps, omega,
                                                phi, dphi, h2, diag)
    kind, scalar = selector("fas_prolong_smooth_resnorm", phi, dphi)
    return _k2f_cuda("fas_prolong_smooth_resnorm", u, b, ec, n, sweeps, kind,
                     scalar, omega, h2, diag, True)


def qfas_smooth_restrict(u, b, n: int, Sc: int, sweeps: int, omega: float,
                         a):
    """Quasilinear FAS K1f: ``sweeps`` Picard–Jacobi sweeps (edge
    coefficients recomputed per sweep), then (u', inject(u'),
    N_c(inj) + FW(b - N(u')))."""
    if u.device.type == "cpu":
        return qfas_smooth_restrict_plain(u, b, n, Sc, sweeps, omega, a)
    kind, scalar = selector("qfas_smooth_restrict", a)
    return _k1f_cuda("qfas_smooth_restrict", u, b, n, Sc, sweeps, kind,
                     scalar, omega, 0.0, 0.0)


def qfas_prolong_smooth(u, b, ec, n: int, sweeps: int, omega: float, a):
    """Quasilinear FAS K2f: u <- Picard-smooth(mask(u + P ec), b)."""
    if u.device.type == "cpu":
        return qfas_prolong_smooth_plain(u, b, ec, n, sweeps, omega, a)
    kind, scalar = selector("qfas_prolong_smooth", a)
    return _k2f_cuda("qfas_prolong_smooth", u, b, ec, n, sweeps, kind, scalar,
                     omega, 0.0, 0.0, False)


def qfas_prolong_smooth_resnorm(u, b, ec, n: int, sweeps: int, omega: float,
                                a):
    """Quasilinear K2f and the nonlinear residual norm."""
    if u.device.type == "cpu":
        return qfas_prolong_smooth_resnorm_plain(u, b, ec, n, sweeps, omega,
                                                 a)
    kind, scalar = selector("qfas_prolong_smooth_resnorm", a)
    return _k2f_cuda("qfas_prolong_smooth_resnorm", u, b, ec, n, sweeps,
                     kind, scalar, omega, 0.0, 0.0, True)
