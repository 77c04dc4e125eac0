"""The 3D streaming smoother: k fused Jacobi / red-black Gauss-Seidel steps
of the 7-point Poisson stencil, optionally with the residual of the result.

Entries :func:`jacobi_sweeps3`, :func:`jacobi_sweeps_residual3`,
:func:`rbgs_sweeps3`, :func:`rbgs_sweeps_residual3` and :func:`residual3`
(``csrc/stencil3d.cu``) replace the Pallas TPU kernel ``tpu_multigrid/
kernels/stencil3d.py::_streamed3`` behind the entries of the same names.
Each runs its plain torch version (``*_plain``) on CPU tensors and launches
its CUDA kernel on CUDA tensors; on a CUDA tensor it never falls back.  One
launch runs at most ``stencil3d_max_steps`` steps: deeper smoothing is split
into several launches of the same kernel, each told the index of its first
step, with the residual fused into the last.  ``LAUNCHES`` counts kernel
launches per entry.

The plain versions evaluate the Pallas kernels' arithmetic in their order
(neighbour sums x, y, z; Jacobi ``(1-w) v + (w/6)(b + nbr)``), which the
CUDA kernels repeat bitwise; ``core.ops3d`` keeps the JAX package's jnp
order, so the kernel path and the plain operator path agree to f32
roundoff.  The step machinery here also serves the static 3x3x3 stencils of
``kernels.transfer3d``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import ops3d
from . import _build
from .stencil import launch_plan

LAUNCHES = {"jacobi_sweeps3": 0, "jacobi_sweeps_residual3": 0,
            "rbgs_sweeps3": 0, "rbgs_sweeps_residual3": 0, "residual3": 0}


def supported3(shape, dtype, steps: int = 1) -> bool:
    """Whether an (Sz, Sy, Sx) grid goes to the kernel: the shape rules of
    ``tpu_multigrid.kernels.stencil3d.supported3`` (f32, Sx a multiple of
    128, Sy a multiple of 8 and at least 16), so both packages send the same
    levels to their kernels.  Any depth ``steps`` goes: the kernel splits
    deep smoothing into launches."""
    _, Sy, Sx = ops3d._shape3(shape)
    if dtype != torch.float32:
        return False
    return not (Sx < 128 or Sx % 128 or Sy % 8 or Sy < 16)


# ---------------------------------------------------------------------------
# Plain versions, in the Pallas kernels' order
# ---------------------------------------------------------------------------

def nbr3(v: torch.Tensor) -> torch.Tensor:
    """The six face neighbours summed x-1, x+1, y-1, y+1, z-1, z+1."""
    return (((((torch.roll(v, 1, -1) + torch.roll(v, -1, -1))
               + torch.roll(v, 1, -2)) + torch.roll(v, -1, -2))
             + torch.roll(v, 1, -3)) + torch.roll(v, -1, -3))


def stencil_taps(stencil) -> tuple:
    """The off-diagonal taps (dz, dy, dx, w) of static 3x3x3 weights
    (``stencil[dz+1][dy+1][dx+1]`` multiplies ``u[i+dz, j+dy, k+dx]``), in
    the order the Pallas kernel sums them: (dz, dy, dx) lexicographic, zero
    weights and the centre skipped."""
    return tuple((dz, dy, dx, stencil[dz + 1][dy + 1][dx + 1])
                 for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                 if (dz, dy, dx) != (0, 0, 0)
                 and stencil[dz + 1][dy + 1][dx + 1] != 0.0)


def off27(v: torch.Tensor, taps) -> torch.Tensor:
    """sum of w * v[i+dz, j+dy, k+dx] over the taps, from the first term."""
    out = None
    for dz, dy, dx, w in taps:
        term = w * torch.roll(v, (-dz, -dy, -dx), (-3, -2, -1))
        out = term if out is None else out + term
    return out if out is not None else torch.zeros_like(v)


def _masks(v, n):
    shape = v.shape[-3:]
    return (ops3d.interior_mask3(shape, n, v.device),
            ops3d.parity3(shape, v.device))


def smooth3_plain(u, b, n: int, steps: int, smoother: str, omega,
                  stencil=None, first_step: int = 0):
    """``steps`` Jacobi steps (weight ``omega[j % len]`` or ``omega`` at
    step j) or RB-GS half-steps (half-step j updates parity
    (first_step + j) % 2), on the 7-point stencil or on static weights."""
    if steps <= 0:
        return u
    interior, parity = _masks(u, n)
    taps = None if stencil is None else stencil_taps(stencil)
    inv_d = None if stencil is None else 1.0 / stencil[1][1][1]
    v = u
    for j in range(steps):
        if smoother == "rbgs":
            if taps is None:
                upd = (1.0 / 6.0) * (b + nbr3(v))
            else:
                upd = inv_d * (b - off27(v, taps))
            color = interior & (parity == (first_step + j) % 2)
            v = torch.where(color, upd, v)
        else:
            w = omega[j % len(omega)] if isinstance(omega, tuple) else omega
            if taps is None:
                upd = (1.0 - w) * v + (w / 6.0) * (b + nbr3(v))
            else:
                upd = (1.0 - w) * v + (w * inv_d) * (b - off27(v, taps))
            v = torch.where(interior, upd, 0.0)
    return v


def residual3_plain(u, b, n: int, stencil=None):
    """b - A u in the Pallas order, masked to the interior."""
    if stencil is None:
        r = b - 6.0 * u + nbr3(u)
    else:
        r = b - stencil[1][1][1] * u - off27(u, stencil_taps(stencil))
    return ops3d.mask_interior3(r, n)


def jacobi_sweeps3_plain(u, b, n: int, omega, sweeps: int):
    return smooth3_plain(u, b, n, sweeps, "jacobi", omega)


def jacobi_sweeps_residual3_plain(u, b, n: int, omega, sweeps: int):
    v = smooth3_plain(u, b, n, sweeps, "jacobi", omega)
    return v, residual3_plain(v, b, n)


def rbgs_sweeps3_plain(u, b, n: int, sweeps: int):
    return smooth3_plain(u, b, n, 2 * sweeps, "rbgs", None)


def rbgs_sweeps_residual3_plain(u, b, n: int, sweeps: int):
    v = smooth3_plain(u, b, n, 2 * sweeps, "rbgs", None)
    return v, residual3_plain(v, b, n)


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def step_weights3(ws: tuple, stencil=None) -> np.ndarray:
    """Host weight array [c1..., c2...] of per-step Jacobi weights ``ws``:
    c1 = 1 - w, c2 = w / 6 (or w / diag for static weights), each rounded
    to float32 from its float64 value, as the Pallas kernel's Python floats
    are.  Cached: the C entries only read it."""
    if stencil is None:
        c2 = [w / 6.0 for w in ws]
    else:
        inv_d = 1.0 / stencil[1][1][1]
        c2 = [w * inv_d for w in ws]
    return np.array([1.0 - w for w in ws] + c2, np.float32)


@functools.lru_cache(maxsize=None)
def rbgs_weights3(stencil=None) -> np.ndarray:
    """Host weight array of an RB-GS launch: c2[0] = 1/6 (or 1/diag)."""
    coef = 1.0 / 6.0 if stencil is None else 1.0 / stencil[1][1][1]
    return np.array([0.0, coef], np.float32)


def _float32_only(entry: str, u) -> None:
    if u.dtype != torch.float32:
        raise NotImplementedError(f"{entry}: float32 only, got {u.dtype}")


def _launch(entry, u, b, n, steps, rbgs, ws, want_u, want_r):
    """``steps`` steps (and the residual of the result if ``want_r``) in as
    few launches as the per-launch limit allows: (u' or None, r or None)."""
    shape = tuple(u.shape)
    if len(shape) != 3:
        raise ValueError(f"{entry}: expected an (Sz, Sy, Sx) grid, got "
                         f"{shape}")
    _build.check_inputs(entry, (u, b), (shape, shape))
    lib = _build.lib()
    v = r = None
    src = u
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        for first, k, launch_ws in launch_plan(steps, lib.stencil3d_max_steps,
                                               ws):
            last = first + k == steps
            v = torch.empty_like(u) if (want_u or not last) else None
            r = torch.empty_like(u) if (want_r and last) else None
            wt = rbgs_weights3() if rbgs else step_weights3(launch_ws)
            err = lib.tmt_streamed3(
                src.data_ptr(), b.data_ptr(),
                None if v is None else v.data_ptr(),
                None if r is None else r.data_ptr(),
                *shape, n, k, first, rbgs, wt.ctypes.data, wt.size // 2,
                stream)
            _build.check(err, entry)
            LAUNCHES[entry] += 1
            src = v
    return v, r


def _omegas(omega) -> tuple:
    return omega if isinstance(omega, tuple) else (omega,)


def jacobi_sweeps3(u, b, n: int, omega, sweeps: int):
    """``sweeps`` weighted-Jacobi sweeps (``omega`` a float or a per-sweep
    tuple, cycled)."""
    _float32_only("jacobi_sweeps3", u)
    if sweeps <= 0:
        return u
    if u.device.type == "cpu":
        return jacobi_sweeps3_plain(u, b, n, omega, sweeps)
    return _launch("jacobi_sweeps3", u, b, n, sweeps, 0, _omegas(omega),
                   True, False)[0]


def jacobi_sweeps_residual3(u, b, n: int, omega, sweeps: int):
    """(u after ``sweeps`` Jacobi sweeps, its residual b - A u)."""
    _float32_only("jacobi_sweeps_residual3", u)
    if u.device.type == "cpu":
        return jacobi_sweeps_residual3_plain(u, b, n, omega, sweeps)
    return _launch("jacobi_sweeps_residual3", u, b, n, max(sweeps, 0), 0,
                   _omegas(omega), True, True)


def rbgs_sweeps3(u, b, n: int, sweeps: int):
    """``sweeps`` red-black Gauss-Seidel sweeps (2 * sweeps half-steps,
    (i+j+k) even first)."""
    _float32_only("rbgs_sweeps3", u)
    if sweeps <= 0:
        return u
    if u.device.type == "cpu":
        return rbgs_sweeps3_plain(u, b, n, sweeps)
    return _launch("rbgs_sweeps3", u, b, n, 2 * sweeps, 1, (1.0,), True,
                   False)[0]


def rbgs_sweeps_residual3(u, b, n: int, sweeps: int):
    """(u after ``sweeps`` RB-GS sweeps, its residual b - A u)."""
    _float32_only("rbgs_sweeps_residual3", u)
    if u.device.type == "cpu":
        return rbgs_sweeps_residual3_plain(u, b, n, sweeps)
    return _launch("rbgs_sweeps_residual3", u, b, n, 2 * max(sweeps, 0), 1,
                   (1.0,), True, True)


def residual3(u, b, n: int):
    """r = b - A u, masked to the interior."""
    _float32_only("residual3", u)
    if u.device.type == "cpu":
        return residual3_plain(u, b, n)
    return _launch("residual3", u, b, n, 0, 0, (1.0,), False, True)[1]
