"""The streaming smoother: k fused Jacobi / red-black Gauss-Seidel steps of
the 5-point Poisson stencil, optionally with the residual of the result.

Entries :func:`jacobi_sweeps`, :func:`jacobi_sweeps_residual`,
:func:`rbgs_sweeps`, :func:`rbgs_sweeps_residual` and :func:`residual`
(``csrc/stencil.cu``) replace the Pallas TPU kernel ``tpu_multigrid/
kernels/stencil.py::_streamed`` behind the entries of the same names.  Each
runs its plain torch version (``*_plain``, from ``core.ops``) on CPU tensors
and launches its CUDA kernel on CUDA tensors; on a CUDA tensor it never
falls back.  One launch runs at most ``stencil_max_steps`` steps: deeper
smoothing is split into several launches of the same kernel, each told the
index of its first step, with the residual fused into the last.
``LAUNCHES`` counts kernel launches per entry.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import ops
from . import _build

LAUNCHES = {"jacobi_sweeps": 0, "jacobi_sweeps_residual": 0,
            "rbgs_sweeps": 0, "rbgs_sweeps_residual": 0, "residual": 0}

# The TPU kernel's gate constants (tpu_multigrid/kernels/stencil.py): its
# column halo is fixed once a grid is column-tiled, and its row tile must
# outlast the row halo.
_TILE_C, _COL_HALO, _MIN_SIZE = 1024, 128, 256


def supported(S: int, dtype, steps: int = 1) -> bool:
    """Whether an (S, S) grid with ``steps`` window steps (sweeps, + 1 with
    a fused residual) goes to the kernel: the same grids and depths as
    ``tpu_multigrid.kernels.stencil.supported`` accepts, so both packages
    dispatch alike.  (The kernel here takes any depth, split into
    launches.)"""
    if dtype not in (torch.float32, torch.bfloat16):
        return False
    if not (S >= _MIN_SIZE and S % 128 == 0):
        return False
    q = 16 if dtype == torch.bfloat16 else 8
    hr = ((max(steps, 1) + q - 1) // q) * q
    if S - 2 * hr < q:
        return False
    return not (S >= _TILE_C + 2 * _COL_HALO and steps > _COL_HALO)


@functools.lru_cache(maxsize=None)
def step_weights(ws: tuple) -> np.ndarray:
    """Host weight array [c1..., c2...] for per-step Jacobi weights ``ws``,
    rounded to float32 as torch rounds a Python scalar in the plain version.
    Cached: the C entries only read it."""
    return np.array([1.0 - w for w in ws] + [0.25 * w for w in ws],
                    np.float32)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def jacobi_sweeps_plain(u, b, n: int, omega, sweeps: int):
    return ops.jacobi_sweeps(u, b, n, omega, sweeps)


def jacobi_sweeps_residual_plain(u, b, n: int, omega, sweeps: int):
    v = ops.jacobi_sweeps(u, b, n, omega, sweeps)
    return v, ops.residual(v, b, n)


def rbgs_sweeps_plain(u, b, n: int, sweeps: int):
    return ops.redblack_gs_sweeps(u, b, n, sweeps)


def rbgs_sweeps_residual_plain(u, b, n: int, sweeps: int):
    v = ops.redblack_gs_sweeps(u, b, n, sweeps)
    return v, ops.residual(v, b, n)


def residual_plain(u, b, n: int):
    return ops.residual(u, b, n)


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

def _float32_only(entry: str, u) -> None:
    if u.dtype != torch.float32:
        raise NotImplementedError(f"{entry}: float32 only, got {u.dtype}")


def launch_plan(steps: int, chunk: int, ws: tuple):
    """The launches that run ``steps`` steps at most ``chunk`` at a time:
    (first step, steps, weights) each, the weights rotated to the launch's
    first step so that its local step s takes ws[(first + s) % len(ws)].
    Zero steps (a residual alone) is one launch of none."""
    plan = []
    for first in range(0, max(steps, 1), chunk):
        k = min(chunk, steps - first)
        plan.append((first, k, tuple(ws[(first + s) % len(ws)]
                                     for s in range(max(1, min(k, len(ws)))))))
    return plan


def _launch(entry, u, b, n, steps, rbgs, ws, want_u, want_r):
    """``steps`` steps (and the residual of the result if ``want_r``) in as
    few launches as the per-launch limit allows: (u' or None, r or None)."""
    S = u.shape[-1]
    _build.check_inputs(entry, (u, b), ((S, S), (S, S)))
    lib = _build.lib()
    v = r = None
    src = u
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        for first, k, launch_ws in launch_plan(steps, lib.stencil_max_steps,
                                               ws):
            last = first + k == steps
            v = torch.empty_like(u) if (want_u or not last) else None
            r = torch.empty_like(u) if (want_r and last) else None
            wt = step_weights(launch_ws)
            err = lib.tmt_streamed(
                src.data_ptr(), b.data_ptr(),
                None if v is None else v.data_ptr(),
                None if r is None else r.data_ptr(),
                S, n, k, first, rbgs, wt.ctypes.data, wt.size // 2, stream)
            _build.check(err, entry)
            LAUNCHES[entry] += 1
            src = v
    return v, r


def _omegas(omega) -> tuple:
    return omega if isinstance(omega, tuple) else (omega,)


def jacobi_sweeps(u, b, n: int, omega, sweeps: int):
    """``sweeps`` weighted-Jacobi sweeps (``omega`` a float or a per-sweep
    tuple, cycled)."""
    _float32_only("jacobi_sweeps", u)
    if sweeps <= 0:
        return u
    if u.device.type == "cpu":
        return jacobi_sweeps_plain(u, b, n, omega, sweeps)
    return _launch("jacobi_sweeps", u, b, n, sweeps, 0, _omegas(omega),
                   True, False)[0]


def jacobi_sweeps_residual(u, b, n: int, omega, sweeps: int):
    """(u after ``sweeps`` Jacobi sweeps, its residual b - A u)."""
    _float32_only("jacobi_sweeps_residual", u)
    if u.device.type == "cpu":
        return jacobi_sweeps_residual_plain(u, b, n, omega, sweeps)
    return _launch("jacobi_sweeps_residual", u, b, n, max(sweeps, 0), 0,
                   _omegas(omega), True, True)


def rbgs_sweeps(u, b, n: int, sweeps: int):
    """``sweeps`` red-black Gauss-Seidel sweeps (2 * sweeps half-steps, red
    first)."""
    _float32_only("rbgs_sweeps", u)
    if sweeps <= 0:
        return u
    if u.device.type == "cpu":
        return rbgs_sweeps_plain(u, b, n, sweeps)
    return _launch("rbgs_sweeps", u, b, n, 2 * sweeps, 1, (1.0,), True,
                   False)[0]


def rbgs_sweeps_residual(u, b, n: int, sweeps: int):
    """(u after ``sweeps`` RB-GS sweeps, its residual b - A u)."""
    _float32_only("rbgs_sweeps_residual", u)
    if u.device.type == "cpu":
        return rbgs_sweeps_residual_plain(u, b, n, sweeps)
    return _launch("rbgs_sweeps_residual", u, b, n, 2 * max(sweeps, 0), 1,
                   (1.0,), True, True)


def residual(u, b, n: int):
    """r = b - A u, masked to the interior."""
    _float32_only("residual", u)
    if u.device.type == "cpu":
        return residual_plain(u, b, n)
    return _launch("residual", u, b, n, 0, 0, (1.0,), False, True)[1]
