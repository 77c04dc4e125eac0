"""The variable-coefficient streaming smoother: k Jacobi / red-black
Gauss-Seidel steps of a 9-point stencil with per-node coefficients,
optionally with the residual of the result.

Entries :func:`var_smooth` and :func:`var_smooth_residual`
(``csrc/varstencil.cu``) replace the Pallas TPU kernel ``tpu_multigrid/
kernels/varstencil.py::_var_streamed`` behind the entries of the same names.
Each runs its plain torch version (``*_plain``) on CPU tensors and launches
its CUDA kernel on CUDA tensors; on a CUDA tensor it never falls back.
``LAUNCHES`` counts kernel launches per entry.

The coefficients come as the kernels' planes (:func:`_flat_coef`): five,
[diag, E, S, SE, SW], for a symmetric operator, whose W/N/NW/NE the kernel
derives by one-cell shifts; nine, with the stored [W, N, NW, NE] appended,
for a nonsymmetric one.  The plain versions follow the TPU kernel's
arithmetic, not ``VarStencilOp``'s: 1/diag from the diagonal plane, the
off-diagonal sum from zero in the order E, W, S, N, SE, SW, NW, NE, Jacobi
``(1 - w) v + (w / d) (b - off)``, RB-GS half-steps ``(b - off) / d`` on
one colour, the residual ``(b - diag v) - off``.  So the kernel path and
``VarStencilOp``'s plain path differ at float32 roundoff.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import ops
from ..core.operators import _minus_planes, _shift, _sym_planes
from . import _build

LAUNCHES = {"var_smooth": 0, "var_smooth_residual": 0}

# The TPU kernel's tile and halo (tpu_multigrid/kernels/varstencil.py).
_TR, _TC, _HR, _HC = 128, 1024, 8, 128


def supported(S: int, steps: int, dtype) -> bool:
    """Whether an (S, S) grid with ``steps`` steps goes to the kernel: the
    same grids and depths as ``tpu_multigrid.kernels.varstencil.supported``
    accepts (at most 6 steps once the grid is row-tiled), so both packages
    dispatch alike."""
    if dtype != torch.float32:
        return False
    if S % 128:
        return False
    hr = _HR if S >= _TR + 2 * _HR else 0
    hc = _HC if S >= _TC + 2 * _HC else 0
    if hr and steps + 2 > hr:
        return False
    if hc and steps + 2 > hc:
        return False
    return S >= 256


def _flat_coef(op):
    """The operator's kernel planes: its set-up ``coef_sym`` when present,
    else stacked from ``coef`` (5 planes, or 9 for a nonsymmetric one)."""
    if op.coef_sym is not None:
        return op.coef_sym
    planes = _sym_planes(op.coef)
    if not op.is_symmetric:
        planes += _minus_planes(op.coef)
    return torch.stack(planes)


@functools.lru_cache(maxsize=None)
def var_weights(ws: tuple) -> np.ndarray:
    """Host weight array [1 - w..., w...] for per-step Jacobi weights
    ``ws``, rounded to float32 as torch rounds a Python scalar.  Cached: the
    C entries only read it."""
    return np.array([1.0 - w for w in ws] + list(ws), np.float32)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _expand(coef):
    """(diag, [(plane, di, dj)] for E, W, S, N, SE, SW, NW, NE): the stored
    planes, W/N/NW/NE derived by shifts for 5-plane storage."""
    if coef.shape[0] == 5:
        diag, E, S_, SE, SW = coef
        W, N, NW, NE = (_shift(E, 0, -1), _shift(S_, -1, 0),
                        _shift(SE, -1, -1), _shift(SW, -1, 1))
    else:
        diag, E, S_, SE, SW, W, N, NW, NE = coef
    return diag, [(E, 0, 1), (W, 0, -1), (S_, 1, 0), (N, -1, 0),
                  (SE, 1, 1), (SW, 1, -1), (NW, -1, -1), (NE, -1, 1)]


def _off(planes, v):
    acc = torch.zeros_like(v)
    for c, di, dj in planes:
        acc = acc + c * _shift(v, di, dj)
    return acc


def _invd(diag):
    nz = diag != 0.0
    return torch.where(nz, 1.0 / torch.where(nz, diag, 1.0), 0.0)


def _omegas(omega) -> tuple:
    return omega if isinstance(omega, tuple) else (omega,)


def var_steps_plain(u, b, coef, n: int, steps: int, rbgs: bool, omega):
    """``steps`` Jacobi steps (weights ``omega``, cycled) or RB-GS
    half-steps (colour j % 2, red first) in the kernel's arithmetic."""
    diag, planes = _expand(coef)
    invd = _invd(diag)
    m = ops.interior_mask(u.shape[-1], n, u.device)
    colors = ops._parity_masks(u.shape[-1], n, u.device)
    ws = _omegas(omega)
    v = u
    for j in range(steps):
        if rbgs:
            v = torch.where(colors[j % 2], invd * (b - _off(planes, v)), v)
        else:
            w = ws[j % len(ws)]
            v = torch.where(m, (1.0 - w) * v + w * invd * (b - _off(planes,
                                                                     v)),
                            0.0)
    return v


def var_residual_plain(v, b, coef, n: int):
    """(b - diag v) - off(v), masked to the interior."""
    diag, planes = _expand(coef)
    return ops.mask_interior((b - diag * v) - _off(planes, v), n)


def _steps(smoother: str, sweeps: int) -> int:
    return 2 * sweeps if smoother == "rbgs" else sweeps


def var_smooth_plain(u, b, coef, n: int, sweeps: int,
                     smoother: str = "jacobi", omega=2.0 / 3.0):
    if sweeps <= 0:
        return u
    return var_steps_plain(u, b, coef, n, _steps(smoother, sweeps),
                           smoother == "rbgs", omega)


def var_smooth_residual_plain(u, b, coef, n: int, sweeps: int,
                              smoother: str = "jacobi", omega=2.0 / 3.0):
    v = var_smooth_plain(u, b, coef, n, sweeps, smoother, omega)
    return v, var_residual_plain(v, b, coef, n)


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

def check_options(entry: str, u, coef, smoother: str, box) -> None:
    """What the var kernels do not take raises, on either device."""
    if u.dtype != torch.float32:
        raise NotImplementedError(f"{entry}: float32 only, got {u.dtype}")
    if box is not None:
        raise NotImplementedError(f"{entry}: box masks (mixed boundary "
                                  "conditions) are not ported yet")
    if smoother not in ("jacobi", "rbgs"):
        raise ValueError(f"unknown smoother {smoother!r}")
    if coef.dim() != 3 or coef.shape[0] not in (5, 9):
        raise ValueError(f"{entry}: coefficient planes must be (5|9, S, S), "
                         f"got {tuple(coef.shape)}")


def launch_args(entry: str, lib, coef, smoother: str, omega, sweeps: int,
                extra: int):
    """(steps, rbgs flag, nplanes, host weight array) of a C entry whose
    window needs ``extra`` rings beyond the steps."""
    steps = _steps(smoother, max(sweeps, 0))
    ws = _omegas(omega)
    if len(ws) > 16:
        raise ValueError(f"{entry}: at most 16 per-step weights")
    nplanes = coef.shape[0]
    if steps + extra > lib.var_max_halo[nplanes]:
        raise ValueError(f"{entry}: {steps} steps do not fit in shared "
                         "memory")
    return steps, int(smoother == "rbgs"), nplanes, var_weights(ws)


def _launch(entry, u, b, coef, n, sweeps, smoother, omega, want_r):
    S = u.shape[-1]
    _build.check_inputs(entry, (u, b, coef),
                        ((S, S), (S, S), (coef.shape[0], S, S)))
    lib = _build.lib()
    steps, rbgs, nplanes, wt = launch_args(entry, lib, coef, smoother, omega,
                                           sweeps, int(want_r))
    v = torch.empty_like(u)
    r = torch.empty_like(u) if want_r else None
    with torch.cuda.device(u.device):
        err = lib.tmt_var_streamed(
            u.data_ptr(), b.data_ptr(), coef.data_ptr(), v.data_ptr(),
            None if r is None else r.data_ptr(), S, n, steps, rbgs, nplanes,
            wt.ctypes.data, wt.size // 2,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, entry)
    LAUNCHES[entry] += 1
    return v, r


def var_smooth(u, b, coef, n: int, sweeps: int, smoother: str = "jacobi",
               omega=2.0 / 3.0, box=None):
    """``sweeps`` Jacobi sweeps (``omega`` a float or a per-sweep tuple) or
    RB-GS sweeps of the operator given by its kernel planes ``coef``."""
    check_options("var_smooth", u, coef, smoother, box)
    if sweeps <= 0:
        return u
    if u.device.type == "cpu":
        return var_smooth_plain(u, b, coef, n, sweeps, smoother, omega)
    return _launch("var_smooth", u, b, coef, n, sweeps, smoother, omega,
                   False)[0]


def var_smooth_residual(u, b, coef, n: int, sweeps: int,
                        smoother: str = "jacobi", omega=2.0 / 3.0, box=None):
    """(u after ``sweeps`` sweeps, its residual b - A u)."""
    check_options("var_smooth_residual", u, coef, smoother, box)
    if u.device.type == "cpu":
        return var_smooth_residual_plain(u, b, coef, n, sweeps, smoother,
                                         omega)
    return _launch("var_smooth_residual", u, b, coef, n, sweeps, smoother,
                   omega, True)
