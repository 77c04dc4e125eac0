"""The two kernels of a multigrid level visit, K1 and K2.

* K1, :func:`smooth_restrict`: pre-smoothing sweeps, the residual and its
  full-weighting restriction, in one launch (``csrc/transfer.cu``).
* K2, :func:`prolong_smooth` / :func:`prolong_smooth_resnorm`: bilinear
  prolongation of the coarse correction, the correction add and the
  post-smoothing sweeps, optionally with ``||b - A u'||_2``.

They replace the Pallas TPU kernels ``tpu_multigrid/kernels/transfer.py::
_smooth_restrict`` and ``::_prolong_smooth``.  Each entry runs its plain
torch version (``*_plain``, the composition of ``core.ops``) on CPU tensors
and launches its CUDA kernel on CUDA tensors; on a CUDA tensor it never
falls back.  ``LAUNCHES`` counts kernel launches per entry.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import ops
from ..core.operators import ConstStencilOp
from . import _build

LAUNCHES = {"smooth_restrict": 0, "prolong_smooth": 0,
            "prolong_smooth_resnorm": 0}


def supported(Sf: int, Sc: int, steps: int, dtype) -> bool:
    """Whether a (Sf, Sc) level pair with ``steps`` smoothing steps goes to
    the kernels: the same levels as ``tpu_multigrid.kernels.transfer.
    supported`` accepts, so both packages dispatch alike.  (That gate
    bounds ``steps`` by the TPU kernel's 16-row halo once the grid is
    row-tiled; the kernels here take any ``steps`` whose window fits in
    shared memory.)"""
    if dtype not in (torch.float32, torch.bfloat16):
        return False
    if Sf % 256 or Sc % 128:
        return False
    row_halo = 32 if dtype == torch.bfloat16 else 16
    if Sf >= 256 + 2 * row_halo and steps + 2 > row_halo:
        return False
    if 2 * Sc < Sf:
        return False
    return Sf >= 256


def _smooth_plain(u, b, n, sweeps, smoother, omega):
    return ConstStencilOp(n, u.shape[-1]).smooth(
        u, b, smoother=smoother, omega=omega, sweeps=sweeps)


def smooth_restrict_plain(u, b, n: int, Sc: int, sweeps: int,
                          smoother: str = "jacobi", omega=2.0 / 3.0):
    """K1's plain version: sweeps -> residual -> FW restriction.  The coarse
    interior mask zeroes the tail past S/2 as the kernel does."""
    v = _smooth_plain(u, b, n, sweeps, smoother, omega)
    return v, ops.restrict_fw(ops.residual(v, b, n), n, Sc)


def _corrected(u, ec, n):
    return ops.mask_interior(u + ops.prolong(ec, n // 2, u.shape[-1]), n)


def prolong_smooth_plain(u, b, ec, n: int, sweeps: int,
                         smoother: str = "jacobi", omega=2.0 / 3.0):
    """K2's plain version: mask(u + P ec) -> sweeps."""
    return _smooth_plain(_corrected(u, ec, n), b, n, sweeps, smoother, omega)


def prolong_smooth_resnorm_plain(u, b, ec, n: int, sweeps: int,
                                 smoother: str = "jacobi", omega=2.0 / 3.0):
    """K2-resnorm's plain version: (u', ||b - A u'||_2 as 0-d float32)."""
    v = prolong_smooth_plain(u, b, ec, n, sweeps, smoother, omega)
    return v, ops.norm2(ops.residual(v, b, n))


def _check_options(entry, u, smoother, smooth_dtype, stencil):
    """The options of the TPU kernels that are not ported yet raise, on
    either device."""
    if u.dtype != torch.float32:
        raise NotImplementedError(f"{entry}: float32 only, got {u.dtype}")
    if smooth_dtype is not None:
        raise NotImplementedError(f"{entry}: the delta form (smooth_dtype) "
                                  "is not ported yet")
    if stencil is not None:
        raise NotImplementedError(f"{entry}: static 9-point stencils are "
                                  "not ported yet")
    if smoother not in ("jacobi", "rbgs"):
        raise ValueError(f"unknown smoother {smoother!r}")


@functools.lru_cache(maxsize=None)
def _weights(ws: tuple):
    """Host weight array [c1..., c2...] for per-step weights ``ws``, rounded
    to float32 as torch rounds a Python scalar in the plain version.  Cached:
    the C entries only read it."""
    return np.array([1.0 - w for w in ws] + [0.25 * w for w in ws],
                    np.float32)


def _launch_args(entry, lib, smoother, omega, sweeps):
    """(steps, rbgs flag, host weight array) for a C entry."""
    steps = 2 * sweeps if smoother == "rbgs" else sweeps
    ws = omega if isinstance(omega, tuple) else (omega,)
    if len(ws) > 16:
        raise ValueError(f"{entry}: at most 16 per-step weights")
    if steps > lib.transfer_max_steps:
        raise ValueError(f"{entry}: {steps} steps do not fit in shared "
                         "memory")
    return steps, int(smoother == "rbgs"), _weights(ws)


def smooth_restrict(u, b, n: int, Sc: int, sweeps: int,
                    smoother: str = "jacobi", omega=2.0 / 3.0,
                    smooth_dtype=None, stencil=None):
    """K1: (u after ``sweeps`` sweeps, restricted residual (Sc, Sc))."""
    _check_options("smooth_restrict", u, smoother, smooth_dtype, stencil)
    if u.device.type == "cpu":
        return smooth_restrict_plain(u, b, n, Sc, sweeps, smoother, omega)
    S = u.shape[-1]
    _build.check_inputs("smooth_restrict", (u, b), ((S, S), (S, S)))
    if 2 * Sc < S:
        raise ValueError("smooth_restrict: the coarse grid must cover S/2")
    lib = _build.lib()
    steps, rbgs, weights = _launch_args("smooth_restrict", lib, smoother,
                                        omega, sweeps)
    u_out = torch.empty_like(u)
    rc = torch.empty((Sc, Sc), dtype=u.dtype, device=u.device)
    with torch.cuda.device(u.device):
        err = lib.tmt_smooth_restrict(
            u.data_ptr(), b.data_ptr(), u_out.data_ptr(), rc.data_ptr(),
            S, Sc, n, steps, rbgs, weights.ctypes.data, weights.size // 2,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "smooth_restrict")
    LAUNCHES["smooth_restrict"] += 1
    return u_out, rc


def _prolong_smooth_cuda(entry, u, b, ec, n, sweeps, smoother, omega,
                         resnorm):
    S, Sc = u.shape[-1], ec.shape[-1]
    _build.check_inputs(entry, (u, b, ec), ((S, S), (S, S), (Sc, Sc)))
    lib = _build.lib()
    steps, rbgs, weights = _launch_args(entry, lib, smoother, omega, sweeps)
    u_out = torch.empty_like(u)
    partials = out_sum = None
    if resnorm:
        tiles = -(-S // lib.transfer_tile)
        partials = torch.empty(tiles * tiles, dtype=torch.float32,
                               device=u.device)
        out_sum = torch.empty((), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        err = lib.tmt_prolong_smooth(
            u.data_ptr(), b.data_ptr(), ec.data_ptr(), u_out.data_ptr(),
            None if partials is None else partials.data_ptr(),
            None if out_sum is None else out_sum.data_ptr(),
            S, Sc, n, steps, rbgs, weights.ctypes.data, weights.size // 2,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, entry)
    LAUNCHES[entry] += 1
    return u_out, out_sum


def prolong_smooth(u, b, ec, n: int, sweeps: int, smoother: str = "jacobi",
                   omega=2.0 / 3.0, smooth_dtype=None, stencil=None):
    """K2: u <- smooth(mask(u + P ec), b) with ``sweeps`` sweeps."""
    _check_options("prolong_smooth", u, smoother, smooth_dtype, stencil)
    if u.device.type == "cpu":
        return prolong_smooth_plain(u, b, ec, n, sweeps, smoother, omega)
    return _prolong_smooth_cuda("prolong_smooth", u, b, ec, n, sweeps,
                                smoother, omega, resnorm=False)[0]


def prolong_smooth_resnorm(u, b, ec, n: int, sweeps: int,
                           smoother: str = "jacobi", omega=2.0 / 3.0,
                           smooth_dtype=None, stencil=None):
    """Like :func:`prolong_smooth`, and also ``||b - A u'||_2`` as a 0-d
    float32 tensor, summed in a fixed order."""
    _check_options("prolong_smooth_resnorm", u, smoother, smooth_dtype,
                   stencil)
    if u.device.type == "cpu":
        return prolong_smooth_resnorm_plain(u, b, ec, n, sweeps, smoother,
                                            omega)
    u_out, ss = _prolong_smooth_cuda("prolong_smooth_resnorm", u, b, ec, n,
                                     sweeps, smoother, omega, resnorm=True)
    return u_out, torch.sqrt(ss)
