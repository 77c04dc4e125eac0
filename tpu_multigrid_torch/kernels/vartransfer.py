"""The two kernels of a variable-coefficient multigrid level visit, K1v and
K2v.

* K1v, :func:`var_smooth_restrict_fused`: var-stencil smoothing steps, the
  residual and its full-weighting restriction, in one launch
  (``csrc/vartransfer.cu``).
* K2v, :func:`var_prolong_smooth_fused` / :func:`var_prolong_smooth_resnorm`:
  bilinear prolongation of the coarse correction, the correction add and the
  smoothing steps, optionally with ``||b - A u'||_2``.

They replace the Pallas TPU kernels ``tpu_multigrid/kernels/vartransfer.py::
_var_smooth_restrict`` and ``::_var_prolong_smooth``.  Each entry runs its
plain torch version (``*_plain``: ``kernels.varstencil``'s plain sweeps and
residual, the port's ``ops.restrict_fw`` and ``ops.prolong``) on CPU
tensors and launches its CUDA kernel on CUDA tensors; on a CUDA tensor it
never falls back.  ``LAUNCHES`` counts kernel launches per entry.
"""

from __future__ import annotations

import torch

from ..core import ops
from . import _build
from .varstencil import (check_options, launch_args, var_residual_plain,
                         var_smooth_plain)

LAUNCHES = {"var_smooth_restrict_fused": 0, "var_prolong_smooth_fused": 0,
            "var_prolong_smooth_resnorm": 0}

# The TPU kernels' row tile and halo (tpu_multigrid/kernels/transfer.py,
# float32).
_TR, _HR = 256, 16


def supported(Sf: int, Sc: int, steps: int, dtype) -> bool:
    """Whether a (Sf, Sc) level pair with ``steps`` smoothing steps goes to
    K1v/K2v: the same pairs as ``tpu_multigrid.kernels.vartransfer.
    supported`` accepts (at most 14 steps once the grid is row-tiled), so
    both packages dispatch alike."""
    if dtype != torch.float32:
        return False
    if Sf % 256 or Sc % 128:
        return False
    if Sf >= _TR + 2 * _HR and steps + 2 > _HR:
        return False
    if 2 * Sc < Sf:
        return False
    return Sf >= 256


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def var_smooth_restrict_plain(u, b, coef, n: int, Sc: int, sweeps: int,
                              smoother: str = "jacobi", omega=2.0 / 3.0):
    """K1v's plain version: sweeps -> residual -> FW restriction, zero
    outside the coarse interior (and so past S/2)."""
    v = var_smooth_plain(u, b, coef, n, sweeps, smoother, omega)
    return v, ops.restrict_fw(var_residual_plain(v, b, coef, n), n, Sc)


def var_prolong_smooth_plain(u, b, ec, coef, n: int, sweeps: int,
                             smoother: str = "jacobi", omega=2.0 / 3.0):
    """K2v's plain version: mask(u + P ec) -> sweeps."""
    v = ops.mask_interior(u + ops.prolong(ec, n // 2, u.shape[-1]), n)
    return var_smooth_plain(v, b, coef, n, sweeps, smoother, omega)


def var_prolong_smooth_resnorm_plain(u, b, ec, coef, n: int, sweeps: int,
                                     smoother: str = "jacobi",
                                     omega=2.0 / 3.0):
    """K2v-resnorm's plain version: (u', ||b - A u'||_2 as 0-d float32)."""
    v = var_prolong_smooth_plain(u, b, ec, coef, n, sweeps, smoother, omega)
    return v, ops.norm2(var_residual_plain(v, b, coef, n))


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

def var_smooth_restrict_fused(u, b, coef, n: int, Sc: int, sweeps: int,
                              smoother: str = "jacobi", omega=2.0 / 3.0,
                              box=None, cbox=None):
    """K1v: (u after ``sweeps`` sweeps, restricted residual (Sc, Sc))."""
    entry = "var_smooth_restrict_fused"
    check_options(entry, u, coef, smoother, box if box is not None else cbox)
    if u.device.type == "cpu":
        return var_smooth_restrict_plain(u, b, coef, n, Sc, sweeps, smoother,
                                         omega)
    S = u.shape[-1]
    _build.check_inputs(entry, (u, b, coef),
                        ((S, S), (S, S), (coef.shape[0], S, S)))
    if 2 * Sc < S:
        raise ValueError(f"{entry}: the coarse grid must cover S/2")
    lib = _build.lib()
    steps, rbgs, nplanes, wt = launch_args(entry, lib, coef, smoother, omega,
                                           sweeps, 2)
    u_out = torch.empty_like(u)
    rc = torch.empty((Sc, Sc), dtype=u.dtype, device=u.device)
    with torch.cuda.device(u.device):
        err = lib.tmt_var_smooth_restrict(
            u.data_ptr(), b.data_ptr(), coef.data_ptr(), u_out.data_ptr(),
            rc.data_ptr(), S, Sc, n, steps, rbgs, nplanes, wt.ctypes.data,
            wt.size // 2, torch.cuda.current_stream().cuda_stream)
    _build.check(err, entry)
    LAUNCHES[entry] += 1
    return u_out, rc


def _prolong_smooth_cuda(entry, u, b, ec, coef, n, sweeps, smoother, omega,
                         resnorm):
    S, Sc = u.shape[-1], ec.shape[-1]
    _build.check_inputs(entry, (u, b, ec, coef),
                        ((S, S), (S, S), (Sc, Sc), (coef.shape[0], S, S)))
    lib = _build.lib()
    steps, rbgs, nplanes, wt = launch_args(entry, lib, coef, smoother, omega,
                                           sweeps, 1)
    u_out = torch.empty_like(u)
    partials = out_sum = None
    if resnorm:
        tiles = -(-S // lib.var_tile)
        partials = torch.empty(tiles * tiles, dtype=torch.float32,
                               device=u.device)
        out_sum = torch.empty((), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        err = lib.tmt_var_prolong_smooth(
            u.data_ptr(), b.data_ptr(), ec.data_ptr(), coef.data_ptr(),
            u_out.data_ptr(),
            None if partials is None else partials.data_ptr(),
            None if out_sum is None else out_sum.data_ptr(),
            S, Sc, n, steps, rbgs, nplanes, wt.ctypes.data, wt.size // 2,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, entry)
    LAUNCHES[entry] += 1
    return u_out, out_sum


def var_prolong_smooth_fused(u, b, ec, coef, n: int, sweeps: int,
                             smoother: str = "jacobi", omega=2.0 / 3.0,
                             box=None):
    """K2v: u <- var-smooth(mask(u + P ec), b) with ``sweeps`` sweeps."""
    entry = "var_prolong_smooth_fused"
    check_options(entry, u, coef, smoother, box)
    if u.device.type == "cpu":
        return var_prolong_smooth_plain(u, b, ec, coef, n, sweeps, smoother,
                                        omega)
    return _prolong_smooth_cuda(entry, u, b, ec, coef, n, sweeps, smoother,
                                omega, resnorm=False)[0]


def var_prolong_smooth_resnorm(u, b, ec, coef, n: int, sweeps: int,
                               smoother: str = "jacobi", omega=2.0 / 3.0,
                               box=None):
    """Like :func:`var_prolong_smooth_fused`, and also ``||b - A u'||_2`` as
    a 0-d float32 tensor, summed in a fixed order."""
    entry = "var_prolong_smooth_resnorm"
    check_options(entry, u, coef, smoother, box)
    if u.device.type == "cpu":
        return var_prolong_smooth_resnorm_plain(u, b, ec, coef, n, sweeps,
                                                smoother, omega)
    u_out, ss = _prolong_smooth_cuda(entry, u, b, ec, coef, n, sweeps,
                                     smoother, omega, resnorm=True)
    return u_out, torch.sqrt(ss)
