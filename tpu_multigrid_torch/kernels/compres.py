"""Compensated residuals of double-/triple-single iterates in one launch.

``ds_residual``: r = b - A(u_hi + u_lo) to ~eps^2; ``ts_residual``:
r = b - A(u_hi + u_mid + u_lo) to ~eps^3 (``csrc/compres.cu``).  They
replace the Pallas TPU kernel ``tpu_multigrid/kernels/compres.py::
_comp_residual``.  ``ds_residual3`` / ``ts_residual3`` are the same
residuals of the 7-point operator on (Sz, Sy, Sx) grids, a column-marching
kernel that replaces no TPU kernel (the JAX package evaluates them in jnp).  Their
plain torch versions are ``tpu_multigrid_torch.precision.ds_residual`` /
``ts_residual``, which run on CPU tensors; on CUDA tensors the kernel
launches, and agrees with the plain version bitwise (TwoSum is exact IEEE
arithmetic).  ``LAUNCHES`` counts kernel launches per entry.
"""

from __future__ import annotations

import torch

from . import _build

LAUNCHES = {"ds_residual": 0, "ts_residual": 0, "ds_residual3": 0,
            "ts_residual3": 0, "ds_residual_var3": 0}


def supported(S: int, dtype) -> bool:
    """The grids ``tpu_multigrid.kernels.compres.supported`` accepts."""
    return dtype == torch.float32 and S >= 256 and S % 128 == 0


def supported3(shape, dtype) -> bool:
    """The 3D grids the 3D kernel takes: float32 (Sz, Sy, Sx), any sides."""
    return dtype == torch.float32 and len(shape) == 3


def supported_var3(op, dtype) -> bool:
    """The flux stencils the float64 var kernel takes: float32 grids and
    planes."""
    return dtype == op.tz.dtype == torch.float32


def _launch(entry, arrays, n, shape, sizes):
    """Check the arrays against ``shape``, launch ``tmt_<entry>`` on the
    grid ``sizes`` (S in 2D, Sz, Sy, Sx in 3D), count the launch.  An array
    given as None is passed as a null pointer."""
    given = [a for a in arrays if a is not None]
    _build.check_inputs(entry, given, [shape] * len(given))
    r = torch.empty_like(arrays[0])
    fn = getattr(_build.lib(), f"tmt_{entry}")
    with torch.cuda.device(r.device):
        err = fn(*(None if a is None else a.data_ptr() for a in arrays),
                 r.data_ptr(), *sizes, n,
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, entry)
    LAUNCHES[entry] += 1
    return r


def _launch2(entry, arrays, n):
    S = arrays[0].shape[-1]
    return _launch(entry, arrays, n, (S, S), (S,))


def _launch3(entry, arrays, n):
    shape = tuple(arrays[0].shape)
    if len(shape) != 3:
        raise ValueError(f"{entry}: expected an (Sz, Sy, Sx) grid, got "
                         f"{shape}")
    if not 1 <= n <= min(shape) - 1:
        raise ValueError(f"{entry}: n = {n} outside 1..{min(shape) - 1} for "
                         f"the grid {shape}")
    return _launch(entry, arrays, n, shape, shape)


def ds_residual(b, u_hi, u_lo, n: int):
    """r = b - A(u_hi + u_lo), masked to the interior."""
    if b.device.type == "cpu":
        from .. import precision
        return precision.ds_residual(b, u_hi, u_lo, n)
    return _launch2("ds_residual", (b, u_hi, u_lo), n)


def ts_residual(b, u_hi, u_mid, u_lo, n: int):
    """r = b - A(u_hi + u_mid + u_lo), masked to the interior."""
    if b.device.type == "cpu":
        from .. import precision
        return precision.ts_residual(b, u_hi, u_mid, u_lo, n)
    return _launch2("ts_residual", (b, u_hi, u_mid, u_lo), n)


def ds_residual3(b, u_hi, u_lo, n: int):
    """r = b - A(u_hi + u_lo) of the 7-point operator, masked to 1..n-1 on
    every axis, zero elsewhere."""
    if b.device.type == "cpu":
        from .. import precision
        return precision.ds_residual(b, u_hi, u_lo, n)
    return _launch3("ds_residual3", (b, u_hi, u_lo), n)


def ts_residual3(b, u_hi, u_mid, u_lo, n: int):
    """r = b - A(u_hi + u_mid + u_lo) of the 7-point operator, masked to
    1..n-1 on every axis, zero elsewhere."""
    if b.device.type == "cpu":
        from .. import precision
        return precision.ts_residual(b, u_hi, u_mid, u_lo, n)
    return _launch3("ts_residual3", (b, u_hi, u_mid, u_lo), n)


def ds_residual_var3(op, b, u_hi, u_lo):
    """r = b - A(u_hi + u_lo) of the flux stencil ``op`` (``VarStencilOp3D``)
    in float64, rounded once to float32, masked to 1..n-1 on every axis,
    zero elsewhere; its planes tz, ty, tx (and c2) are (Sz, Sy, Sx) like
    b."""
    if b.device.type == "cpu":
        from .. import precision
        return precision.ds_residual_var3_plain(op, b, u_hi, u_lo)
    return _launch3("ds_residual_var3",
                    (b, u_hi, u_lo, op.tz, op.ty, op.tx, op.c2), op.n)
