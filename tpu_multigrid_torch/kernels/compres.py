"""Compensated residuals of double-/triple-single iterates in one launch.

``ds_residual``: r = b - A(u_hi + u_lo) to ~eps^2; ``ts_residual``:
r = b - A(u_hi + u_mid + u_lo) to ~eps^3 (``csrc/compres.cu``).  They
replace the Pallas TPU kernel ``tpu_multigrid/kernels/compres.py::
_comp_residual``.  Their plain torch versions are
``tpu_multigrid_torch.precision.ds_residual`` / ``ts_residual``, which run on
CPU tensors; on CUDA tensors the kernel launches, and agrees with the plain
version bitwise (TwoSum is exact IEEE arithmetic).  ``LAUNCHES`` counts
kernel launches per entry.
"""

from __future__ import annotations

import torch

from . import _build

LAUNCHES = {"ds_residual": 0, "ts_residual": 0}


def supported(S: int, dtype) -> bool:
    """The grids ``tpu_multigrid.kernels.compres.supported`` accepts."""
    return dtype == torch.float32 and S >= 256 and S % 128 == 0


def _launch(entry, arrays, n):
    S = arrays[0].shape[-1]
    _build.check_inputs(entry, arrays, [(S, S)] * len(arrays))
    r = torch.empty_like(arrays[0])
    fn = getattr(_build.lib(), f"tmt_{entry}")
    with torch.cuda.device(r.device):
        err = fn(*(a.data_ptr() for a in arrays), r.data_ptr(), S, n,
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, entry)
    LAUNCHES[entry] += 1
    return r


def ds_residual(b, u_hi, u_lo, n: int):
    """r = b - A(u_hi + u_lo), masked to the interior."""
    if b.device.type == "cpu":
        from .. import precision
        return precision.ds_residual(b, u_hi, u_lo, n)
    return _launch("ds_residual", (b, u_hi, u_lo), n)


def ts_residual(b, u_hi, u_mid, u_lo, n: int):
    """r = b - A(u_hi + u_mid + u_lo), masked to the interior."""
    if b.device.type == "cpu":
        from .. import precision
        return precision.ts_residual(b, u_hi, u_mid, u_lo, n)
    return _launch("ts_residual", (b, u_hi, u_mid, u_lo), n)
