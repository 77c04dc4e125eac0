"""The two kernels of a 3D multigrid level visit, K1_3 and K2_3.

* K1_3, :func:`smooth_restrict3`: pre-smoothing sweeps, the residual and
  its full-weighting restriction R = P^T / 2, in one launch
  (``csrc/transfer3d.cu``).
* K2_3, :func:`prolong_smooth3` / :func:`prolong_smooth_resnorm3`:
  trilinear prolongation of the coarse correction, the correction add and
  the post-smoothing sweeps, optionally with ``||b - A u'||_2``.

Both take the 7-point Poisson stencil or, through ``stencil=``, static
3x3x3 weights (the 19-point Mehrstellen ``Const19Op.STENCIL27``).  They
replace the Pallas TPU kernels ``tpu_multigrid/kernels/transfer3d.py::
_smooth_restrict3`` and ``::_prolong_smooth3``.  Each entry runs its plain
torch version (``*_plain``, in the Pallas kernels' order: the restriction
blurs x, then y, then z; the prolongation averages x, then y, then z) on
CPU tensors and launches its CUDA kernel on CUDA tensors; on a CUDA tensor
it never falls back.  A depth whose halo does not fit in the 3D window is
split into launches (:func:`split_plan`): K1_3 runs its leading steps as
smoothing passes alone and its last ones fused with the residual and the
restriction, K2_3 its prolongation with the first steps and the rest as
smoothing passes, the resnorm fused into the last.  ``LAUNCHES`` counts
kernel launches per entry, each launch of a split call included.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import ops, ops3d
from . import _build
from .stencil3d import (residual3_plain, rbgs_weights3, smooth3_plain,
                        stencil_taps, step_weights3)

LAUNCHES = {"smooth_restrict3": 0, "prolong_smooth3": 0,
            "prolong_smooth_resnorm3": 0}


def supported3(shape, shape_c, steps: int, dtype) -> bool:
    """Whether a fine/coarse level pair with ``steps`` smoothing steps (the
    larger of the two visits') goes to K1_3/K2_3: the shape and depth rules
    of ``tpu_multigrid.kernels.transfer3d.supported3``, so both packages
    fuse the same level pairs.  (That gate also asks the TPU kernels' VMEM
    tiling to exist, which binds only past level 10, beyond what one card
    holds.)"""
    Sz, Sy, Sx = ops3d._shape3(shape)
    Szc, Syc, Scx = ops3d._shape3(shape_c)
    if dtype != torch.float32:
        return False
    if Sx % 128 or Scx % 128 or Sx < 256:
        return False
    if Sy % 16 or Syc % 8 or Sz % 2:
        return False
    if steps + 2 > 16:
        return False
    return 2 * Szc >= Sz and 2 * Syc >= Sy and 2 * Scx >= Sx


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def restrict3_plain(r, n: int, shape_c):
    """R = P^T / 2 in the Pallas order: at the even nodes, blur x, then y,
    then z ([1/2, 1, 1/2] each), halve, and mask to the coarse interior of
    ``shape_c`` (zero past S/2).  Even extents only."""
    t = r
    for ax in (-1, -2, -3):
        even = t[(Ellipsis, slice(0, None, 2)) + (slice(None),) * (-1 - ax)]
        odd = t[(Ellipsis, slice(1, None, 2)) + (slice(None),) * (-1 - ax)]
        t = even + 0.5 * (torch.roll(odd, 1, ax) + odd)
    return ops3d.mask_interior3(ops3d._crop_pad3(0.5 * t,
                                                 ops3d._shape3(shape_c)),
                                n // 2)


def prolong3_plain(ec, shape):
    """Trilinear prolongation onto ``shape`` in the Pallas order: replicate
    each coarse node twice along an axis, then average each node with the
    next, along x, then y, then z (an even node averages a value with
    itself: exactly that value).  Coarse nodes past the fine reach are
    dropped; unmasked."""
    shf = ops3d._shape3(shape)
    m = tuple(min(ec.shape[ax], (shf[ax] + 1) // 2) for ax in range(3))
    e = ec[:m[0], :m[1], :m[2]]
    for ax in (-1, -2, -3):
        e = e.repeat_interleave(2, dim=ax)
        e = 0.5 * (e + torch.roll(e, -1, ax))
    return ops3d._crop_pad3(e, shf)


def smooth_restrict3_plain(u, b, n: int, shape_c, sweeps: int,
                           smoother: str = "jacobi", omega=2.0 / 3.0,
                           stencil=None):
    """K1_3's plain version: sweeps -> residual -> restriction."""
    steps = 2 * sweeps if smoother == "rbgs" else sweeps
    v = smooth3_plain(u, b, n, steps, smoother, omega, stencil)
    return v, restrict3_plain(residual3_plain(v, b, n, stencil), n, shape_c)


def prolong_smooth3_plain(u, b, ec, n: int, sweeps: int,
                          smoother: str = "jacobi", omega=2.0 / 3.0,
                          stencil=None):
    """K2_3's plain version: mask(u + P ec) -> sweeps."""
    steps = 2 * sweeps if smoother == "rbgs" else sweeps
    state = ops3d.mask_interior3(u + prolong3_plain(ec, u.shape), n)
    return smooth3_plain(state, b, n, steps, smoother, omega, stencil)


def prolong_smooth_resnorm3_plain(u, b, ec, n: int, sweeps: int,
                                  smoother: str = "jacobi", omega=2.0 / 3.0,
                                  stencil=None):
    """K2_3-resnorm's plain version: (u', ||b - A u'||_2 as 0-d float32)."""
    v = prolong_smooth3_plain(u, b, ec, n, sweeps, smoother, omega, stencil)
    return v, ops.norm2(residual3_plain(v, b, n, stencil))


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def taps_array(stencil=None) -> np.ndarray:
    """Host taps array of a C entry: [dz, dy, dx, w] per off-diagonal tap,
    in the Pallas order, then the centre weight; each weight rounded to
    float32 from its float64 value.  Empty (0 taps) for the 7-point
    stencil."""
    if stencil is None:
        return np.zeros(1, np.float32)
    taps = stencil_taps(stencil)
    if not taps:
        raise ValueError("a static stencil needs an off-diagonal weight")
    flat = [x for tap in taps for x in tap] + [stencil[1][1][1]]
    return np.array(flat, np.float32)


def _check_options(entry, u, smoother) -> None:
    if u.dtype != torch.float32:
        raise NotImplementedError(f"{entry}: float32 only, got {u.dtype}")
    if smoother not in ("jacobi", "rbgs"):
        raise ValueError(f"unknown smoother {smoother!r}")


def split_plan(steps: int, extra: int, limit: int, ws: tuple) -> list:
    """The launches that run ``steps`` window steps when a launch's halo
    holds at most ``limit`` layers and the last launch needs ``extra`` more
    (K1: 2, for the residual and the blur; K2: 1 with the resnorm, else 0):
    (first step, steps, weights) each, the weights rotated to the launch's
    first step so that its local step s takes ws[(first + s) % len(ws)].
    One launch when steps + extra fits; else as few as fit, the halo spread
    evenly over them, the last taking the smallest share."""
    if steps < 0 or extra > limit:
        raise ValueError(f"no launch plan for {steps} steps + {extra}")
    total = steps + extra
    count = max(1, -(-total // limit))
    halos = [total // count + (1 if i < total % count else 0)
             for i in range(count)]
    plan, first = [], 0
    for i, h in enumerate(halos):
        k = h - extra if i == count - 1 else h
        plan.append((first, k, tuple(ws[(first + s) % len(ws)]
                                     for s in range(max(1, min(k, len(ws)))))))
        first += k
    return plan


def launch_args(entry, smoother, omega, sweeps, stencil):
    """(steps, rbgs flag, per-step weights, taps) for a C entry."""
    steps = 2 * sweeps if smoother == "rbgs" else sweeps
    ws = omega if isinstance(omega, tuple) else (omega,)
    if len(ws) > 16:
        raise ValueError(f"{entry}: at most 16 per-step weights")
    return steps, int(smoother == "rbgs"), ws, taps_array(stencil)


def _weights(rbgs, ws, stencil) -> np.ndarray:
    return rbgs_weights3(stencil) if rbgs else step_weights3(ws, stencil)


def _shape(entry, x) -> tuple:
    if x.dim() != 3:
        raise ValueError(f"{entry}: expected an (Sz, Sy, Sx) grid, got "
                         f"{tuple(x.shape)}")
    return tuple(x.shape)


def run_launches(entry, counts, u, plan, launch):
    """The launches of a split call, in order: launch i of ``plan`` reads
    the output of the one before (u for the first) into a fresh tensor;
    ``launch(i, src, out, first, k, ws, stream)`` issues it and returns its
    error code.  Each launch adds one to ``counts[entry]``.  Returns the
    last output."""
    src = u
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        for i, (first, k, ws) in enumerate(plan):
            out = torch.empty_like(u)
            _build.check(launch(i, src, out, first, k, ws, stream), entry)
            counts[entry] += 1
            src = out
    return src


def smooth_restrict3(u, b, n: int, shape_c, sweeps: int,
                     smoother: str = "jacobi", omega=2.0 / 3.0, stencil=None):
    """K1_3: (u after ``sweeps`` sweeps, restricted residual of shape
    ``shape_c``)."""
    _check_options("smooth_restrict3", u, smoother)
    if u.device.type == "cpu":
        return smooth_restrict3_plain(u, b, n, shape_c, sweeps, smoother,
                                      omega, stencil)
    shape = _shape("smooth_restrict3", u)
    shape_c = ops3d._shape3(shape_c)
    _build.check_inputs("smooth_restrict3", (u, b), (shape, shape))
    if any(2 * c < f for f, c in zip(shape, shape_c)):
        raise ValueError("smooth_restrict3: the coarse grid must cover S/2")
    lib = _build.lib()
    steps, rbgs, ws, taps = launch_args("smooth_restrict3", smoother, omega,
                                         sweeps, stencil)
    plan = split_plan(steps, 2, lib.window3_max_halo, ws)
    rc = torch.empty(shape_c, dtype=u.dtype, device=u.device)

    def launch(i, src, out, first, k, launch_ws, stream):
        wt = _weights(rbgs, launch_ws, stencil)
        rest = (*shape, *shape_c, n, k, first, rbgs, wt.ctypes.data,
                wt.size // 2, taps.ctypes.data, taps.size // 4, stream)
        if i < len(plan) - 1:      # a leading smoothing pass
            return lib.tmt_prolong_smooth3(src.data_ptr(), b.data_ptr(), None,
                                           out.data_ptr(), None, None, *rest)
        return lib.tmt_smooth_restrict3(src.data_ptr(), b.data_ptr(),
                                        out.data_ptr(), rc.data_ptr(), *rest)
    return run_launches("smooth_restrict3", LAUNCHES, u, plan, launch), rc


def _prolong_smooth3_cuda(entry, u, b, ec, n, sweeps, smoother, omega,
                          stencil, resnorm):
    shape, shape_c = _shape(entry, u), _shape(entry, ec)
    _build.check_inputs(entry, (u, b, ec), (shape, shape, shape_c))
    lib = _build.lib()
    steps, rbgs, ws, taps = launch_args(entry, smoother, omega, sweeps,
                                         stencil)
    plan = split_plan(steps, int(resnorm), lib.window3_max_halo, ws)
    partials = out_sum = None
    if resnorm:
        blocks = lib.tmt_prolong_smooth3_blocks(*shape, plan[-1][1])
        partials = torch.empty(blocks, dtype=torch.float32, device=u.device)
        out_sum = torch.empty((), dtype=torch.float32, device=u.device)

    def launch(i, src, out, first, k, launch_ws, stream):
        wt = _weights(rbgs, launch_ws, stencil)
        norm = resnorm and i == len(plan) - 1
        return lib.tmt_prolong_smooth3(
            src.data_ptr(), b.data_ptr(), ec.data_ptr() if i == 0 else None,
            out.data_ptr(), partials.data_ptr() if norm else None,
            out_sum.data_ptr() if norm else None, *shape, *shape_c, n, k,
            first, rbgs, wt.ctypes.data, wt.size // 2, taps.ctypes.data,
            taps.size // 4, stream)
    return run_launches(entry, LAUNCHES, u, plan, launch), out_sum


def prolong_smooth3(u, b, ec, n: int, sweeps: int, smoother: str = "jacobi",
                    omega=2.0 / 3.0, stencil=None):
    """K2_3: u <- smooth(mask(u + P ec), b) with ``sweeps`` sweeps."""
    _check_options("prolong_smooth3", u, smoother)
    if u.device.type == "cpu":
        return prolong_smooth3_plain(u, b, ec, n, sweeps, smoother, omega,
                                     stencil)
    return _prolong_smooth3_cuda("prolong_smooth3", u, b, ec, n, sweeps,
                                 smoother, omega, stencil, False)[0]


def prolong_smooth_resnorm3(u, b, ec, n: int, sweeps: int,
                            smoother: str = "jacobi", omega=2.0 / 3.0,
                            stencil=None):
    """Like :func:`prolong_smooth3`, and also ``||b - A u'||_2`` as a 0-d
    float32 tensor, summed in a fixed order."""
    _check_options("prolong_smooth_resnorm3", u, smoother)
    if u.device.type == "cpu":
        return prolong_smooth_resnorm3_plain(u, b, ec, n, sweeps, smoother,
                                             omega, stencil)
    u_out, ss = _prolong_smooth3_cuda("prolong_smooth_resnorm3", u, b, ec, n,
                                      sweeps, smoother, omega, stencil, True)
    return u_out, torch.sqrt(ss)
