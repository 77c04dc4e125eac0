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
it never falls back.  K1_3 on the 7-point stencil runs on the z march of
``csrc/zmarch3.cuh`` (as K1v_3 does), on static weights on the 3D window;
K2_3 runs on the window.  A depth whose halo does not fit in a launch is
split into launches (:func:`k1_launches`, :func:`split_plan`): K1_3 runs
its leading steps as smoothing passes alone (K2_3 launches with no
correction) and its last ones fused with the residual and the restriction,
K2_3 its prolongation with the first steps and the rest as smoothing
passes, the resnorm fused into the last.  ``LAUNCHES`` counts kernel
launches per entry, each launch of a split call included.

The same two kernels run on a ghost-extended block of a decomposed grid
(the distributed tier, ``dist.pallas_cycle3``): K1_3-ext,
:func:`smooth_restrict_ext3`, and K2_3-local, :func:`prolong_smooth_ext3`
(with ``want_resnorm`` the owned cells' sum of squares), replacing the
Pallas kernels' origin / ghost variants ``::_smooth_restrict3`` with
``origin`` and ``::_prolong_smooth_local3``.  A block is an ``(Rz, Ry, Sx)``
array, an owned region inside ``GZ`` ghost planes and ``GY`` ghost rows a
side, whose cell (0, 0, 0) sits at global ``(oz, oy, 0)``: the interior mask
and the RB-GS colours come from the global coordinates, cells outside the
array read as zero, and the coarse block ``(Rz/2 + GZ, Ry/2 + GY, Scx)``
holds fine cell (z, y) (both even) at (z/2 + GZ/2, y/2 + GY/2), its
interior mask taken in global coarse coordinates and its frame zero.  Every
output is defined on the whole array, ghosts included; the Pallas kernels
define the owned regions only, which is all a caller reads after
refreshing the ghosts.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import ops, ops3d
from . import _build
from .stencil3d import (masks3, residual3_plain, rbgs_weights3, shifted3,
                        smooth3_plain, stencil_taps, step_weights3)

LAUNCHES = {"smooth_restrict3": 0, "prolong_smooth3": 0,
            "prolong_smooth_resnorm3": 0, "smooth_restrict_ext3": 0,
            "prolong_smooth_ext3": 0, "prolong_smooth_ext3_resnorm": 0}


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

def restrict3_plain(r, n: int, shape_c, origin=(0, 0)):
    """R = P^T / 2 in the Pallas order: at the even nodes, blur x, then y,
    then z ([1/2, 1, 1/2] each, cells outside reading 0), halve, and mask
    to the coarse interior of ``shape_c`` (zero past S/2), in the global
    coarse coordinates of an array at fine ``origin`` (even).  Even extents
    only."""
    t = r
    for ax in (-1, -2, -3):
        even = t[(Ellipsis, slice(0, None, 2)) + (slice(None),) * (-1 - ax)]
        odd = t[(Ellipsis, slice(1, None, 2)) + (slice(None),) * (-1 - ax)]
        t = even + 0.5 * (shifted3(odd, -1, ax) + odd)
    c = ops3d._crop_pad3(0.5 * t, ops3d._shape3(shape_c))
    origin_c = (int(origin[0]) // 2, int(origin[1]) // 2)
    return torch.where(masks3(c.shape, n // 2, r.device, origin_c)[0], c, 0.0)


def prolong3_plain(ec, shape):
    """Trilinear prolongation onto ``shape`` in the Pallas order: replicate
    each coarse node twice along an axis, then average each node with the
    next (0 past the last), along x, then y, then z (an even node averages
    a value with itself: exactly that value).  Coarse nodes past the fine
    reach are dropped; unmasked."""
    shf = ops3d._shape3(shape)
    m = tuple(min(ec.shape[ax], shf[ax] // 2 + 1) for ax in range(3))
    e = ec[:m[0], :m[1], :m[2]]
    for ax in (-1, -2, -3):
        e = e.repeat_interleave(2, dim=ax)
        e = 0.5 * (e + shifted3(e, 1, ax))
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


def k1_plan(steps: int, ws: tuple, k1_halo: int, k2_halo: int) -> list:
    """The launches of a z-march K1 call (K1_3 on the 7-point stencil,
    K1v_3) of ``steps`` steps: one when its halo (steps + 2) fits the z
    march's window (``k1_halo`` layers), else :func:`split_plan`'s under the
    smaller limit, since the leading launches are K2 passes on the 3D
    window (``k2_halo``)."""
    if steps + 2 <= k1_halo:
        return split_plan(steps, 2, k1_halo, ws)
    return split_plan(steps, 2, min(k1_halo, k2_halo), ws)


def k1_launches(lib, steps: int, ws: tuple, stencil=None) -> list:
    """A K1 call's launch plan under the library's limits: the last launch
    on the z march (K1_3 on the 7-point stencil, K1v_3: :func:`k1_plan`
    with ``zmarch3_max_halo``), or, for K1_3 on static weights, on the 3D
    window (``window3_max_halo``)."""
    if stencil is None:
        return k1_plan(steps, ws, lib.zmarch3_max_halo, lib.window3_max_halo)
    return split_plan(steps, 2, lib.window3_max_halo, ws)


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
    plan = k1_launches(lib, steps, ws, stencil)
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


# ---------------------------------------------------------------------------
# Ghost-extended blocks (the distributed tier)
# ---------------------------------------------------------------------------

def supported_local3(shape, shape_c, steps: int, dtype,
                     ghost=(16, 16)) -> bool:
    """Whether the extended-block kernels take an (Rz, Ry, Sx) block and its
    coarse block with ``steps`` window steps: the shape and depth rules of
    ``tpu_multigrid.kernels.transfer3d.supported_local3`` (an even Rz, Ry a
    multiple of 16, lane-aligned x, the coarse block of
    :func:`coarse_shape_ext3`, ghosts deep enough for steps + 2 layers),
    with an owned region inside the ghosts.  (That gate also asks the TPU
    kernel's VMEM tiling to exist: ``dist.pallas_cycle3`` keeps it as a
    layout rule, the kernels here take any block.)"""
    Rz, Ry, Sx = shape
    Rzc, Ryc, Scx = shape_c
    GZ, GY = ghost
    if dtype != torch.float32:
        return False
    if Sx % 128 or Scx % 128 or Sx < 128 or 2 * Scx < Sx:
        return False
    if GZ % 2 or GY % 16 or Rz % 2 or Ry % 16:
        return False
    if Rz <= 2 * GZ or Ry <= 2 * GY or steps + 2 > min(GZ, GY):
        return False
    return (Rzc, Ryc) == (Rz // 2 + GZ, Ry // 2 + GY)


def coarse_shape_ext3(shape, Scx: int, ghost=(16, 16)) -> tuple:
    """The coarse block of an (Rz, Ry, Sx) block."""
    return (shape[0] // 2 + ghost[0], shape[1] // 2 + ghost[1], Scx)


def restrict_ext3_plain(r, origin, n: int, Scx: int, ghost=(16, 16)):
    """R = P^T / 2 of a block's residual ``r`` into its whole coarse block
    (:func:`restrict3_plain` at the block's ``origin``, placed at (GZ/2,
    GY/2, 0)); the frame is zero."""
    GZ, GY = ghost
    Rz, Ry, _ = r.shape
    out = r.new_zeros(coarse_shape_ext3(r.shape, Scx, ghost))
    out[GZ // 2:GZ // 2 + Rz // 2, GY // 2:GY // 2 + Ry // 2] = \
        restrict3_plain(r, n, (Rz // 2, Ry // 2, Scx), origin)
    return out


def prolong_ext3_plain(ec, shape, ghost=(16, 16)):
    """Trilinear P of the coarse block ``ec`` on an (Rz, Ry, Sx) block
    (:func:`prolong3_plain` from coarse node (GZ/2, GY/2, 0)): fine cell
    (z, y, x) reads the coarse nodes from (z/2 + GZ/2, y/2 + GY/2, x/2);
    nodes past ec's extent read 0.  Unmasked."""
    return prolong3_plain(ec[ghost[0] // 2:, ghost[1] // 2:], shape)


def owned_sum_sq3(r, ghost=(16, 16)):
    """The sum of r^2 over a block's owned region, 0-d float32."""
    GZ, GY = ghost
    o = r[GZ:r.shape[0] - GZ, GY:r.shape[1] - GY]
    return torch.sum(o * o)


def smooth_restrict_ext3_plain(u, b, origin, n: int, shape_c, sweeps: int,
                               smoother: str = "jacobi", omega=2.0 / 3.0,
                               ghost=(16, 16)):
    """K1_3-ext's plain version: (u', the whole coarse block)."""
    steps = 2 * sweeps if smoother == "rbgs" else sweeps
    v = smooth3_plain(u, b, n, steps, smoother, omega, origin=origin)
    return v, restrict_ext3_plain(residual3_plain(v, b, n, origin=origin),
                                  origin, n, shape_c[2], ghost)


def prolong_smooth_ext3_plain(u, b, ec, origin, n: int, sweeps: int,
                              smoother: str = "jacobi", omega=2.0 / 3.0,
                              ghost=(16, 16), want_resnorm: bool = False):
    """K2_3-local's plain version: u' = smooth(where(live, u + P ec, 0)), and
    with ``want_resnorm`` also the owned live cells' sum of (b - A u')^2."""
    steps = 2 * sweeps if smoother == "rbgs" else sweeps
    live = masks3(u.shape, n, u.device, origin)[0]
    v = torch.where(live, u + prolong_ext3_plain(ec, u.shape, ghost), 0.0)
    v = smooth3_plain(v, b, n, steps, smoother, omega, origin=origin)
    if want_resnorm:
        return v, owned_sum_sq3(residual3_plain(v, b, n, origin=origin),
                                ghost)
    return v


def check_ext3(entry, u, shape_c, smoother, origin, steps, ghost) -> tuple:
    """Validate an extended-block call: float32, a known smoother, an even
    origin, a block and coarse block the gate takes.  Returns the block's
    shape."""
    _check_options(entry, u, smoother)
    shape = _shape(entry, u)
    if int(origin[0]) % 2 or int(origin[1]) % 2:
        raise ValueError(f"{entry}: the origin must be even, got "
                         f"{tuple(origin)}")
    if not supported_local3(shape, tuple(shape_c), steps, u.dtype, ghost):
        raise ValueError(f"{entry}: no extended-block kernel for the block "
                         f"{shape} / {tuple(shape_c)} with {steps} steps and "
                         f"ghosts {tuple(ghost)}")
    return shape


def ext_args(shape, Scx, n, origin, ghost) -> tuple:
    """The geometry arguments of an extended-block C entry."""
    return (*shape, Scx, n, int(origin[0]), int(origin[1]), *ghost)


def smooth_restrict_ext3(u, b, origin, n: int, shape_c, sweeps: int,
                         smoother: str = "jacobi", omega=2.0 / 3.0,
                         ghost=(16, 16)):
    """K1_3-ext: (u after ``sweeps`` sweeps, the coarse block ``shape_c``
    holding the restricted residual).  ``origin``: the block's global
    (oz, oy), even host ints."""
    entry = "smooth_restrict_ext3"
    shape_c = tuple(shape_c)
    steps = 2 * sweeps if smoother == "rbgs" else sweeps
    shape = check_ext3(entry, u, shape_c, smoother, origin, steps, ghost)
    if u.device.type == "cpu":
        return smooth_restrict_ext3_plain(u, b, origin, n, shape_c, sweeps,
                                          smoother, omega, ghost)
    _build.check_inputs(entry, (u, b), (shape, shape))
    lib = _build.lib()
    _, rbgs, ws, _ = launch_args(entry, smoother, omega, sweeps, None)
    plan = k1_launches(lib, steps, ws)
    rc = torch.empty(shape_c, dtype=u.dtype, device=u.device)
    geo = ext_args(shape, shape_c[2], n, origin, ghost)

    def launch(i, src, out, first, k, launch_ws, stream):
        wt = _weights(rbgs, launch_ws, None)
        rest = (*geo, k, first, rbgs, wt.ctypes.data, wt.size // 2, stream)
        if i < len(plan) - 1:      # a leading smoothing pass
            return lib.tmt_prolong_smooth_ext3(src.data_ptr(), b.data_ptr(),
                                               None, out.data_ptr(), None,
                                               None, *rest)
        return lib.tmt_smooth_restrict_ext3(src.data_ptr(), b.data_ptr(),
                                            out.data_ptr(), rc.data_ptr(),
                                            *rest)
    return run_launches(entry, LAUNCHES, u, plan, launch), rc


def prolong_smooth_ext3(u, b, ec, origin, n: int, sweeps: int,
                        smoother: str = "jacobi", omega=2.0 / 3.0,
                        ghost=(16, 16), want_resnorm: bool = False):
    """K2_3-local: u <- smooth(where(live, u + P ec, 0), b).  With
    ``want_resnorm`` also the sum of squares of b - A u' over the owned live
    cells as a 0-d float32 tensor, summed in a fixed order (the caller adds
    the ranks' sums, then takes the square root)."""
    entry = ("prolong_smooth_ext3_resnorm" if want_resnorm
             else "prolong_smooth_ext3")
    steps = 2 * sweeps if smoother == "rbgs" else sweeps
    shape = check_ext3(entry, u, ec.shape, smoother, origin, steps, ghost)
    if u.device.type == "cpu":
        return prolong_smooth_ext3_plain(u, b, ec, origin, n, sweeps,
                                         smoother, omega, ghost, want_resnorm)
    shape_c = tuple(ec.shape)
    _build.check_inputs(entry, (u, b, ec), (shape, shape, shape_c))
    lib = _build.lib()
    _, rbgs, ws, _ = launch_args(entry, smoother, omega, sweeps, None)
    plan = split_plan(steps, int(want_resnorm), lib.window3_max_halo, ws)
    partials = out_sum = None
    if want_resnorm:
        blocks = lib.tmt_prolong_smooth3_blocks(*shape, plan[-1][1])
        partials = torch.empty(blocks, dtype=torch.float32, device=u.device)
        out_sum = torch.empty((), dtype=torch.float32, device=u.device)
    geo = ext_args(shape, shape_c[2], n, origin, ghost)

    def launch(i, src, out, first, k, launch_ws, stream):
        wt = _weights(rbgs, launch_ws, None)
        norm = want_resnorm and i == len(plan) - 1
        return lib.tmt_prolong_smooth_ext3(
            src.data_ptr(), b.data_ptr(), ec.data_ptr() if i == 0 else None,
            out.data_ptr(), partials.data_ptr() if norm else None,
            out_sum.data_ptr() if norm else None, *geo, k, first, rbgs,
            wt.ctypes.data, wt.size // 2, stream)
    u_out = run_launches(entry, LAUNCHES, u, plan, launch)
    return (u_out, out_sum) if want_resnorm else u_out
