"""The two kernels of a multigrid level visit, K1 and K2, and the three
standalone transfers.

* K1, :func:`smooth_restrict`: pre-smoothing sweeps, the residual and its
  full-weighting restriction, in one launch (``csrc/transfer.cu``).
* K2, :func:`prolong_smooth` / :func:`prolong_smooth_resnorm`: bilinear
  prolongation of the coarse correction, the correction add and the
  post-smoothing sweeps, optionally with ``||b - A u'||_2``.
* :func:`restrict_fw`, :func:`prolong_add` and :func:`prolong_comp`: the
  full-weighting restriction, ``mask(u + P ec)``, and the exact pair
  ``hi + err == P ec``, each one launch, for the double-single cycle
  (``precision.cycle_ds``) and FMG.

They replace the Pallas TPU kernels ``tpu_multigrid/kernels/transfer.py::
_smooth_restrict``, ``::_prolong_smooth``, ``::_restrict_only``,
``::_prolong_add_only`` and ``::_prolong_comp_only``.  Each entry runs its
plain torch version (``*_plain``, the composition of ``core.ops``) on CPU
tensors and launches its CUDA kernel on CUDA tensors; on a CUDA tensor it
never falls back.  ``LAUNCHES`` counts kernel launches per entry.
"""

from __future__ import annotations

import torch

from ..core import ops
from ..core.operators import ConstStencilOp
from . import _build
from .stencil import step_weights

LAUNCHES = {"smooth_restrict": 0, "prolong_smooth": 0,
            "prolong_smooth_resnorm": 0, "restrict_fw": 0, "prolong_add": 0,
            "prolong_comp": 0}


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


def _launch_args(entry, lib, smoother, omega, sweeps):
    """(steps, rbgs flag, host weight array) for a C entry."""
    steps = 2 * sweeps if smoother == "rbgs" else sweeps
    ws = omega if isinstance(omega, tuple) else (omega,)
    if len(ws) > 16:
        raise ValueError(f"{entry}: at most 16 per-step weights")
    if steps > lib.transfer_max_steps:
        raise ValueError(f"{entry}: {steps} steps do not fit in shared "
                         "memory")
    return steps, int(smoother == "rbgs"), step_weights(ws)


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


# ---------------------------------------------------------------------------
# Standalone transfers
# ---------------------------------------------------------------------------

def restrict_fw_plain(r, n: int, Sc: int):
    return ops.restrict_fw(r, n, Sc)


def prolong_add_plain(u, ec, n: int):
    return _corrected(u, ec, n)


def _interleave(ee, oe, eo, oo, Sf: int):
    """Four (m, m) phase arrays -> the (Sf, Sf) fine grid with
    out[2i + a, 2j + b] = phase[a][b], cropped or zero-padded."""
    m = ee.shape[-1]
    f = ee.new_zeros((2 * m, 2 * m))
    f[0::2, 0::2] = ee
    f[1::2, 0::2] = oe
    f[0::2, 1::2] = eo
    f[1::2, 1::2] = oo
    return ops._crop_pad_square(f, Sf)


def prolong_comp_plain(ec, n: int, Sf: int):
    """``prolong_comp``'s plain version: (hi, err), masked to the fine
    interior, with hi + err == P ec exactly.  The neighbour sums are taken
    in the TPU kernel's order (``_bilinear_prolong_comp``): the odd-odd node
    pairs each column first, and its error is t1 + (t2 + t3).
    ``precision.prolong_comp`` keeps the JAX jnp route's order."""
    from ..precision import _two_sum
    m = min(ec.shape[-1], (Sf + 1) // 2)
    ep = ec.new_zeros((m + 1, m + 1))   # coarse nodes past m read 0
    ep[:m, :m] = ec[:m, :m]
    c, cdn, crt, cdr = ep[:m, :m], ep[1:, :m], ep[:m, 1:], ep[1:, 1:]
    s1, t1 = _two_sum(c, cdn)
    s, t = _two_sum(c, crt)
    s2, t2 = _two_sum(crt, cdr)
    s4, t3 = _two_sum(s1, s2)
    hi = _interleave(c, 0.5 * s1, 0.5 * s, 0.25 * s4, Sf)
    err = _interleave(torch.zeros_like(c), 0.5 * t1, 0.5 * t,
                      0.25 * (t1 + (t2 + t3)), Sf)
    return ops.mask_interior(hi, n), ops.mask_interior(err, n)


def _check_transfer(entry, x, box) -> None:
    """The options of the TPU transfer kernels that are not ported yet
    raise, on either device."""
    if x.dtype != torch.float32:
        raise NotImplementedError(f"{entry}: float32 only, got {x.dtype}")
    if box is not None:
        raise NotImplementedError(f"{entry}: box masks (mixed boundary "
                                  "conditions) are not ported yet")


def _launch_transfer(entry, inputs, shapes, outputs, S, Sc, n):
    _build.check_inputs(entry, inputs, shapes)
    with torch.cuda.device(inputs[0].device):
        err = getattr(_build.lib(), f"tmt_{entry}")(
            *(t.data_ptr() for t in inputs + outputs), S, Sc, n,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, entry)
    LAUNCHES[entry] += 1


def restrict_fw(r, n: int, Sc: int, cbox=None):
    """Full-weighting restriction of the fine (S, S) ``r`` with ``n`` cells
    to (Sc, Sc), zero outside the coarse interior (and so past S/2)."""
    _check_transfer("restrict_fw", r, cbox)
    if r.device.type == "cpu":
        return restrict_fw_plain(r, n, Sc)
    S = r.shape[-1]
    if not 0 < n < S:
        raise ValueError(f"restrict_fw: n={n} does not fit in S={S}")
    rc = torch.empty((Sc, Sc), dtype=r.dtype, device=r.device)
    _launch_transfer("restrict_fw", (r,), ((S, S),), (rc,), S, Sc, n)
    return rc


def prolong_add(u, ec, n: int, box=None):
    """mask(u + P ec): the coarse (Sc, Sc) correction ``ec`` prolonged onto
    the fine (S, S) grid with ``n`` cells and added to ``u``."""
    _check_transfer("prolong_add", u, box)
    if u.device.type == "cpu":
        return prolong_add_plain(u, ec, n)
    S, Sc = u.shape[-1], ec.shape[-1]
    out = torch.empty_like(u)
    _launch_transfer("prolong_add", (u, ec), ((S, S), (Sc, Sc)), (out,),
                     S, Sc, n)
    return out


def prolong_comp(ec, n: int, Sf: int):
    """(hi, err), each (Sf, Sf), with hi + err == P ec exactly."""
    _check_transfer("prolong_comp", ec, None)
    if ec.device.type == "cpu":
        return prolong_comp_plain(ec, n, Sf)
    Sc = ec.shape[-1]
    hi = torch.empty((Sf, Sf), dtype=ec.dtype, device=ec.device)
    err = torch.empty_like(hi)
    _launch_transfer("prolong_comp", (ec,), ((Sc, Sc),), (hi, err), Sf, Sc,
                     n)
    return hi, err
