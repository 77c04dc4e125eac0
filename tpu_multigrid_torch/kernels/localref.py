"""The compensated-refinement kernels on ghost-extended blocks.

The blocks are :mod:`.local`'s: an ``(R, C) = (lr + 2 GR, lc + 2 GC)``
array whose cell ``(i, j)`` has the global coordinates ``origin + (i, j)``,
live where those lie in ``1..n-1``, and its coarse block
``(R/2 + GR, C/2 + GC)``.

* :func:`ds_residual_ext` / :func:`ts_residual_ext`: the compensated
  residual ``b - A(u_hi + u_lo [+ u_mid])`` at the live cells, 0 elsewhere,
  in ``precision.ds_residual`` / ``ts_residual``'s cascade.
* :func:`prolong_pair_ext`: ``(p_hi, p_lo)`` with ``p_hi + p_lo`` the
  bilinear prolongation of the coarse pair ``ec_hi + ec_lo``, exact up to
  one rounding of ``p_lo``.
* :func:`comp_add_ext`: a ds pair or ts triple ``+=`` one or two plain
  arrays, in place.

They replace the Pallas TPU kernels ``tpu_multigrid/kernels/localref.py::
_comp_residual_local``, ``::_prolong_pair_local`` and ``::_comp_add_local``
(``csrc/localref.cu``), whose entries they keep; ``origin`` is a pair of
host ints.  Each entry runs its plain torch version (``*_plain``) on CPU
tensors and launches its CUDA kernel on CUDA tensors, never falling back.
Every output is defined on the whole array, cells outside it reading as
zero; the TPU kernels leave the ghost ring undefined, so the two packages
agree on the owned region.  ``comp_add_ext`` updates its components in
place on both routes (the TPU kernel's ``input_output_aliases``).
``LAUNCHES`` counts kernel launches per entry.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .local import GC, GR, _masks, _prolonged, coarse_shape

LAUNCHES = {"ds_residual_ext": 0, "ts_residual_ext": 0,
            "prolong_pair_ext": 0, "comp_add_ext": 0}


def supported_local_ref(R: int, C: int, dtype) -> bool:
    """Whether the compensated kernels take an (R, C) block: float32, with
    its owned region on the (16, 256) quanta of ``tpu_multigrid.kernels.
    localref.supported_local_ref``.  (That gate also bounds the TPU's
    row strips by its on-chip memory; the kernels here take any width.)"""
    if dtype != torch.float32:
        return False
    return not ((R - 2 * GR) <= 0 or (R - 2 * GR) % 16
                or (C - 2 * GC) % 256 or (C - 2 * GC) <= 0)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _shifts(x):
    """x[i-1, j], x[i+1, j], x[i, j-1], x[i, j+1], cells outside reading 0:
    the order of ``precision``'s neighbour sums."""
    p = F.pad(x, (1, 1, 1, 1))
    return [p[:-2, 1:-1], p[2:, 1:-1], p[1:-1, :-2], p[1:-1, 2:]]


def _precision():
    """``tpu_multigrid_torch.precision``, which imports this package: taken
    at call time."""
    from .. import precision
    return precision


def _nbr_comp(x):
    precision = _precision()
    terms = _shifts(x)
    s, c = terms[0], torch.zeros_like(x)
    for t in terms[1:]:
        s, e = precision._two_sum(s, t)
        c = c + e
    return s, c


def _apply_a(x):
    t = _shifts(x)
    return 4.0 * x - (((t[0] + t[1]) + t[2]) + t[3])


def _residual_ext_plain(b, parts, origin, n: int):
    lead = parts[:-1]
    r = _precision()._cascade(b, lead, [_nbr_comp(p) for p in lead],
                              _apply_a(parts[-1]))
    R, C = b.shape
    return torch.where(_masks(R, C, origin, n, b.device)[0], r, 0.0)


def ds_residual_ext_plain(b, u_hi, u_lo, origin, n: int):
    return _residual_ext_plain(b, (u_hi, u_lo), origin, n)


def ts_residual_ext_plain(b, u_hi, u_mid, u_lo, origin, n: int):
    return _residual_ext_plain(b, (u_hi, u_mid, u_lo), origin, n)


def _interleave(ee, oe, eo, oo, R: int, C: int):
    """out[2i + a, 2j + b] = phase (a, b), cropped to (R, C)."""
    out = ee.new_empty((2 * ee.shape[0], 2 * ee.shape[1]))
    out[0::2, 0::2] = ee
    out[1::2, 0::2] = oe
    out[0::2, 1::2] = eo
    out[1::2, 1::2] = oo
    return out[:R, :C]


def prolong_pair_ext_plain(ec_hi, ec_lo, origin, nf: int):
    """The exact pair of P ec_hi in ``transfer._bilinear_prolong_comp``'s
    order (the odd-odd cell pairs each column first; its error is
    t1 + (t2 + t3)), then p_lo = P ec_lo + err, both masked to the live
    cells of the fine level ``nf``."""
    two_sum = _precision()._two_sum
    Rc, Cc = ec_hi.shape
    R, C = 2 * (Rc - GR), 2 * (Cc - GC)
    e = ec_hi[GR // 2:GR // 2 + R // 2 + 1, GC // 2:GC // 2 + C // 2 + 1]
    c, cdn, crt, cdr = e[:-1, :-1], e[1:, :-1], e[:-1, 1:], e[1:, 1:]
    s1, t1 = two_sum(c, cdn)
    s, t = two_sum(c, crt)
    s2, t2 = two_sum(crt, cdr)
    s4, t3 = two_sum(s1, s2)
    hi = _interleave(c, 0.5 * s1, 0.5 * s, 0.25 * s4, R, C)
    err = _interleave(torch.zeros_like(c), 0.5 * t1, 0.5 * t,
                      0.25 * (t1 + (t2 + t3)), R, C)
    live = _masks(R, C, origin, nf, ec_hi.device)[0]
    p_lo = _prolonged(ec_lo, R, C) + err
    return torch.where(live, hi, 0.0), torch.where(live, p_lo, 0.0)


def comp_add_ext_plain(comps, ys):
    """comps += each y in turn through ``precision.ds_add`` (a pair) or
    ``ts_add`` (a triple), written back into ``comps`` with ``copy_``."""
    new = list(comps)
    _precision()._accumulate(new, ys)
    for c, v in zip(comps, new):
        c.copy_(v)
    return tuple(comps)


# ---------------------------------------------------------------------------
# Entries
# ---------------------------------------------------------------------------

def _float32(entry, x):
    if x.dtype != torch.float32:
        raise NotImplementedError(f"{entry}: float32 only, got {x.dtype}")


def _residual(entry, b, comps, origin, n):
    R, C = b.shape
    arrays = (b, *comps)
    _build.check_inputs(entry, arrays, [(R, C)] * len(arrays))
    r = torch.empty_like(b)
    hi, lo = comps[0], comps[-1]
    mid = comps[1] if len(comps) == 3 else None
    with torch.cuda.device(b.device):
        err = _build.lib().tmt_comp_residual_ext(
            b.data_ptr(), hi.data_ptr(), None if mid is None else
            mid.data_ptr(), lo.data_ptr(), r.data_ptr(), R, C,
            int(origin[0]), int(origin[1]), n,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, entry)
    LAUNCHES[entry] += 1
    return r


def ds_residual_ext(b, u_hi, u_lo, origin, n: int):
    """r = b - A(u_hi + u_lo) to ~eps^2 at the live cells, 0 elsewhere."""
    _float32("ds_residual_ext", b)
    if b.device.type == "cpu":
        return ds_residual_ext_plain(b, u_hi, u_lo, origin, n)
    return _residual("ds_residual_ext", b, (u_hi, u_lo), origin, n)


def ts_residual_ext(b, u_hi, u_mid, u_lo, origin, n: int):
    """r = b - A(u_hi + u_mid + u_lo) to ~eps^3 at the live cells."""
    _float32("ts_residual_ext", b)
    if b.device.type == "cpu":
        return ts_residual_ext_plain(b, u_hi, u_mid, u_lo, origin, n)
    return _residual("ts_residual_ext", b, (u_hi, u_mid, u_lo), origin, n)


def prolong_pair_ext(ec_hi, ec_lo, origin, nf: int):
    """(p_hi, p_lo) on the (2 (Rc - GR), 2 (Cc - GC)) fine block: the
    prolongation of the coarse pair, masked to the fine level ``nf``."""
    _float32("prolong_pair_ext", ec_hi)
    Rc, Cc = ec_hi.shape
    R, C = 2 * (Rc - GR), 2 * (Cc - GC)
    if R <= 0 or C <= 0 or coarse_shape(R, C) != (Rc, Cc):
        raise ValueError(f"prolong_pair_ext: {tuple(ec_hi.shape)} is no "
                         "coarse block")
    if ec_hi.device.type == "cpu":
        return prolong_pair_ext_plain(ec_hi, ec_lo, origin, nf)
    _build.check_inputs("prolong_pair_ext", (ec_hi, ec_lo), ((Rc, Cc),) * 2)
    p_hi = torch.empty((R, C), dtype=ec_hi.dtype, device=ec_hi.device)
    p_lo = torch.empty_like(p_hi)
    with torch.cuda.device(ec_hi.device):
        err = _build.lib().tmt_prolong_pair_ext(
            ec_hi.data_ptr(), ec_lo.data_ptr(), p_hi.data_ptr(),
            p_lo.data_ptr(), R, C, int(origin[0]), int(origin[1]), nf,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "prolong_pair_ext")
    LAUNCHES["prolong_pair_ext"] += 1
    return p_hi, p_lo


def comp_add_ext(comps, ys):
    """comps (a ds pair or ts triple) += each of ``ys`` (one or two plain
    arrays) in turn, renormalised, IN PLACE; returns ``comps`` as a tuple.
    No y may share storage with a component."""
    comps, ys = tuple(comps), tuple(ys)
    if len(comps) not in (2, 3) or len(ys) not in (1, 2):
        raise ValueError(f"comp_add_ext: {len(comps)} components and "
                         f"{len(ys)} addends (2 or 3, and 1 or 2)")
    _float32("comp_add_ext", comps[0])
    if comps[0].device.type == "cpu":
        return comp_add_ext_plain(comps, ys)
    shape = tuple(comps[0].shape)
    _build.check_inputs("comp_add_ext", comps + ys,
                        [shape] * (len(comps) + len(ys)))
    ptrs = [c.data_ptr() for c in comps] + [None] * (3 - len(comps))
    ptrs += [y.data_ptr() for y in ys] + [None] * (2 - len(ys))
    with torch.cuda.device(comps[0].device):
        err = _build.lib().tmt_comp_add_ext(
            *ptrs, comps[0].numel(), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "comp_add_ext")
    LAUNCHES["comp_add_ext"] += 1
    return comps
