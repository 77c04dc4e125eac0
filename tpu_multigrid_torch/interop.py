"""Carry state across from the JAX package (``tpu_multigrid``).

Everything crosses as plain Python values and numpy arrays, so that both
packages compute the same thing on the same inputs; nothing here imports
JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import MultigridConfig
from .core.grids import Hierarchy
from .core.nonlinear import (BratuNonlinearity, PointwiseNonlinearOp,
                             QuadraticCoefficient, QuasilinearFluxOp,
                             QuasilinearFluxOp3)
from .core.operators import (Const19Op, ConstStencilOp3D, VarStencilOp,
                             VarStencilOp3D, poisson_op)
from .cycles import SolveResult
from .problems.convection3d import Directional7Op
from .problems.periodic import PeriodicOp
from .problems.periodic3d import PeriodicOp3

_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
           "float32": torch.float32, "float64": torch.float64}


def _torch_dtype(d) -> torch.dtype:
    name = d if isinstance(d, str) else np.dtype(d).name
    return _DTYPES[name]


def config_from_fields(fields: dict) -> MultigridConfig:
    """The port's config for a JAX ``MultigridConfig`` given as
    ``dataclasses.asdict``, with its dtypes given by name (``"float32"``):
    ``use_pallas`` maps onto ``use_kernels``, every other field onto itself."""
    f = dict(fields)
    if "use_pallas" in f:
        f["use_kernels"] = f.pop("use_pallas")
    for key in ("dtype", "smooth_dtype"):
        if f.get(key) is not None:
            f[key] = _torch_dtype(f[key])
    if f.get("mesh_shape") is not None:
        f["mesh_shape"] = tuple(f["mesh_shape"])
    return MultigridConfig(**f)


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """A copy of a numpy array (or anything ``np.asarray`` takes) as a
    tensor on ``device``, with the same dtype and shape."""
    return torch.tensor(np.asarray(a), device=device)


def hierarchy_from_numpy(sizes, coarse_inv=None, device=None) -> Hierarchy:
    """A Poisson hierarchy from the JAX one's ``(n, S)`` level sizes and its
    coarse dense inverse (numpy, or None when the coarsest level is
    smoothed)."""
    levels = tuple(poisson_op(n, S) for n, S in sizes)
    inv = None if coarse_inv is None else tensor_from_numpy(coarse_inv, device)
    return Hierarchy(levels, inv)


def hierarchy3d_from_numpy(sizes, coarse_inv=None, device=None,
                           order: int = 2) -> Hierarchy:
    """A 3D hierarchy from the JAX one's ``(n, S, Sx)`` level sizes: the
    7-point operator, or the 19-point Mehrstellen one with ``order=4``; and
    its coarse dense inverse (numpy, or None when the coarsest level is
    smoothed)."""
    cls = Const19Op if order == 4 else ConstStencilOp3D
    levels = tuple(cls(n, S, Sx) for n, S, Sx in sizes)
    inv = None if coarse_inv is None else tensor_from_numpy(coarse_inv, device)
    return Hierarchy(levels, inv)


def var_hierarchy_from_numpy(levels, coarse_inv=None,
                             device=None) -> Hierarchy:
    """A variable-coefficient hierarchy from the JAX one's levels, finest
    first, each a dict of numpy arrays and values: ``coef`` (3, 3, S, S),
    ``inv_diag``, ``n``, ``S``, ``is_symmetric`` (default True) and
    ``coef_sym`` (the kernels' planes, or None), plus the coarse dense
    inverse (numpy, or None when the coarsest level is smoothed); as tensors
    on ``device``."""
    ops_ = []
    for lv in levels:
        sym = lv.get("coef_sym")
        ops_.append(VarStencilOp(
            tensor_from_numpy(lv["coef"], device),
            tensor_from_numpy(lv["inv_diag"], device), lv["n"], lv["S"],
            coef_sym=None if sym is None else tensor_from_numpy(sym, device),
            is_symmetric=lv.get("is_symmetric", True)))
    inv = None if coarse_inv is None else tensor_from_numpy(coarse_inv, device)
    return Hierarchy(ops_, inv)


def var3_hierarchy_from_numpy(levels, coarse_inv=None,
                              device=None) -> Hierarchy:
    """A 3D variable-coefficient hierarchy from the JAX one's levels, finest
    first, each a dict of numpy arrays and values, as tensors on ``device``:
    a ``VarStencilOp3D`` from ``tz``, ``ty``, ``tx``, ``inv_diag``, ``n``,
    ``S``, ``Sx`` and the optional ``c2``, ``t_minus`` and ``coef_stack``;
    or, for a level with a ``diag``, a ``Directional7Op`` from ``cp`` and
    ``cm`` (or its ``coef_stack``), ``diag``, ``inv_diag``, ``n``, ``S``,
    ``Sx`` and the optional ``stencil27``.  ``coarse_inv`` is the coarse
    dense inverse (numpy, or None when the coarsest level is smoothed)."""
    def put(key, lv):
        a = lv.get(key)
        if a is None:
            return None
        if key in ("cp", "cm", "t_minus"):
            return [tensor_from_numpy(x, device) for x in a]
        return tensor_from_numpy(a, device)

    ops_ = []
    for lv in levels:
        if "diag" in lv:
            ops_.append(Directional7Op(
                put("cp", lv), put("cm", lv), put("diag", lv),
                put("inv_diag", lv), lv["n"], lv["S"], lv["Sx"],
                stencil27=lv.get("stencil27"),
                coef_stack=put("coef_stack", lv)))
        else:
            ops_.append(VarStencilOp3D(
                put("tz", lv), put("ty", lv), put("tx", lv),
                put("inv_diag", lv), lv["n"], lv["S"], lv["Sx"],
                c2=put("c2", lv), t_minus=put("t_minus", lv),
                coef_stack=put("coef_stack", lv)))
    inv = None if coarse_inv is None else tensor_from_numpy(coarse_inv, device)
    return Hierarchy(ops_, inv)


def periodic_hierarchy_from_numpy(levels, pinv=None, ndim: int = 2,
                                  device=None) -> Hierarchy:
    """A torus hierarchy from the JAX one's level sides ``n``, finest
    first, and its coarse dense pseudo-inverse (numpy, or None when the
    coarsest level is smoothed), as a tensor on ``device``: ``PeriodicOp``
    levels, or ``PeriodicOp3`` ones with ``ndim=3``.  The torus levels hold
    no arrays, so the pseudo-inverse is all that crosses."""
    if ndim not in (2, 3):
        raise ValueError(f"ndim must be 2 or 3, got {ndim}")
    cls = PeriodicOp3 if ndim == 3 else PeriodicOp
    ops_ = tuple(cls(int(n)) for n in levels)
    inv = None if pinv is None else tensor_from_numpy(pinv, device)
    return Hierarchy(ops_, inv)


def fas_hierarchy_from_numpy(sizes, kind: str, scalar: float,
                             a_dense=None, device=None) -> Hierarchy:
    """A FAS hierarchy from the JAX one's level sizes, finest first: ``(n,
    S)`` per level in 2D, ``(n, S, Sx)`` in 3D.  ``kind`` names the
    nonlinearity and ``scalar`` its parameter: ``"bratu"`` with λ
    (``PointwiseNonlinearOp`` over the 5- or 7-point stencil, φ = −λ eᵘ),
    or ``"quadratic"`` with γ (the flux operator, a = 1 + γu²), the two the
    JAX problems build from ``lam`` and ``gamma``.  ``a_dense`` is the
    coarsest level's dense interior matrix (numpy, Bratu only, or None when
    the coarsest level is smoothed), as a tensor on ``device``."""
    sizes = [tuple(int(x) for x in s) for s in sizes]
    ndim = 3 if len(sizes[0]) == 3 else 2
    if kind == "quadratic":
        a = QuadraticCoefficient(scalar)
        if ndim == 3:
            levels = [QuasilinearFluxOp3(n, S, a, a.da, Sx)
                      for n, S, Sx in sizes]
        else:
            levels = [QuasilinearFluxOp(n, S, a, a.da) for n, S in sizes]
        if a_dense is not None:
            raise ValueError("the quasilinear hierarchy has no a_dense")
        return Hierarchy(levels, None)
    if kind != "bratu":
        raise ValueError(f'kind must be "bratu" or "quadratic", got {kind!r}')
    phi = BratuNonlinearity(scalar)
    levels = []
    for idx, size in enumerate(sizes):
        lin = (ConstStencilOp3D(*size) if ndim == 3 else poisson_op(*size))
        dense = None
        if idx == len(sizes) - 1 and a_dense is not None:
            dense = tensor_from_numpy(a_dense, device)
        levels.append(PointwiseNonlinearOp(lin, phi, phi, diag=2.0 * ndim,
                                           a_dense=dense))
    return Hierarchy(levels, None)


def fas_state_to_numpy(u, b) -> tuple:
    """A FAS state (iterate u, right-hand side b) of either package as
    numpy arrays."""
    return refinement_state_to_numpy((u, b))


def fas_state_from_numpy(u, b, device=None) -> tuple:
    """Numpy (u, b) as tensors on ``device``."""
    return refinement_state_from_numpy((u, b), device)


def result_to_numpy(result: SolveResult) -> dict:
    """A SolveResult as plain values: numpy ``u`` and ``res_history``, int
    ``iterations``, bool ``converged``."""
    return {"u": result.u.detach().cpu().numpy(),
            "res_history": torch.as_tensor(result.res_history).cpu().numpy(),
            "iterations": int(result.iterations),
            "converged": bool(result.converged)}


def refinement_state_to_numpy(components) -> tuple:
    """A refinement iterate of either package, 2D or 3D, as (hi, lo) or
    (hi, mid, lo) (torch tensors, or anything ``np.asarray`` takes), as
    numpy arrays in the same order, shape and dtype."""
    return tuple(c.detach().cpu().numpy() if isinstance(c, torch.Tensor)
                 else np.asarray(c) for c in components)


def refinement_state_from_numpy(components, device=None) -> tuple:
    """The (hi, lo) or (hi, mid, lo) numpy components of a refinement
    iterate as tensors on ``device``, e.g. to resume the port's
    ``precision.solve_refined_ds(u0=hi, u0_lo=lo)`` from a JAX iterate."""
    return tuple(tensor_from_numpy(c, device) for c in components)


def sharded_levels_from_jax(levels):
    """The port's :class:`~tpu_multigrid_torch.dist.shard_cycle.
    ShardedLevels` of a JAX ``ShardedLevels`` (its ``sizes`` and
    ``num_sharded``)."""
    from .dist.shard_cycle import ShardedLevels
    return ShardedLevels(tuple((int(n), int(S)) for n, S in levels.sizes),
                         int(levels.num_sharded))


def ext_block_from_numpy(full, mesh_shape, coords, device=None
                         ) -> torch.Tensor:
    """The ghost-extended block of rank ``coords`` of an (my, mx) mesh
    holding the global (S, S) array ``full``: its (S/my, S/mx) owned block
    inside zero ghost zones (``dist.pallas_cycle.scatter_owned``)."""
    from .kernels.local import GC, GR
    a = np.asarray(full)
    my, mx = mesh_shape
    lr, lc = a.shape[0] // my, a.shape[1] // mx
    cy, cx = coords
    ext = np.zeros((lr + 2 * GR, lc + 2 * GC), a.dtype)
    ext[GR:GR + lr, GC:GC + lc] = a[cy * lr:(cy + 1) * lr,
                                    cx * lc:(cx + 1) * lc]
    return tensor_from_numpy(ext, device)


def pallas_levels3_from_jax(levels):
    """The port's :class:`~tpu_multigrid_torch.dist.pallas_cycle3.
    PallasLevels3` of a JAX ``PallasLevels3`` (its ``sizes`` and
    ``num_sharded``)."""
    from .dist.pallas_cycle3 import PallasLevels3
    return PallasLevels3(tuple((int(n), int(S), int(Sx))
                               for n, S, Sx in levels.sizes),
                         int(levels.num_sharded))

