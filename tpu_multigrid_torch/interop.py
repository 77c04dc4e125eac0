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
from .core.operators import VarStencilOp, poisson_op
from .cycles import SolveResult

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


def result_to_numpy(result: SolveResult) -> dict:
    """A SolveResult as plain values: numpy ``u`` and ``res_history``, int
    ``iterations``, bool ``converged``."""
    return {"u": result.u.detach().cpu().numpy(),
            "res_history": torch.as_tensor(result.res_history).cpu().numpy(),
            "iterations": int(result.iterations),
            "converged": bool(result.converged)}


def refinement_state_to_numpy(components) -> tuple:
    """A refinement iterate of either package, as (hi, lo) or (hi, mid, lo)
    (torch tensors, or anything ``np.asarray`` takes), as numpy arrays in
    the same order and dtype."""
    return tuple(c.detach().cpu().numpy() if isinstance(c, torch.Tensor)
                 else np.asarray(c) for c in components)


def refinement_state_from_numpy(components, device=None) -> tuple:
    """The (hi, lo) or (hi, mid, lo) numpy components of a refinement
    iterate as tensors on ``device``, e.g. to resume the port's
    ``precision.solve_refined_ds(u0=hi, u0_lo=lo)`` from a JAX iterate."""
    return tuple(tensor_from_numpy(c, device) for c in components)
