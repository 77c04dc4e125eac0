"""Multigrid configuration.

The whole schedule of a solve is a frozen dataclass: the level hierarchy,
sweep counts and cycle shape are Python-level constants that the cycle
drivers read while they walk the hierarchy.  Field names, defaults and
validation match ``tpu_multigrid.config.MultigridConfig``, except that
dtypes are ``torch.dtype`` and ``use_pallas`` is ``use_kernels``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MultigridConfig:
    """Static configuration for a multigrid solve.

    * ``finest_level`` / ``coarsest_level``: grid hierarchy; level ``l`` has
      ``2**l`` cells per side on the unit square.
    * ``nu1`` / ``nu2``: pre-/post-smoothing sweeps.
    * ``nu0``: V-cycles per FMG level.
    * ``omega``: weighted-Jacobi damping.
    * ``smoother``: ``"jacobi"``, ``"rbgs"`` or ``"chebyshev"`` (Jacobi steps
      with the Chebyshev root reciprocals as per-step weights on the
      interval ``[cheb_lo, 2]``); ``"zebra_x"``/``"zebra_y"`` validate but
      have no operator in this package yet.
    * ``coarse_solver``: ``"direct"`` = dense inverse applied as a matvec;
      ``"smooth"`` = ``coarse_smooth_sweeps`` extra sweeps.
    * ``fmg_rhs``: ``"restrict"`` restricts the fine RHS downward;
      ``"assemble"`` takes caller-assembled per-level right-hand sides.
    * ``dtype``: storage dtype of iterate, residual and transfers;
      ``smooth_dtype`` an optional narrower smoothing dtype.
    * ``use_kernels``: run the level visits through the hand-written CUDA
      kernels (``tpu_multigrid_torch.kernels``) where their gates allow.  On
      CPU tensors the kernels' plain torch versions run instead.
    * ``mesh_shape`` / ``replicate_below``: domain decomposition settings,
      kept for a one-to-one field map; single device only in this package.
    """

    finest_level: int = 10
    coarsest_level: int = 3
    nu1: int = 2
    nu2: int = 2
    nu0: int = 1
    omega: float = 2.0 / 3.0
    smoother: str = "jacobi"
    cheb_lo: float = 0.4
    cycle: str = "V"                  # "V" | "W" | "F"
    coarse_solver: str = "direct"     # "direct" | "smooth"
    coarse_smooth_sweeps: int = 10
    fmg_rhs: str = "restrict"         # "restrict" | "assemble"
    restriction: str = "fw"           # "fw" | "injection"
    prolongation: str = "bilinear"    # "bilinear" | "p1"
    dtype: torch.dtype = torch.float32
    smooth_dtype: Optional[torch.dtype] = None
    use_kernels: bool = False
    mesh_shape: Optional[Tuple[int, int]] = None
    replicate_below: int = 3

    def __post_init__(self):
        if self.coarsest_level < 1:
            raise ValueError("coarsest_level must be >= 1 (3x3 grid)")
        if self.finest_level < self.coarsest_level:
            raise ValueError("finest_level must be >= coarsest_level")
        if self.smoother not in ("jacobi", "rbgs", "chebyshev",
                                 "zebra_x", "zebra_y"):
            raise ValueError(f"unknown smoother {self.smoother!r}")
        if not (0.0 < self.cheb_lo < 2.0):
            raise ValueError("cheb_lo must be in (0, 2)")
        if self.cycle not in ("V", "W", "F"):
            raise ValueError(f"unknown cycle {self.cycle!r}")
        if self.coarse_solver not in ("direct", "smooth"):
            raise ValueError(f"unknown coarse_solver {self.coarse_solver!r}")
        if self.fmg_rhs not in ("restrict", "assemble"):
            raise ValueError(f"unknown fmg_rhs {self.fmg_rhs!r}")
        if self.restriction not in ("fw", "injection"):
            raise ValueError(f"unknown restriction {self.restriction!r}")
        if self.prolongation not in ("bilinear", "p1"):
            raise ValueError(f"unknown prolongation {self.prolongation!r}")

    @property
    def num_levels(self) -> int:
        return self.finest_level - self.coarsest_level + 1

    @property
    def effective_smooth_dtype(self) -> torch.dtype:
        if self.smooth_dtype is not None:
            return self.smooth_dtype
        return self.dtype


# Reference schedule: FMG with 31 V-cycles per level and (10,10) smoothing.
REFERENCE_CONFIG = MultigridConfig(
    finest_level=10,
    coarsest_level=7,
    nu1=10,
    nu2=10,
    nu0=31,
    omega=2.0 / 3.0,
    smoother="jacobi",
    coarse_solver="smooth",
    coarse_smooth_sweeps=10,
    fmg_rhs="restrict",
)
