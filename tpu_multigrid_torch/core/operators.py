"""Level operators.

:class:`ConstStencilOp` is the constant-coefficient FEM Poisson stencil
(diagonal 4, off-diagonals -1).  It carries no array state: applying it
reads only the solution and right-hand-side grids.
"""

from __future__ import annotations

from . import ops


class ConstStencilOp:
    """FEM-scaled 5-point Poisson operator on an (S, S) padded node grid."""

    def __init__(self, n: int, S: int):
        self.n = int(n)
        self.S = int(S)

    def apply(self, u):
        return ops.apply_poisson(u, self.n)

    def residual(self, u, b):
        return ops.residual(u, b, self.n)

    def smooth(self, u, b, *, smoother: str, omega, sweeps: int):
        if smoother == "jacobi":
            return ops.jacobi_sweeps(u, b, self.n, omega, sweeps)
        if smoother == "rbgs":
            return ops.redblack_gs_sweeps(u, b, self.n, sweeps)
        raise ValueError(f"unknown smoother {smoother!r}")

    def __repr__(self):
        return f"ConstStencilOp(n={self.n}, S={self.S})"


def poisson_op(n: int, S: int) -> ConstStencilOp:
    return ConstStencilOp(n, S)
