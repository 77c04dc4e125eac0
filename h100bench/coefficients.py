"""The variable coefficients a configuration states as data
(``"coefficient": {"form": ..., ...}``), as callables of float64 tensors.

Frozen with the yardstick, as ``forcing.py`` is: the system hands the
callable to the program, and the reference evaluates the same callable at
the same coordinates, so that both read the same float64 cell values.

* ``hpgmg_tanh``: HPGMG-FV's ``evaluateBeta`` (hpgmg.org,
  ``finite-volume/source``, the problem files under
  ``STENCIL_VARIABLE_COEFFICIENT``): beta = c1 + c2 tanh(c3 (r - radius)),
  c1 = (b_max + b_min) / 2, c2 = (b_max - b_min) / 2, r the distance to
  ``centre`` ([x, y, z]).
"""

from __future__ import annotations

import torch


def callable_of(spec: dict):
    """The coefficient ``spec`` as a callable a(x, y, z) of float64
    tensors, broadcasting as they do."""
    if spec["form"] != "hpgmg_tanh":
        raise ValueError(f"unknown coefficient form {spec['form']!r}")
    c1 = (spec["b_max"] + spec["b_min"]) / 2.0
    c2 = (spec["b_max"] - spec["b_min"]) / 2.0
    c3, radius = float(spec["c3"]), float(spec["radius"])
    cx, cy, cz = (float(c) for c in spec["centre"])

    def beta(x, y, z):
        r = torch.sqrt((x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2)
        return c1 + c2 * torch.tanh(c3 * (r - radius))
    return beta


def cell_values(a, n: int) -> torch.Tensor:
    """(n, n, n) float64 values of ``a`` at the cell centres (i + 1/2) h,
    h = 1/n, on the CPU (z, y, x order): the coordinates as the program's
    ``problems/diffusion3d.py::cell_coefficients3`` makes them."""
    idx = (torch.arange(n, dtype=torch.float64) + 0.5) * (1.0 / n)
    vals = torch.as_tensor(a(idx[None, None, :], idx[None, :, None],
                             idx[:, None, None]), dtype=torch.float64)
    return vals.expand(n, n, n)
