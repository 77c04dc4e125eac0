"""The right-hand sides of a cell, made from ``--seed``.

Each right-hand side comes from a forcing

    f = sum_{k<K} a_k sin(p_k pi x) sin(q_k pi y) [sin(r_k pi z)]
        + a_b exp(-|x - c|^2 / (2 w^2)),

with a_k, a_b ~ N(0, 1), modes p_k, q_k, r_k uniform in 1..M and the bump's
centre c uniform in [0.2, 0.8]^d, all drawn on the host from the seed (a few
dozen numbers), so that the same seed gives the same inputs on any machine.
The grid values are worked out on the device in float64 at the nodes
x_i = i h (h = 1/n) of the padded grid, the modes as one product of
matrices.  The configuration's system (``systems/<system>.py``) turns f into
b by its problem's rule, and b is rounded once to the storage type.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def rng(seed: int, stream: int) -> np.random.Generator:
    """A generator of its own for each use of the seed (0: forcing, 1: the
    sample of solves the check compares)."""
    return np.random.default_rng([int(seed) % 2 ** 64, stream])


def draw(seed: int, count: int, ndim: int, modes: int, max_mode: int):
    """The parameters of ``count`` forcings, in pool order."""
    g = rng(seed, 0)
    out = []
    for _ in range(count):
        out.append({"a": g.standard_normal(modes),
                    "modes": g.integers(1, max_mode + 1, (modes, ndim)),
                    "bump": float(g.standard_normal()),
                    "centre": g.uniform(0.2, 0.8, ndim)})
    return out


def _outer(vectors):
    """The tensor product of per-axis vectors (z, y, x order)."""
    out = vectors[0]
    for v in vectors[1:]:
        out = out[..., None] * v
    return out


def field(params: dict, n: int, shape, width: float, device):
    """f at the nodes of a padded ``shape`` grid, in float64."""
    d = len(shape)
    h = 1.0 / n
    axes = [torch.arange(size, dtype=torch.float64, device=device) * h
            for size in shape]
    # Axis 0 is z in 3D (y in 2D) and the last is x: mode column j of the
    # draw belongs to axis d-1-j, so x takes the first column.
    modes = torch.as_tensor(params["modes"], dtype=torch.float64,
                            device=device)
    waves = [torch.sin(math.pi * modes[:, d - 1 - ax, None] * axes[ax])
             for ax in range(d)]
    # The sum of the modes' tensor products as one product of matrices:
    # (a_k w0_k) over axis 0, times the rows w1_k (x) ... of the others.
    a = torch.as_tensor(params["a"], dtype=torch.float64, device=device)
    rest = waves[1]
    for w in waves[2:]:
        rest = (rest[:, :, None] * w[:, None, :]).reshape(len(a), -1)
    f = ((a[:, None] * waves[0]).T @ rest).reshape(tuple(shape))
    c = params["centre"]
    f += params["bump"] * _outer([torch.exp(-(axes[ax] - float(c[d - 1 - ax]))
                                            ** 2 / (2.0 * width ** 2))
                                  for ax in range(d)])
    return f


def pool(seed: int, traffic: dict, n: int, shape, dtype, device, to_b):
    """The cell's right-hand sides, in the order the requests take them:
    ``to_b(f, n)`` of each forcing, stored in ``dtype``."""
    spec = traffic["forcing"]
    return [to_b(field(p, n, shape, spec["bump_width"], device), n).to(dtype)
            for p in draw(seed, traffic["pool"], len(shape), spec["modes"],
                          spec["max_mode"])]
