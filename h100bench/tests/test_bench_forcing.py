"""The pool of right-hand sides made from the seed, by the system's rule."""

import math

import pytest
import torch

import forcing
import harness

RHS = harness.load_module(harness.BENCH / "systems"
                          / "poisson_dirichlet.py").rhs


def _direct(params, n, shape, width):
    """f h^2 on the interior, evaluated node by node in float64."""
    d = len(shape)
    h = 1.0 / n
    grids = torch.meshgrid(*[torch.arange(s, dtype=torch.float64) * h
                             for s in shape], indexing="ij")
    f = torch.zeros(shape, dtype=torch.float64)
    for a, m in zip(params["a"], params["modes"]):
        term = torch.full(shape, float(a), dtype=torch.float64)
        for ax in range(d):
            term = term * torch.sin(math.pi * int(m[d - 1 - ax]) * grids[ax])
        f += term
    r2 = sum((grids[ax] - params["centre"][d - 1 - ax]) ** 2
             for ax in range(d))
    f += params["bump"] * torch.exp(-r2 / (2 * width ** 2))
    inside = torch.ones(shape, dtype=torch.bool)
    for ax in range(d):
        idx = torch.arange(shape[ax])
        inside &= ((idx >= 1) & (idx <= n - 1)).reshape(
            [-1 if a == ax else 1 for a in range(d)])
    return torch.where(inside, f * h * h, 0.0)


@pytest.mark.parametrize("shape", [(40, 48), (24, 24, 40)])
def test_rhs_matches_the_forcing_node_by_node(shape):
    n = 16
    params = forcing.draw(2 ** 31 + 5, 1, len(shape), 8, 16)[0]
    got = RHS(forcing.field(params, n, shape, 0.05, "cpu"), n)
    want = _direct(params, n, shape, 0.05)
    assert torch.allclose(got, want, rtol=0, atol=1e-15 * float(
        want.abs().max()))


TRAFFIC = {"pool": 3, "forcing": {"modes": 8, "max_mode": 16,
                                  "bump_width": 0.05}}


def _pool(seed, traffic, n, shape):
    return forcing.pool(seed, traffic, n, shape, torch.float32, "cpu", RHS)


def test_same_seed_same_pool_other_seed_other_pool():
    seed = 2 ** 31 + 123456789
    a = _pool(seed, TRAFFIC, 16, (24, 24, 128))
    b = _pool(seed, TRAFFIC, 16, (24, 24, 128))
    c = _pool(seed + 1, TRAFFIC, 16, (24, 24, 128))
    assert len(a) == 3
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not any(torch.equal(x, y) for x, y in zip(a, c))
    assert not torch.equal(a[0], a[1])


def test_pool_is_zero_off_the_interior_and_stored_in_the_type():
    (b,) = _pool(7, dict(TRAFFIC, pool=1), 32, (48, 256))
    assert b.dtype == torch.float32 and tuple(b.shape) == (48, 256)
    assert b[0].abs().max() == 0 and b[32:].abs().max() == 0
    assert b[:, 0].abs().max() == 0 and b[:, 32:].abs().max() == 0
    assert b[1:32, 1:32].abs().min() >= 0 and b[1:32, 1:32].abs().max() > 0


def test_draw_takes_large_and_negative_seeds():
    for seed in (0, 2 ** 31 + 17, 2 ** 40, -5):
        (p,) = forcing.draw(seed, 1, 3, 64, 16)
        assert p["modes"].shape == (64, 3)
        assert p["modes"].min() >= 1 and p["modes"].max() <= 16
        assert all(0.2 <= c <= 0.8 for c in p["centre"])
