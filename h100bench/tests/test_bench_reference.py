"""The plain reference on CPU tensors at tiny levels: its operator, its
transfers, its V-cycle, and that it computes the cycles the program runs."""

import numpy as np
import pytest
import torch

import check
import harness
from smallcells import small_cell


def _ref(name, dtype=torch.float64, levels=None):
    cfg = small_cell(name, levels).config
    return cfg, check.reference(cfg, dtype, "cpu")


@pytest.mark.parametrize("name", ["poisson2d-8193.refined-1e-7",
                                  "poisson3d-513.vcycles-3"])
def test_operator_is_the_interior_matrix(name):
    from references.poisson_dirichlet import interior_matrix
    cfg, ref = _ref(name, levels=(3, 2))
    n, d = 8, cfg["ndim"]
    g = torch.Generator().manual_seed(1)
    u = torch.zeros((n + 1,) * d, dtype=torch.float64)
    u[(slice(1, -1),) * d] = torch.randn((n - 1,) * d, generator=g,
                                         dtype=torch.float64)
    want = interior_matrix(n, d, ref.diag) @ u[(slice(1, -1),) * d].numpy() \
        .reshape(-1)
    got = ref.apply(u)
    assert np.allclose(got[(slice(1, -1),) * d].numpy().reshape(-1), want,
                       rtol=0, atol=1e-13)
    edge = got.clone()
    edge[(slice(1, -1),) * d] = 0
    assert float(edge.abs().max()) == 0


@pytest.mark.parametrize("name", ["poisson2d-8193.refined-1e-7",
                                  "poisson3d-513.vcycles-3"])
def test_restriction_is_scaled_prolongation_transposed(name):
    cfg, ref = _ref(name, levels=(4, 2))
    d = cfg["ndim"]
    g = torch.Generator().manual_seed(2)
    r = torch.zeros((17,) * d, dtype=torch.float64)
    r[(slice(1, -1),) * d] = torch.randn((15,) * d, generator=g,
                                         dtype=torch.float64)
    e = torch.zeros((9,) * d, dtype=torch.float64)
    e[(slice(1, -1),) * d] = torch.randn((7,) * d, generator=g,
                                         dtype=torch.float64)
    lhs = float((ref.restrict(r) * e).sum())
    rhs = 4.0 / 2 ** d * float((r * ref.prolong(e)).sum())
    assert lhs == pytest.approx(rhs, rel=1e-13)


@pytest.mark.parametrize("name", ["poisson2d-8193.refined-1e-7",
                                  "poisson3d-513.vcycles-3"])
def test_vcycle_converges_and_refinement_reaches_tol(name):
    cfg, ref = _ref(name)
    n = cfg["levels"][0][0]
    d = cfg["ndim"]
    g = torch.Generator().manual_seed(3)
    b = torch.zeros((n + 1,) * d, dtype=torch.float64)
    b[(slice(1, -1),) * d] = torch.randn((n - 1,) * d, generator=g,
                                         dtype=torch.float64)
    r0 = float(check._norm(b))
    u = ref.cycles(b, 1)
    u2 = ref.vcycle(u, b)
    rho = float(check._norm(ref.residual(u2, b))) / float(
        check._norm(ref.residual(u, b)))
    assert rho < 0.2
    u = ref.refine(b, 1e-10, 40)
    assert float(check._norm(ref.residual(u, b))) <= 1e-10 * r0


@pytest.mark.parametrize("name", ["poisson2d-8193.refined-1e-7",
                                  "poisson3d-513.vcycles-3"])
def test_reference_runs_the_programs_cycles(name):
    """In float64 the program's 3 V-cycles and the reference's agree to
    1e-8 of max|u|: the reference is the same algorithm, written apart.
    (Not to 1e-15: the program stores its coarse inverse in float32 for
    every solve type, which parts the two by ~1e-10.)"""
    import dataclasses
    cell = small_cell(name)
    cfg = cell.config
    hier, mgcfg = harness.build_system(cfg, "cpu")
    mgcfg = dataclasses.replace(mgcfg, dtype=torch.float64, use_kernels=False)
    n, shape = cfg["levels"][0]
    (b,) = harness.make_pool(9, dict(cfg, multigrid=dict(
        cfg["multigrid"], dtype="float64")), dict(cell.traffic, pool=1),
        "cpu")
    from tpu_multigrid_torch import cycles
    hier64 = harness.build_system(dict(cfg, multigrid=dict(
        cfg["multigrid"], dtype="float64", use_kernels=False)), "cpu")[0]
    u = cycles.solve_fixed(hier64, mgcfg, b, 3).u
    ref = check.reference(cfg, torch.float64, "cpu")
    want = ref.cycles(check.nodes(b, n), 3)
    gap = float((check.nodes(u, n) - want).abs().max() / want.abs().max())
    assert gap < 1e-8
    del hier
