"""tpu_multigrid_torch's CUDA kernels against their plain torch versions on
the same CUDA tensors.

Needs a Hopper GPU and the CUDA toolkit; every test is marked ``cuda`` and
skips elsewhere.  This file imports no JAX, so it runs on a machine without
it (the repository's conftest imports JAX, hence ``--noconftest``):

    python -m pytest tests/test_torch_cuda.py --noconftest -q

The kernels evaluate the same IEEE operations in the same order as the plain
versions (built with -fmad=false), so u', rc and the compensated residuals
must agree bitwise; only the resnorm sums in another order (rtol 1e-5).
"""

import dataclasses

import pytest
import torch

import tpu_multigrid_torch as tmg
from tpu_multigrid_torch import kernels, precision
from tpu_multigrid_torch.core import ops
from tpu_multigrid_torch.kernels import compres, transfer

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _interior(S, n, gen, scale=1.0):
    a = torch.zeros((S, S), device="cuda")
    a[1:n, 1:n] = scale * torch.randn((n - 1, n - 1), generator=gen,
                                      device="cuda")
    return a


# (S, Sc, n): the bottom pair, a mid pair, a padded odd-sized pair.
PAIRS = [(256, 256, 64), (768, 512, 512), (1280, 768, 1000)]
SMOOTHERS = [("jacobi", ops.chebyshev_omegas(3, 0.4), 3),
             ("jacobi", 2.0 / 3.0, 1), ("jacobi", 2.0 / 3.0, 0),
             ("rbgs", 2.0 / 3.0, 2)]


@pytest.mark.parametrize("S,Sc,n", PAIRS)
@pytest.mark.parametrize("smoother,omega,sweeps", SMOOTHERS)
def test_k1_matches_plain_bitwise(gen, S, Sc, n, smoother, omega, sweeps):
    u, b = _interior(S, n, gen), _interior(S, n, gen)
    ku, krc = transfer.smooth_restrict(u, b, n, Sc, sweeps, smoother, omega)
    pu, prc = transfer.smooth_restrict_plain(u, b, n, Sc, sweeps, smoother,
                                             omega)
    assert torch.equal(ku, pu)
    assert torch.equal(krc, prc)


@pytest.mark.parametrize("S,Sc,n", PAIRS)
@pytest.mark.parametrize("smoother,omega,sweeps", SMOOTHERS)
def test_k2_matches_plain(gen, S, Sc, n, smoother, omega, sweeps):
    u, b = _interior(S, n, gen), _interior(S, n, gen)
    ec = _interior(Sc, n // 2, gen)
    args = (u, b, ec, n, sweeps, smoother, omega)
    want = transfer.prolong_smooth_plain(*args)
    assert torch.equal(transfer.prolong_smooth(*args), want)
    ku, knorm = transfer.prolong_smooth_resnorm(*args)
    _, pnorm = transfer.prolong_smooth_resnorm_plain(*args)
    assert torch.equal(ku, want)
    torch.testing.assert_close(knorm, pnorm, rtol=1e-5, atol=0)
    # A fixed summation order: the norm repeats exactly.
    assert torch.equal(transfer.prolong_smooth_resnorm(*args)[1], knorm)


@pytest.mark.parametrize("S,n", [(256, 250), (8448, 8192)])
def test_comp_residuals_match_plain_bitwise(gen, S, n):
    b = _interior(S, n, gen, 1.0 / n ** 2)
    uh = _interior(S, n, gen)
    um = _interior(S, n, gen, 1e-7)
    ul = _interior(S, n, gen, 1e-14)
    assert torch.equal(compres.ds_residual(b, uh, um, n),
                       precision.ds_residual(b, uh, um, n))
    assert torch.equal(compres.ts_residual(b, uh, um, ul, n),
                       precision.ts_residual(b, uh, um, ul, n))


def test_launches_are_counted(gen):
    kernels.reset_launch_counts()
    u, b = _interior(256, 64, gen), _interior(256, 64, gen)
    transfer.smooth_restrict(u, b, 64, 256, 1)
    transfer.prolong_smooth(u, b, u, 64, 1)
    transfer.prolong_smooth_resnorm(u, b, u, 64, 1)
    compres.ds_residual(b, u, u, 64)
    compres.ts_residual(b, u, u, u, 64)
    assert kernels.launch_counts() == dict.fromkeys(
        ["smooth_restrict", "prolong_smooth", "prolong_smooth_resnorm",
         "ds_residual", "ts_residual"], 1)


def test_bad_inputs_raise(gen):
    u = _interior(256, 64, gen)
    with pytest.raises(ValueError):
        transfer.smooth_restrict(u, u.cpu(), 64, 256, 1)
    with pytest.raises(ValueError):
        transfer.smooth_restrict(u, u[:, :128], 64, 256, 1)
    with pytest.raises(ValueError):
        transfer.smooth_restrict(u, u.t(), 64, 256, 1)
    with pytest.raises(ValueError):
        transfer.smooth_restrict(u, u, 64, 64, 1)
    with pytest.raises(ValueError):
        compres.ds_residual(u, u, u[:128, :128].contiguous(), 64)


@pytest.mark.parametrize("shape", ["V", "W", "F"])
def test_kernel_path_solve_matches_plain_path(gen, shape):
    """Kernels and plain ops compute the same iterates bitwise, so the
    until-tol decisions agree; only the fused resnorm's summation order
    differs."""
    cfg = tmg.MultigridConfig(finest_level=10, coarsest_level=5, nu1=3,
                              nu2=2, smoother="chebyshev", cycle=shape,
                              use_kernels=True)
    rk = tmg.solve_poisson(10, config=cfg, tol=1e-7, device="cuda")
    rp = tmg.solve_poisson(10, config=dataclasses.replace(
        cfg, use_kernels=False), tol=1e-7, device="cuda")
    assert rk.converged and rp.converged
    assert rk.iterations == rp.iterations
    assert torch.equal(tmg.extract_solution(rk.u, 1024),
                       tmg.extract_solution(rp.u, 1024))
