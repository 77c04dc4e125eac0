"""tpu_multigrid_torch's CUDA kernels against their plain torch versions on
the same CUDA tensors.

Needs a Hopper GPU and the CUDA toolkit; every test is marked ``cuda`` and
skips elsewhere.  This file imports no JAX, so it runs on a machine without
it (the repository's conftest imports JAX, hence ``--noconftest``):

    python -m pytest tests/test_torch_cuda.py --noconftest -q

The kernels evaluate the same IEEE operations in the same order as the plain
versions (built with -fmad=false), so u', rc, the streaming smoother, the
standalone transfers and the compensated residuals must agree bitwise; only
the resnorm sums in another order (rtol 1e-5).
"""

import dataclasses

import pytest
import torch

import tpu_multigrid_torch as tmg
from tpu_multigrid_torch import kernels, precision
from tpu_multigrid_torch.core import ops
from tpu_multigrid_torch.kernels import compres, stencil, transfer

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
    stencil.jacobi_sweeps(u, b, 64, 2.0 / 3.0, 1)
    stencil.jacobi_sweeps_residual(u, b, 64, 2.0 / 3.0, 1)
    stencil.rbgs_sweeps(u, b, 64, 1)
    stencil.rbgs_sweeps_residual(u, b, 64, 1)
    stencil.residual(u, b, 64)
    transfer.restrict_fw(b, 64, 256)
    transfer.prolong_add(u, b, 64)
    transfer.prolong_comp(b, 64, 256)
    assert kernels.launch_counts() == dict.fromkeys(
        ["smooth_restrict", "prolong_smooth", "prolong_smooth_resnorm",
         "restrict_fw", "prolong_add", "prolong_comp", "jacobi_sweeps",
         "jacobi_sweeps_residual", "rbgs_sweeps", "rbgs_sweeps_residual",
         "residual", "ds_residual", "ts_residual"], 1)
    # Deep smoothing splits: 10 RB-GS sweeps are 20 half-steps, two launches.
    stencil.rbgs_sweeps(u, b, 64, 10)
    assert kernels.launch_counts()["rbgs_sweeps"] == 3


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


# (label, entry arguments): the record's Chebyshev (3, 2), plain Jacobi,
# RB-GS, and deep smoothing that splits into launches (the smoothed coarsest
# level's 10 sweeps; Chebyshev 20 rotates its weights across launches).
STENCIL_CASES = [("chebyshev3", "jacobi", ops.chebyshev_omegas(3, 0.4), 3),
                 ("chebyshev2", "jacobi", ops.chebyshev_omegas(2, 0.4), 2),
                 ("jacobi", "jacobi", 2.0 / 3.0, 1),
                 ("rbgs", "rbgs", None, 2),
                 ("rbgs10", "rbgs", None, 10),
                 ("chebyshev20", "jacobi", ops.chebyshev_omegas(20, 0.4), 20)]


@pytest.mark.parametrize("S,n", [(256, 64), (1280, 1000), (2304, 2048)])
@pytest.mark.parametrize("label,sm,om,sweeps", STENCIL_CASES)
def test_stencil_matches_plain_bitwise(gen, S, n, label, sm, om, sweeps):
    u, b = _interior(S, n, gen), _interior(S, n, gen)
    if sm == "rbgs":
        k = stencil.rbgs_sweeps(u, b, n, sweeps)
        kr = stencil.rbgs_sweeps_residual(u, b, n, sweeps)
        p = stencil.rbgs_sweeps_plain(u, b, n, sweeps)
        pr = stencil.rbgs_sweeps_residual_plain(u, b, n, sweeps)
    else:
        k = stencil.jacobi_sweeps(u, b, n, om, sweeps)
        kr = stencil.jacobi_sweeps_residual(u, b, n, om, sweeps)
        p = stencil.jacobi_sweeps_plain(u, b, n, om, sweeps)
        pr = stencil.jacobi_sweeps_residual_plain(u, b, n, om, sweeps)
    assert torch.equal(k, p)
    assert torch.equal(kr[0], pr[0]) and torch.equal(kr[1], pr[1])


@pytest.mark.parametrize("S,n", [(256, 250), (1280, 1000)])
def test_stencil_residual_matches_plain_bitwise(gen, S, n):
    u, b = _interior(S, n, gen), _interior(S, n, gen)
    assert torch.equal(stencil.residual(u, b, n),
                       stencil.residual_plain(u, b, n))
    k, r = stencil.jacobi_sweeps_residual(u, b, n, 2.0 / 3.0, 0)
    assert torch.equal(k, u) and torch.equal(r, stencil.residual_plain(u, b, n))


@pytest.mark.parametrize("S,Sc,n", PAIRS)
def test_standalone_transfers_match_plain_bitwise(gen, S, Sc, n):
    r, u = _interior(S, n, gen), _interior(S, n, gen)
    ec = _interior(Sc, n // 2, gen)
    assert torch.equal(transfer.restrict_fw(r, n, Sc),
                       transfer.restrict_fw_plain(r, n, Sc))
    assert torch.equal(transfer.prolong_add(u, ec, n),
                       transfer.prolong_add_plain(u, ec, n))
    hi, err = transfer.prolong_comp(ec, n, S)
    phi, perr = transfer.prolong_comp_plain(ec, n, S)
    assert torch.equal(hi, phi) and torch.equal(err, perr)
    # The pair is exact: hi + err is the float64 prolongation.
    want = ops.prolong(ec.double(), n // 2, S)
    assert torch.equal(hi.double() + err.double(), want)


def test_new_kernels_bad_inputs_raise(gen):
    u = _interior(256, 64, gen)
    with pytest.raises(ValueError):
        stencil.jacobi_sweeps(u, u.cpu(), 64, 2.0 / 3.0, 1)
    with pytest.raises(ValueError):
        stencil.residual(u, u[:, :128], 64)
    with pytest.raises(ValueError):
        stencil.rbgs_sweeps(u, u.t(), 64, 1)
    with pytest.raises(NotImplementedError):
        stencil.jacobi_sweeps(u.double(), u.double(), 64, 2.0 / 3.0, 1)
    with pytest.raises(ValueError):
        transfer.restrict_fw(u, 256, 256)
    with pytest.raises(ValueError):
        transfer.prolong_add(u, u.t(), 64)
    with pytest.raises(NotImplementedError):
        transfer.prolong_add(u, u, 64, box=(0, 63, 1, 63))
    with pytest.raises(NotImplementedError):
        transfer.prolong_comp(u.to(torch.bfloat16), 64, 256)


def test_ts_refinement_kernel_path_matches_plain_path(gen):
    """The ds cycle's kernels sum the exact-pair prolongation in the TPU
    kernel's order and the plain path in the jnp route's, so the iterates
    differ at roundoff; both reach 1e-10 within one iteration of each
    other, and the float64 residual of the kernel path's triple is below
    1e-10 relative."""
    cfg = tmg.MultigridConfig(finest_level=10, coarsest_level=5, nu1=3,
                              nu2=2, smoother="chebyshev", use_kernels=True)
    prob = tmg.PoissonProblem(cfg, device="cuda", align=256, min_pad_level=0)
    b = prob.rhs()
    kernels.reset_launch_counts()
    ko = precision.solve_refined_ts(prob.hierarchy, cfg, b, tol=1e-10,
                                    max_iters=30)
    counts = kernels.launch_counts()
    po = precision.solve_refined_ts(
        prob.hierarchy, dataclasses.replace(cfg, use_kernels=False), b,
        tol=1e-10, max_iters=30)
    assert kernels.launch_counts() == counts
    assert ko[5] and po[5] and abs(ko[4] - po[4]) <= 1
    it = ko[4]
    for name in ("jacobi_sweeps_residual", "jacobi_sweeps", "restrict_fw",
                 "prolong_comp", "prolong_add", "ds_residual"):
        assert counts[name] == 3 * it, name
    assert counts["smooth_restrict"] == counts["prolong_smooth"] == 2 * it
    assert counts["ts_residual"] == it
    u = (ko[0].double() + ko[1].double()) + ko[2].double()
    r = ops.mask_interior(b.double() - 4.0 * u + ops.neighbor_sum(u), 1024)
    assert float(ops.norm2(r)) / float(ops.norm2(b.double())) < 1e-10
