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
    assert {k: v for k, v in kernels.launch_counts().items() if v} == \
        dict.fromkeys(
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


# ---------------------------------------------------------------------------
# The variable-coefficient kernels: the var-stencil smoother, K1v and K2v
# ---------------------------------------------------------------------------

def _var_planes(kind, n, S):
    """Kernel planes on the card: the flux operator (5 planes), a Galerkin
    9-point level (5 planes) or a nonsymmetric operator from a seed (9)."""
    import numpy as np

    from tpu_multigrid_torch.core import operators
    rng = np.random.default_rng(0)
    if kind == "nonsym":
        coef = np.zeros((3, 3, S, S), np.float32)
        coef[:, :, 1:n, 1:n] = -0.25 - rng.random((3, 3, n - 1, n - 1))
        coef[1, 1, 1:n, 1:n] = 8.0 + rng.random((n - 1, n - 1))
        op = operators.VarStencilOp(coef, None, n, S, is_symmetric=False)
    elif kind == "galerkin":
        cells = (0.5 + rng.random((2 * n, 2 * n))).astype(np.float32)
        op = operators.galerkin_coarsen_host(
            operators.diffusion_op_host(cells, 2 * n, 2 * S), S)
    else:
        cells = (0.5 + rng.random((n, n))).astype(np.float32)
        op = operators.diffusion_op_host(cells, n, S)
    return torch.from_numpy(op.with_sym_planes().coef_sym).cuda()


VAR_KINDS = ["flux", "galerkin", "nonsym"]
VAR_SMOOTHERS = [("jacobi", ops.chebyshev_omegas(3, 0.4), 3),
                 ("jacobi", 2.0 / 3.0, 2), ("rbgs", 2.0 / 3.0, 1),
                 ("rbgs", 2.0 / 3.0, 3)]


@pytest.mark.parametrize("S,n", [(256, 250), (1280, 1000), (2304, 2048)])
@pytest.mark.parametrize("kind", VAR_KINDS)
@pytest.mark.parametrize("sm,om,sweeps", VAR_SMOOTHERS)
def test_var_smooth_matches_plain_bitwise(gen, S, n, kind, sm, om, sweeps):
    from tpu_multigrid_torch.kernels import varstencil
    coef = _var_planes(kind, n, S)
    u, b = _interior(S, n, gen), _interior(S, n, gen)
    args = (u, b, coef, n, sweeps, sm, om)
    assert torch.equal(varstencil.var_smooth(*args),
                       varstencil.var_smooth_plain(*args))
    kv, kr = varstencil.var_smooth_residual(*args)
    pv, pr = varstencil.var_smooth_residual_plain(*args)
    assert torch.equal(kv, pv) and torch.equal(kr, pr)


@pytest.mark.parametrize("S,Sc,n", PAIRS)
@pytest.mark.parametrize("kind", VAR_KINDS)
@pytest.mark.parametrize("sm,om,sweeps", VAR_SMOOTHERS)
def test_k1v_k2v_match_plain(gen, S, Sc, n, kind, sm, om, sweeps):
    from tpu_multigrid_torch.kernels import vartransfer
    coef = _var_planes(kind, n, S)
    u, b = _interior(S, n, gen), _interior(S, n, gen)
    ec = _interior(Sc, n // 2, gen)
    ku, krc = vartransfer.var_smooth_restrict_fused(u, b, coef, n, Sc,
                                                    sweeps, sm, om)
    pu, prc = vartransfer.var_smooth_restrict_plain(u, b, coef, n, Sc,
                                                    sweeps, sm, om)
    assert torch.equal(ku, pu) and torch.equal(krc, prc)
    args = (u, b, ec, coef, n, sweeps, sm, om)
    want = vartransfer.var_prolong_smooth_plain(*args)
    assert torch.equal(vartransfer.var_prolong_smooth_fused(*args), want)
    ku, knorm = vartransfer.var_prolong_smooth_resnorm(*args)
    _, pnorm = vartransfer.var_prolong_smooth_resnorm_plain(*args)
    assert torch.equal(ku, want)
    torch.testing.assert_close(knorm, pnorm, rtol=1e-5, atol=0)
    assert torch.equal(vartransfer.var_prolong_smooth_resnorm(*args)[1],
                       knorm)


def test_var_launches_are_counted_and_bad_inputs_raise(gen):
    from tpu_multigrid_torch.kernels import varstencil, vartransfer
    coef = _var_planes("flux", 64, 256)
    u, b = _interior(256, 64, gen), _interior(256, 64, gen)
    kernels.reset_launch_counts()
    varstencil.var_smooth(u, b, coef, 64, 1)
    varstencil.var_smooth_residual(u, b, coef, 64, 0)
    vartransfer.var_smooth_restrict_fused(u, b, coef, 64, 256, 1)
    vartransfer.var_prolong_smooth_fused(u, b, u, coef, 64, 1)
    vartransfer.var_prolong_smooth_resnorm(u, b, u, coef, 64, 1)
    counts = kernels.launch_counts()
    assert {k: v for k, v in counts.items() if v} == dict.fromkeys(
        ["var_smooth", "var_smooth_residual", "var_smooth_restrict_fused",
         "var_prolong_smooth_fused", "var_prolong_smooth_resnorm"], 1)
    with pytest.raises(ValueError):
        varstencil.var_smooth(u, b, coef.cpu(), 64, 1)
    with pytest.raises(ValueError):
        varstencil.var_smooth(u, b, coef[:, :, :128].contiguous(), 64, 1)
    with pytest.raises(ValueError):
        vartransfer.var_smooth_restrict_fused(u, b, coef, 64, 64, 1)
    with pytest.raises(ValueError):   # deeper than the shared window
        vartransfer.var_smooth_restrict_fused(u, b, coef, 64, 256, 40, "rbgs")
    with pytest.raises(NotImplementedError):
        varstencil.var_smooth(u.double(), b.double(), coef.double(), 64, 1)
    assert kernels.launch_counts() == counts


def test_var_kernel_path_solve_matches_plain_path(gen):
    """From a random right-hand side, the kernel path and the plain operator
    path (which evaluates the operator in another order) agree to float32
    roundoff while the residual is far above the float32 floor: two cycles
    (by the third the difference grows past 1e-3, by the fourth to 8 %,
    measured on the card)."""
    cfg = tmg.MultigridConfig(finest_level=9, coarsest_level=5, nu1=1, nu2=1,
                              smoother="rbgs", use_kernels=True)
    coef = lambda x, y: 1.0 + 10.0 * torch.exp(  # noqa: E731
        -((x - 0.4) ** 2 + (y - 0.6) ** 2) * 20)
    prob = tmg.DiffusionProblem(cfg, coefficient=coef, device="cuda",
                                align=256, min_pad_level=0)
    b = _interior(prob.finest.S, prob.finest.n, gen)
    kernels.reset_launch_counts()
    rk = tmg.solve_fixed(prob.hierarchy, cfg, b, 4)
    counts = kernels.launch_counts()
    assert counts["var_smooth_restrict_fused"] == 4 * 4
    assert counts["var_prolong_smooth_fused"] == 4 * 3
    assert counts["var_prolong_smooth_resnorm"] == 4
    rp = tmg.solve_fixed(prob.hierarchy, dataclasses.replace(
        cfg, use_kernels=False), b, 4)
    assert kernels.launch_counts() == counts
    torch.testing.assert_close(rk.res_history[:3], rp.res_history[:3],
                               rtol=1e-3, atol=0)
    assert rk.res_history[3] < 1e-2 * rk.res_history[0]
