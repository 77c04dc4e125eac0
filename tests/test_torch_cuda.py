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


# ---------------------------------------------------------------------------
# The 3D kernels: the streaming smoother, K1_3 and K2_3
# ---------------------------------------------------------------------------

def _interior3(shape, n, gen, scale=1.0):
    a = torch.zeros(shape, device="cuda")
    a[1:n, 1:n, 1:n] = scale * torch.randn((n - 1,) * 3, generator=gen,
                                           device="cuda")
    return a


# (fine shape, coarse shape, n): one window's worth of tiles (levels 5 -> 4),
# and grids of many tiles with a padded x side (levels 7 -> 6 and 8 -> 7).
PAIRS3 = [((48, 48, 128), (32, 32, 128), 32),
          ((144, 144, 256), (80, 80, 128), 128),
          ((272, 272, 384), (144, 144, 256), 256)]
SMOOTHERS3 = [("jacobi", ops.chebyshev_omegas(3, 0.4), 3),
              ("jacobi", ops.chebyshev_omegas(2, 0.4), 2),
              ("rbgs", 1.0, 1)]


@pytest.mark.parametrize("shape,shape_c,n", PAIRS3)
@pytest.mark.parametrize("sm,om,sweeps", SMOOTHERS3)
def test_stencil3d_matches_plain_bitwise(gen, shape, shape_c, n, sm, om,
                                         sweeps):
    from tpu_multigrid_torch.kernels import stencil3d as K3
    u, b = _interior3(shape, n, gen), _interior3(shape, n, gen)
    if sm == "rbgs":
        got = [K3.rbgs_sweeps3(u, b, n, sweeps),
               *K3.rbgs_sweeps_residual3(u, b, n, sweeps)]
        want = [K3.rbgs_sweeps3_plain(u, b, n, sweeps),
                *K3.rbgs_sweeps_residual3_plain(u, b, n, sweeps)]
    else:
        got = [K3.jacobi_sweeps3(u, b, n, om, sweeps),
               *K3.jacobi_sweeps_residual3(u, b, n, om, sweeps)]
        want = [K3.jacobi_sweeps3_plain(u, b, n, om, sweeps),
                *K3.jacobi_sweeps_residual3_plain(u, b, n, om, sweeps)]
    got.append(K3.residual3(u, b, n))
    want.append(K3.residual3_plain(u, b, n))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_stencil3d_deep_smoothing_splits_launches(gen):
    from tpu_multigrid_torch.kernels import _build
    from tpu_multigrid_torch.kernels import stencil3d as K3
    shape, n = (80, 80, 128), 64
    u, b = _interior3(shape, n, gen), _interior3(shape, n, gen)
    chunk = _build.lib().stencil3d_max_steps
    om = ops.chebyshev_omegas(10, 0.4)
    kernels.reset_launch_counts()
    assert torch.equal(K3.jacobi_sweeps3(u, b, n, om, 10),
                       K3.jacobi_sweeps3_plain(u, b, n, om, 10))
    got = K3.rbgs_sweeps_residual3(u, b, n, 5)
    want = K3.rbgs_sweeps_residual3_plain(u, b, n, 5)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    counts = kernels.launch_counts()
    assert counts["jacobi_sweeps3"] == -(-10 // chunk)
    assert counts["rbgs_sweeps_residual3"] == -(-10 // chunk)


@pytest.mark.parametrize("shape,shape_c,n", PAIRS3)
@pytest.mark.parametrize("sm,om,sweeps", SMOOTHERS3)
@pytest.mark.parametrize("stencil", [None, "19"])
def test_k1_3_k2_3_match_plain(gen, shape, shape_c, n, sm, om, sweeps,
                               stencil):
    from tpu_multigrid_torch.core.operators import Const19Op
    from tpu_multigrid_torch.kernels import transfer3d as T3
    st = Const19Op.STENCIL27 if stencil else None
    u, b = _interior3(shape, n, gen), _interior3(shape, n, gen)
    ec = _interior3(shape_c, n // 2, gen)
    ku, krc = T3.smooth_restrict3(u, b, n, shape_c, sweeps, sm, om, st)
    pu, prc = T3.smooth_restrict3_plain(u, b, n, shape_c, sweeps, sm, om, st)
    assert torch.equal(ku, pu) and torch.equal(krc, prc)
    args = (u, b, ec, n, sweeps, sm, om, st)
    want = T3.prolong_smooth3_plain(*args)
    assert torch.equal(T3.prolong_smooth3(*args), want)
    kv, knorm = T3.prolong_smooth_resnorm3(*args)
    _, pnorm = T3.prolong_smooth_resnorm3_plain(*args)
    assert torch.equal(kv, want)
    torch.testing.assert_close(knorm, pnorm, rtol=1e-5, atol=0)
    assert torch.equal(T3.prolong_smooth_resnorm3(*args)[1], knorm)


def test_3d_bad_inputs_raise(gen):
    from tpu_multigrid_torch.kernels import transfer3d as T3
    shape, shape_c, n = PAIRS3[0]
    u, b = _interior3(shape, n, gen), _interior3(shape, n, gen)
    with pytest.raises(ValueError):   # more per-step weights than a launch
        T3.smooth_restrict3(u, b, n, shape_c, 17, "jacobi",
                            ops.chebyshev_omegas(17, 0.4))
    with pytest.raises(ValueError):   # the coarse grid misses S/2
        T3.smooth_restrict3(u, b, n, (16, 16, 128), 1)
    with pytest.raises(ValueError):
        T3.prolong_smooth3(u, b, u.cpu(), n, 1)


def test_3d_kernel_path_solve_matches_plain_path(gen):
    """solve_poisson3d(7) on the kernels and on the plain operators (the
    jnp order): equal launch counts to the CPU spies, histories to rtol
    1e-3 above the f32 floor."""
    cfg = tmg.MultigridConfig(finest_level=7, smoother="chebyshev", nu1=3,
                              nu2=2, use_kernels=True)
    kernels.reset_launch_counts()
    rk = tmg.solve_poisson3d(7, config=cfg, num_cycles=3, device="cuda")
    counts = kernels.launch_counts()
    want = dict.fromkeys(counts, 0)
    want.update(smooth_restrict3=3, prolong_smooth_resnorm3=3,
                jacobi_sweeps_residual3=9, jacobi_sweeps3=9)
    assert counts == want
    rp = tmg.solve_poisson3d(7, config=dataclasses.replace(
        cfg, use_kernels=False), num_cycles=3, device="cuda")
    assert kernels.launch_counts() == counts
    torch.testing.assert_close(rk.res_history[:3], rp.res_history[:3],
                               rtol=1e-3, atol=0)


# Depths whose halo outgrows the 3D window: RB-GS (5, 5) and Chebyshev 10
# split K1_3 only, RB-GS 6 and Chebyshev 14 K2_3 as well.
DEEP3 = [("rbgs", 1.0, 5), ("jacobi", ops.chebyshev_omegas(10, 0.4), 10),
         ("rbgs", 1.0, 6), ("jacobi", ops.chebyshev_omegas(14, 0.4), 14)]


@pytest.mark.parametrize("sm,om,sweeps", DEEP3)
@pytest.mark.parametrize("stencil", [None, "19"])
def test_k1_3_k2_3_deep_depths_split_bitwise(gen, sm, om, sweeps, stencil):
    from tpu_multigrid_torch.core.operators import Const19Op
    from tpu_multigrid_torch.kernels import _build
    from tpu_multigrid_torch.kernels import transfer3d as T3
    st = Const19Op.STENCIL27 if stencil else None
    shape, shape_c, n = PAIRS3[1]
    u, b = _interior3(shape, n, gen), _interior3(shape, n, gen)
    ec = _interior3(shape_c, n // 2, gen)
    kernels.reset_launch_counts()
    ku, krc = T3.smooth_restrict3(u, b, n, shape_c, sweeps, sm, om, st)
    pu, prc = T3.smooth_restrict3_plain(u, b, n, shape_c, sweeps, sm, om, st)
    assert torch.equal(ku, pu) and torch.equal(krc, prc)
    args = (u, b, ec, n, sweeps, sm, om, st)
    want = T3.prolong_smooth3_plain(*args)
    assert torch.equal(T3.prolong_smooth3(*args), want)
    kv, knorm = T3.prolong_smooth_resnorm3(*args)
    _, pnorm = T3.prolong_smooth_resnorm3_plain(*args)
    assert torch.equal(kv, want)
    torch.testing.assert_close(knorm, pnorm, rtol=1e-5, atol=0)
    steps = 2 * sweeps if sm == "rbgs" else sweeps
    halo, ws = _build.lib().window3_max_halo, (1.0,)
    counts = kernels.launch_counts()
    assert counts["smooth_restrict3"] == len(T3.split_plan(steps, 2, halo,
                                                           ws))
    assert counts["prolong_smooth3"] == len(T3.split_plan(steps, 0, halo, ws))
    assert counts["prolong_smooth_resnorm3"] == len(
        T3.split_plan(steps, 1, halo, ws))
    assert counts["smooth_restrict3"] >= 2


# ---------------------------------------------------------------------------
# The 3D variable-coefficient kernels: K1v_3 and K2v_3
# ---------------------------------------------------------------------------

def _planes3(nplanes, shape, gen):
    """Positive coefficient planes from the seed (a diagonally dominant
    operator for 6 planes too)."""
    return 0.5 + torch.rand((nplanes,) + shape, generator=gen, device="cuda")


@pytest.mark.parametrize("nplanes", [3, 4, 6])
@pytest.mark.parametrize("sm,om,sweeps", SMOOTHERS3
                         + [("jacobi", ops.chebyshev_omegas(14, 0.4), 14),
                            ("rbgs", 1.0, 6)])
def test_var3_kernels_match_plain_bitwise(gen, nplanes, sm, om, sweeps):
    from tpu_multigrid_torch.kernels import vartransfer3d as VT3
    shape, shape_c, n = PAIRS3[1]
    u, b = _interior3(shape, n, gen), _interior3(shape, n, gen)
    ec = _interior3(shape_c, n // 2, gen)
    coef = _planes3(nplanes, shape, gen)
    ku, krc = VT3.var_smooth_restrict3(u, b, coef, n, shape_c, sweeps, sm, om)
    pu, prc = VT3.var_smooth_restrict3_plain(u, b, coef, n, shape_c, sweeps,
                                             sm, om)
    assert torch.equal(ku, pu) and torch.equal(krc, prc)
    args = (u, b, ec, coef, n, sweeps, sm, om)
    want = VT3.var_prolong_smooth3_plain(*args)
    assert torch.equal(VT3.var_prolong_smooth3(*args), want)
    kv, knorm = VT3.var_prolong_smooth_resnorm3(*args)
    _, pnorm = VT3.var_prolong_smooth_resnorm3_plain(*args)
    assert torch.equal(kv, want)
    torch.testing.assert_close(knorm, pnorm, rtol=1e-5, atol=0)
    assert torch.equal(VT3.var_prolong_smooth_resnorm3(*args)[1], knorm)


def test_var3_kernel_path_solve_matches_plain_path(gen):
    """solve_diffusion3d(7) on the kernels (K1v_3 / K2v_3 on the pair 7 ->
    6) and on the plain operators: exact launch counts, histories to rtol
    1e-3."""
    cfg = tmg.MultigridConfig(finest_level=7, smoother="chebyshev", nu1=3,
                              nu2=2, use_kernels=True)
    a = lambda x, y, z: 1 + x + 2 * y + z  # noqa: E731
    kernels.reset_launch_counts()
    rk = tmg.solve_diffusion3d(7, coefficient=a, config=cfg, num_cycles=3,
                               device="cuda")
    counts = kernels.launch_counts()
    want = dict.fromkeys(counts, 0)
    want.update(var_smooth_restrict3=3, var_prolong_smooth_resnorm3=3)
    assert counts == want
    rp = tmg.solve_diffusion3d(7, coefficient=a, config=dataclasses.replace(
        cfg, use_kernels=False), num_cycles=3, device="cuda")
    assert kernels.launch_counts() == counts
    torch.testing.assert_close(rk.res_history, rp.res_history, rtol=1e-3,
                               atol=0)
