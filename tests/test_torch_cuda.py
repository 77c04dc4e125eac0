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
    lib, ws = _build.lib(), (1.0,)
    halo = lib.window3_max_halo
    counts = kernels.launch_counts()
    assert counts["smooth_restrict3"] == len(T3.k1_launches(lib, steps, ws,
                                                            st))
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


# ---------------------------------------------------------------------------
# The zebra kernels: the zebra_x smoother, K1z and K2z
# ---------------------------------------------------------------------------

def _zebra_planes(kind, n, S, gen):
    """(9, S, S) planes: the rotated anisotropic operator (45 degrees, eps
    1 / 0.05) or a diagonally dominant 9-point operator from a seed."""
    import math

    from tpu_multigrid_torch.problems import anisotropic
    if kind == "rotated":
        op = anisotropic.anisotropic_poisson_op(n, S, 1.0, 0.05,
                                                math.radians(45))
        return torch.from_numpy(op.coef).reshape(9, S, S).cuda()
    c = -0.25 - torch.rand((9, S, S), generator=gen, device="cuda")
    c[4] = 8.0 + torch.rand((S, S), generator=gen, device="cuda")
    return torch.where(ops.interior_mask(S, n, c.device), c, 0.0)


# (S, Sc, n): the bottom pair and a padded mid pair.
ZPAIRS = [(256, 256, 200), (1280, 768, 1024)]


@pytest.mark.parametrize("S,Sc,n", ZPAIRS)
@pytest.mark.parametrize("kind", ["rotated", "seeded"])
@pytest.mark.parametrize("sweeps", [1, 2])
def test_zebra_kernels_match_plain_bitwise(gen, S, Sc, n, kind, sweeps):
    from tpu_multigrid_torch.kernels import lines as Z
    coef = _zebra_planes(kind, n, S, gen)
    u, b = _interior(S, n, gen), _interior(S, n, gen)
    ec = _interior(Sc, n // 2, gen)
    assert torch.equal(Z.zebra_sweeps(u, b, coef, n, sweeps),
                       Z.zebra_sweeps_plain(u, b, coef, n, sweeps))
    for got, want in zip(Z.zebra_smooth_restrict(u, b, coef, n, Sc, sweeps),
                         Z.zebra_smooth_restrict_plain(u, b, coef, n, Sc,
                                                       sweeps)):
        assert torch.equal(got, want)
    args = (u, b, ec, coef, n, sweeps)
    want = Z.prolong_zebra_smooth_plain(*args)
    assert torch.equal(Z.prolong_zebra_smooth(*args), want)
    ku, knorm = Z.prolong_zebra_smooth_resnorm(*args)
    _, pnorm = Z.prolong_zebra_smooth_resnorm_plain(*args)
    assert torch.equal(ku, want)
    torch.testing.assert_close(knorm, pnorm, rtol=1e-5, atol=0)
    assert torch.equal(Z.prolong_zebra_smooth_resnorm(*args)[1], knorm)


def test_zebra_launches_are_counted_and_bad_inputs_raise(gen):
    from tpu_multigrid_torch.kernels import _build
    from tpu_multigrid_torch.kernels import lines as Z
    S, n = 256, 200
    coef = _zebra_planes("seeded", n, S, gen)
    u, b = _interior(S, n, gen), _interior(S, n, gen)
    assert _build.lib().zebra_max_line == Z._SMEM_BYTES // 16
    kernels.reset_launch_counts()
    Z.zebra_sweeps(u, b, coef, n, 2)
    Z.zebra_smooth_restrict(u, b, coef, n, S, 1)
    Z.prolong_zebra_smooth(u, b, u, coef, n, 1)
    Z.prolong_zebra_smooth_resnorm(u, b, u, coef, n, 3)
    counts = kernels.launch_counts()
    assert {k: v for k, v in counts.items() if v} == {
        "zebra_sweeps": 4, "zebra_smooth_restrict": 3,
        "prolong_zebra_smooth": 3, "prolong_zebra_smooth_resnorm": 9}
    with pytest.raises(ValueError):
        Z.zebra_sweeps(u, b, coef.cpu(), n, 1)
    with pytest.raises(ValueError):
        Z.zebra_sweeps(u[:200, :200].contiguous(), b[:200, :200].contiguous(),
                       coef[:, :200, :200].contiguous(), n, 1)
    with pytest.raises(ValueError):
        Z.zebra_smooth_restrict(u, b, coef, n, 64, 1)
    with pytest.raises(NotImplementedError):
        Z.zebra_sweeps(u.double(), b.double(), coef.double(), n, 1)
    assert kernels.launch_counts() == counts


def zebra_path_launches(hier, cycles, sweeps=1):
    """Launches of ``cycles`` cycles of the zebra_x path (nu1 = nu2 =
    ``sweeps``): K1z and K2z on each pair the fused gate takes (K2z-resnorm
    on the finest), else the zebra smoother before and after, the
    restriction and the prolong-add kernels."""
    from tpu_multigrid_torch.kernels import lines as Z
    want = {}

    def add(name, k):
        want[name] = want.get(name, 0) + cycles * k
    for k, (op, opc) in enumerate(zip(hier.levels, hier.levels[1:])):
        if Z.supported_zebra_fused(op.S, opc.S, sweeps, torch.float32):
            add("zebra_smooth_restrict",
                Z.launches("zebra_smooth_restrict", sweeps))
            k2 = "prolong_zebra_smooth_resnorm" if k == 0 \
                else "prolong_zebra_smooth"
            add(k2, Z.launches(k2, sweeps))
        else:
            add("zebra_sweeps", 2 * Z.launches("zebra_sweeps", sweeps))
            add("restrict_fw", 1)
            add("prolong_add", 1)
    return want


def test_zebra_kernel_path_solve_matches_plain_path(gen):
    """solve_fixed at level 9, 45 degrees, zebra (1, 1), from a random
    right-hand side: the pairs 768 -> 512 and 256 -> 256 fuse, 512 -> 256
    (Sc < S/2 + 128) runs the zebra smoother and the transfer kernels;
    exact launch counts, and histories to rtol 1e-3 over the first
    cycles."""
    import math
    cfg = tmg.MultigridConfig(finest_level=9, coarsest_level=3,
                              smoother="zebra_x", nu1=1, nu2=1,
                              use_kernels=True)
    prob = tmg.AnisotropicPoissonProblem(cfg, eps_x=1.0, eps_y=0.05,
                                         angle=math.radians(45),
                                         device="cuda", align=256,
                                         min_pad_level=0)
    b = _interior(prob.finest.S, prob.finest.n, gen)
    kernels.reset_launch_counts()
    rk = tmg.solve_fixed(prob.hierarchy, cfg, b, 4)
    counts = kernels.launch_counts()
    want = dict.fromkeys(counts, 0)
    want.update(zebra_path_launches(prob.hierarchy, 4))
    assert want["zebra_sweeps"] == 4 * 4 and want["restrict_fw"] == 4
    assert counts == want
    rp = tmg.solve_fixed(prob.hierarchy, dataclasses.replace(
        cfg, use_kernels=False), b, 4)
    assert kernels.launch_counts() == counts
    torch.testing.assert_close(rk.res_history[:3], rp.res_history[:3],
                               rtol=1e-3, atol=0)
    assert rk.res_history[4] < 0.1 * rk.res_history[0]


# ---------------------------------------------------------------------------
# The FAS kernels: K1f, K2f (2D) and K1f_3, K2f_3 (3D)
# ---------------------------------------------------------------------------

def _fas_args(family):
    """The nonlinearity arguments of the fas_* (Bratu, lam = 4) or qfas_*
    (a = 1 + 2 u^2) entries, and the entry prefix."""
    from tpu_multigrid_torch.core.nonlinear import (BratuNonlinearity,
                                                    QuadraticCoefficient)
    if family == "bratu":
        phi = BratuNonlinearity(4.0)
        return "fas_", (phi, phi)
    return "qfas_", (QuadraticCoefficient(2.0),)


def _fas_call(mod, prefix, name, args, nl, h2, diag):
    """Call entry ``prefix + name`` of ``mod``; the pointwise entries also
    take (h2, diag)."""
    extra = (h2, diag) if prefix == "fas_" else ()
    return getattr(mod, prefix + name)(*args, *nl, *extra)


# (S, Sc, n): the bottom pair, a multi-tile pair, a padded odd-sized pair.
FAS_PAIRS = [(256, 256, 64), (768, 512, 512), (1280, 768, 1000)]


@pytest.mark.parametrize("S,Sc,n", FAS_PAIRS)
@pytest.mark.parametrize("family", ["bratu", "quadratic"])
@pytest.mark.parametrize("sweeps", [1, 2, 3])
def test_fas_kernels_match_plain_bitwise(gen, S, Sc, n, family, sweeps):
    """K1f, K2f and K2f-resnorm against their plain versions on the same
    CUDA tensors, u at scale 0.1: bitwise (the norm to rtol 1e-4)."""
    from tpu_multigrid_torch.kernels import fas as KF
    prefix, nl = _fas_args(family)
    u, b = _interior(S, n, gen, 0.1), _interior(S, n, gen)
    ec = _interior(Sc, n // 2, gen, 0.05)
    h2 = (1.0 / n) ** 2
    a1 = (u, b, n, Sc, sweeps, 2.0 / 3.0)
    got = _fas_call(KF, prefix, "smooth_restrict", a1, nl, h2, 4.0)
    want = _fas_call(KF, prefix, "smooth_restrict_plain", a1, nl, h2, 4.0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    a2 = (u, b, ec, n, sweeps, 2.0 / 3.0)
    want = _fas_call(KF, prefix, "prolong_smooth_plain", a2, nl, h2, 4.0)
    assert torch.equal(_fas_call(KF, prefix, "prolong_smooth", a2, nl, h2,
                                 4.0), want)
    kv, knorm = _fas_call(KF, prefix, "prolong_smooth_resnorm", a2, nl, h2,
                          4.0)
    pv, pnorm = _fas_call(KF, prefix, "prolong_smooth_resnorm_plain", a2, nl,
                          h2, 4.0)
    assert torch.equal(kv, want) and torch.equal(pv, want)
    torch.testing.assert_close(knorm, pnorm, rtol=1e-4, atol=0)


FAS_PAIRS3 = [((48, 48, 128), (32, 32, 128), 32),
              ((144, 144, 256), (80, 80, 128), 128)]


@pytest.mark.parametrize("shape,shape_c,n", FAS_PAIRS3)
@pytest.mark.parametrize("family", ["bratu", "quadratic"])
@pytest.mark.parametrize("sweeps", [1, 2, 3, 10])
def test_fas3_kernels_match_plain_bitwise(gen, shape, shape_c, n, family,
                                          sweeps):
    """K1f_3, K2f_3 and K2f_3-resnorm against their plain versions: bitwise
    (the norm to rtol 1e-4); 10 sweeps split into launches."""
    from tpu_multigrid_torch.kernels import _build
    from tpu_multigrid_torch.kernels import fas3d as KF3
    from tpu_multigrid_torch.kernels import transfer3d as T3
    prefix, nl = _fas_args(family)
    u, b = _interior3(shape, n, gen, 0.1), _interior3(shape, n, gen)
    ec = _interior3(shape_c, n // 2, gen, 0.05)
    h2 = (1.0 / n) ** 2
    kernels.reset_launch_counts()
    a1 = (u, b, n, shape_c, sweeps, 2.0 / 3.0)
    got = _fas_call(KF3, prefix, "smooth_restrict3", a1, nl, h2, 6.0)
    want = _fas_call(KF3, prefix, "smooth_restrict3_plain", a1, nl, h2, 6.0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    a2 = (u, b, ec, n, sweeps, 2.0 / 3.0)
    want = _fas_call(KF3, prefix, "prolong_smooth3_plain", a2, nl, h2, 6.0)
    assert torch.equal(_fas_call(KF3, prefix, "prolong_smooth3", a2, nl, h2,
                                 6.0), want)
    kv, knorm = _fas_call(KF3, prefix, "prolong_smooth_resnorm3", a2, nl, h2,
                          6.0)
    _, pnorm = _fas_call(KF3, prefix, "prolong_smooth_resnorm3_plain", a2,
                         nl, h2, 6.0)
    assert torch.equal(kv, want)
    torch.testing.assert_close(knorm, pnorm, rtol=1e-4, atol=0)
    halo = _build.lib().window3_max_halo
    counts = kernels.launch_counts()
    plans = {"smooth_restrict3": 2, "prolong_smooth3": 0,
             "prolong_smooth_resnorm3": 1}
    for name, extra in plans.items():
        assert counts[prefix + name] == len(
            T3.split_plan(sweeps, extra, halo, (1.0,)))
    assert (counts[prefix + "smooth_restrict3"] > 1) == (sweeps == 10)


def test_fas_launches_are_counted_and_bad_inputs_raise(gen):
    """One launch per 2D call; a caller's own nonlinearity, CPU operands,
    float64 and a coarse grid short of S/2 raise, launching nothing."""
    from tpu_multigrid_torch.kernels import fas as KF
    from tpu_multigrid_torch.kernels import fas3d as KF3
    S, Sc, n = FAS_PAIRS[0]
    _, (phi, _) = _fas_args("bratu")
    _, (a,) = _fas_args("quadratic")
    u, b = _interior(S, n, gen, 0.1), _interior(S, n, gen)
    h = (1.0 / n) ** 2
    kernels.reset_launch_counts()
    KF.fas_smooth_restrict(u, b, n, Sc, 2, 2 / 3, phi, phi, h)
    KF.fas_prolong_smooth(u, b, u, n, 2, 2 / 3, phi, phi, h)
    KF.fas_prolong_smooth_resnorm(u, b, u, n, 2, 2 / 3, phi, phi, h)
    KF.qfas_smooth_restrict(u, b, n, Sc, 2, 2 / 3, a)
    KF.qfas_prolong_smooth(u, b, u, n, 2, 2 / 3, a)
    KF.qfas_prolong_smooth_resnorm(u, b, u, n, 2, 2 / 3, a)
    counts = kernels.launch_counts()
    assert {k: v for k, v in counts.items() if v} == dict.fromkeys(
        KF.LAUNCHES, 1)
    own = lambda x: -4.0 * torch.exp(x)  # noqa: E731
    with pytest.raises(ValueError, match="carries only"):
        KF.fas_smooth_restrict(u, b, n, Sc, 2, 2 / 3, own, own, h)
    with pytest.raises(ValueError, match="carries only"):
        KF.fas_prolong_smooth(u, b, u, n, 2, 2 / 3, phi, own, h)
    with pytest.raises(ValueError, match="carries only"):
        KF.qfas_smooth_restrict(u, b, n, Sc, 2, 2 / 3, lambda x: 1 + x * x)
    with pytest.raises(ValueError, match="carries only"):
        u3 = torch.zeros((48, 48, 128), device="cuda")
        KF3.fas_smooth_restrict3(u3, u3, 32, (32, 32, 128), 2, 2 / 3, own,
                                 own, h)
    with pytest.raises(ValueError):
        KF.fas_smooth_restrict(u, b.cpu(), n, Sc, 2, 2 / 3, phi, phi, h)
    with pytest.raises(ValueError):
        KF.fas_smooth_restrict(u, b, n, 64, 2, 2 / 3, phi, phi, h)
    with pytest.raises(NotImplementedError):
        KF.fas_smooth_restrict(u.double(), b.double(), n, Sc, 2, 2 / 3, phi,
                               phi, h)
    assert kernels.launch_counts() == counts


def test_fas_kernel_path_solve_matches_plain_path(gen):
    """solve_bratu(9) and solve_quasilinear_diffusion(9) on the kernels and
    on the plain operators: exact launch counts (every pair of the padded
    levels 9 -> 3 fuses), the same iteration counts within 1, histories to
    rtol 1e-3 over the first cycles."""
    for door, kw in ((tmg.solve_bratu, dict(lam=4.0)),
                     (tmg.solve_quasilinear_diffusion, dict(gamma=2.0))):
        prefix = "fas_" if door is tmg.solve_bratu else "qfas_"
        kernels.reset_launch_counts()
        rk = door(9, tol=1e-5, device="cuda", **kw)
        counts = kernels.launch_counts()
        it = rk.iterations
        want = dict.fromkeys(counts, 0)
        want.update({prefix + "smooth_restrict": 6 * it,
                     prefix + "prolong_smooth": 5 * it,
                     prefix + "prolong_smooth_resnorm": it})
        assert counts == want
        cfg = tmg.MultigridConfig(finest_level=9, use_kernels=False)
        if door is tmg.solve_quasilinear_diffusion:
            cfg = dataclasses.replace(cfg, coarse_solver="smooth",
                                      coarse_smooth_sweeps=40)
        rp = door(9, tol=1e-5, config=cfg, device="cuda", **kw)
        assert kernels.launch_counts() == counts
        assert abs(rp.iterations - it) <= 1
        torch.testing.assert_close(rk.res_history[:3], rp.res_history[:3],
                                   rtol=1e-3, atol=0)


# ---------------------------------------------------------------------------
# K1-local and K2-local (kernels/local.py) and the periodic fused tier
# ---------------------------------------------------------------------------

# (R, C) blocks: the smallest the gate takes, and a 512^2 shard's.  Origins:
# the fused tier's (2, 2) with its virtual n, and the top-left shard of a
# 2 x 2 decomposed grid, whose ghosts lie outside the grid.
LOCAL_BLOCKS = [(288, 768), (544, 1024)]
LOCAL_SMOOTHERS = [("jacobi", ops.chebyshev_omegas(3, 0.4), 3),
                   ("jacobi", 2.0 / 3.0, 1), ("rbgs", 2.0 / 3.0, 1),
                   ("rbgs", 2.0 / 3.0, 6)]


@pytest.mark.parametrize("R,C", LOCAL_BLOCKS)
@pytest.mark.parametrize("fused_origin", [True, False])
@pytest.mark.parametrize("smoother,omega,sweeps", LOCAL_SMOOTHERS)
def test_local_kernels_match_plain_bitwise(gen, R, C, fused_origin,
                                           smoother, omega, sweeps):
    from tpu_multigrid_torch.kernels import local
    origin, n = ((2, 2), 1 << 30) if fused_origin else ((-16, -256),
                                                        2 * (R - 32))
    u = torch.randn((R, C), generator=gen, device="cuda")
    b = torch.randn((R, C), generator=gen, device="cuda")
    ec = torch.randn(local.coarse_shape(R, C), generator=gen, device="cuda")
    ku, krc = local.smooth_restrict_ext(u, b, origin, n, sweeps, smoother,
                                        omega)
    pu, prc = local.smooth_restrict_ext_plain(u, b, origin, n, sweeps,
                                              smoother, omega)
    assert torch.equal(ku, pu) and torch.equal(krc, prc)
    args = (u, b, ec, origin, n, sweeps, smoother, omega)
    want = local.prolong_smooth_ext_plain(*args)
    assert torch.equal(local.prolong_smooth_ext(*args), want)
    ku2, kss = local.prolong_smooth_ext(*args, want_resnorm=True)
    _, pss = local.prolong_smooth_ext_resnorm_plain(*args)
    assert torch.equal(ku2, want)
    torch.testing.assert_close(kss, pss, rtol=1e-5, atol=0)
    assert torch.equal(local.prolong_smooth_ext(*args, want_resnorm=True)[1],
                       kss)


def test_periodic_kernel_route_launches_and_matches_plain_route(gen):
    """solve_poisson(10, bc="periodic") on the fused tier: 1024^2, 512^2
    and 256^2 fuse (coarsest level 5), so each V-cycle launches K1-local 3
    times, K2-local twice and K2-local-resnorm once; the protocol route
    launches nothing and takes the same iterations within 1.  tol 1e-2:
    the float32 floor of this h^2-scaled right-hand side is ~3e-3 of r0 at
    level 10."""
    import math

    def forcing(x, y):
        return (8 * math.pi ** 2 * torch.sin(2 * math.pi * x)
                * torch.cos(2 * math.pi * y))
    cfg = tmg.MultigridConfig(finest_level=10, coarsest_level=5,
                              smoother="chebyshev", nu1=3, nu2=2,
                              use_kernels=True)
    kernels.reset_launch_counts()
    rk = tmg.solve_poisson(10, bc="periodic", forcing=forcing, config=cfg,
                           tol=1e-2, device="cuda")
    counts = kernels.launch_counts()
    it = rk.iterations
    want = dict.fromkeys(counts, 0)
    want.update({"smooth_restrict_ext": 3 * it, "prolong_smooth_ext": 2 * it,
                 "prolong_smooth_ext_resnorm": it})
    assert counts == want and rk.converged
    assert rk.u.shape == (1024, 1024)
    assert abs(float(rk.u.mean())) < 1e-6 * float(rk.u.abs().max())
    rp = tmg.solve_poisson(10, bc="periodic", forcing=forcing, tol=1e-2,
                           config=dataclasses.replace(cfg, use_kernels=False),
                           device="cuda")
    assert kernels.launch_counts() == counts
    assert abs(rp.iterations - it) <= 1
    torch.testing.assert_close(rk.res_history[:3], rp.res_history[:3],
                               rtol=3e-3, atol=0)


# ---------------------------------------------------------------------------
# The distributed refinement's kernels (kernels/local.py K0-local,
# kernels/localref.py)
# ---------------------------------------------------------------------------

def test_dist_refinement_kernels_match_plain_bitwise(gen):
    """smooth_ext, residual_ext, ds/ts_residual_ext, prolong_pair_ext and
    comp_add_ext bitwise against their plain versions over the whole
    arrays, at a 2 x 2 shard block of a 1024^2 grid, its four origins."""
    from tpu_multigrid_torch.kernels import local, localref
    R, C, n = 544, 1024, 1000
    lr, lc = R - 32, C - 512
    u, b = (torch.randn((R, C), generator=gen, device="cuda")
            for _ in range(2))
    um = 1e-8 * torch.randn((R, C), generator=gen, device="cuda")
    ul = 1e-15 * torch.randn((R, C), generator=gen, device="cuda")
    ech = torch.randn(local.coarse_shape(R, C), generator=gen, device="cuda")
    ecl = 1e-8 * torch.randn(local.coarse_shape(R, C), generator=gen,
                             device="cuda")
    for origin in [(-16, -256), (lr - 16, -256), (-16, lc - 256),
                   (lr - 16, lc - 256)]:
        for sm, om, sw in LOCAL_SMOOTHERS:
            assert torch.equal(
                local.smooth_ext(u, b, origin, n, sw, sm, om),
                local.smooth_ext_plain(u, b, origin, n, sw, sm, om))
        assert torch.equal(local.residual_ext(u, b, origin, n),
                           local.residual_ext_plain(u, b, origin, n))
        assert torch.equal(
            localref.ds_residual_ext(b, u, um, origin, n),
            localref.ds_residual_ext_plain(b, u, um, origin, n))
        assert torch.equal(
            localref.ts_residual_ext(b, u, um, ul, origin, n),
            localref.ts_residual_ext_plain(b, u, um, ul, origin, n))
        for k, p in zip(localref.prolong_pair_ext(ech, ecl, origin, n),
                        localref.prolong_pair_ext_plain(ech, ecl, origin,
                                                        n)):
            assert torch.equal(k, p)
    for comps in ([u, um], [u, um, ul]):
        for ys in ([b], [b, um]):
            got = [c.clone() for c in comps]
            want = [c.clone() for c in comps]
            assert localref.comp_add_ext(got, ys)[0] is got[0]
            localref.comp_add_ext_plain(want, ys)
            assert all(torch.equal(g, w) for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# The distributed FAS tier's kernels (kernels/localfas.py) and its mesh route
# ---------------------------------------------------------------------------

def _dfas_calls(family, u, b, ec, origin, n, sweeps):
    """[(name, kernel call, plain call)] of a family's K1f-local, K2f-local
    and K2f-local-resnorm."""
    from tpu_multigrid_torch.kernels import localfas
    if family == "bratu":
        phi = tmg.BratuNonlinearity(4.0)
        nl, pre = (phi, phi, (1.0 / n) ** 2), "fas_"
    else:
        nl, pre = (tmg.QuadraticCoefficient(2.0),), "qfas_"
    k1 = (u, b, origin, n, sweeps, 2.0 / 3.0) + nl
    k2 = (u, b, ec, origin, n, sweeps, 2.0 / 3.0) + nl
    out = [(pre + "smooth_restrict_ext", k1, {})]
    out += [(pre + "prolong_smooth_ext", k2, dict(want_resnorm=w))
            for w in (False, True)]
    return [(name, lambda f=getattr(localfas, name), a=a, kw=kw: f(*a, **kw),
             lambda f=getattr(localfas, name + "_plain"), a=a, kw=kw:
             f(*a, **kw)) for name, a, kw in out]


@pytest.mark.parametrize("R,C,n", [(544, 1024, 1000), (288, 768, 500)])
@pytest.mark.parametrize("family", ["bratu", "quadratic"])
def test_dist_fas_kernels_match_plain_bitwise(gen, R, C, n, family):
    """K1f-local's (u', uc0, bc), K2f-local and K2f-local-resnorm bitwise
    against their plain versions over the whole arrays (the owned sum of
    squares to rtol 1e-5), random ghosts included, 1-3 sweeps, at two
    2 x 2 shard blocks and their four origins."""
    from tpu_multigrid_torch.kernels import local
    lr, lc = R - 32, C - 512
    u = 0.1 * torch.randn((R, C), generator=gen, device="cuda")
    b = torch.randn((R, C), generator=gen, device="cuda")
    ec = 0.05 * torch.randn(local.coarse_shape(R, C), generator=gen,
                            device="cuda")
    for origin in [(-16, -256), (lr - 16, -256), (-16, lc - 256),
                   (lr - 16, lc - 256)]:
        for sweeps in (1, 2, 3):
            for name, kern, plain in _dfas_calls(family, u, b, ec, origin,
                                                 n, sweeps):
                got, want = kern(), plain()
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                for g, w in zip(got, want):
                    if g.dim() == 0:
                        torch.testing.assert_close(g, w, rtol=1e-5, atol=0)
                    else:
                        assert torch.equal(g, w), (name, origin, sweeps)


def test_dist_fas_kernels_refuse_what_they_do_not_take(gen):
    """A caller's own nonlinearity and a block outside the gate raise on the
    card; nothing runs plain there."""
    from tpu_multigrid_torch.kernels import localfas
    u = torch.zeros((288, 768), device="cuda")
    cubic = lambda x: x * x * x          # noqa: E731
    with pytest.raises(ValueError, match="carries only"):
        localfas.fas_smooth_restrict_ext(u, u, (0, 0), 500, 2, 0.5, cubic,
                                         cubic, 1e-6)
    with pytest.raises(ValueError, match="carries only"):
        localfas.qfas_prolong_smooth_ext(u, u, u, (0, 0), 500, 2, 0.5,
                                         lambda x: 1.0 + x * x)
    with pytest.raises(ValueError, match="fas_supported_local"):
        localfas.qfas_smooth_restrict_ext(u[:280], u[:280], (0, 0), 500, 2,
                                          0.5, tmg.QuadraticCoefficient(1.0))


@pytest.mark.parametrize("level", [8, 9])
def test_dist_fas_mesh_route_launches(gen, tmp_path, monkeypatch, level):
    """solve_bratu(level, mesh=..., dist_path="pallas") on a one-rank NCCL
    group (two sharded levels at level 8, one at level 9): exactly one
    K1f-local per sharded level and one K2f-local per sharded level but the
    finest, whose K2f-local-resnorm runs once a cycle; the iterate bitwise
    equal, and the history within rtol 1e-5 (the norm's sum in another
    order), to the same solve on the card with the kernels' plain versions
    in their place; a caller's own phi raises on the card."""
    import os
    import torch.distributed as tdist
    from tpu_multigrid_torch import dist
    from tpu_multigrid_torch.dist import pallas_cycle
    from tpu_multigrid_torch.kernels import localfas
    cfg = tmg.MultigridConfig(finest_level=level, coarsest_level=3)
    ns = pallas_cycle.pallas_level_sizes(cfg, (1, 1)).num_sharded
    assert ns == (2 if level == 8 else 1)
    tdist.init_process_group("nccl", init_method="file://" + os.path.join(
        tmp_path, "store"), world_size=1, rank=0)
    try:
        mesh = dist.make_grid_mesh((1, 1))
        kw = dict(lam=4.0, config=cfg, mesh=mesh, dist_path="pallas",
                  num_cycles=3)
        kernels.reset_launch_counts()
        res = tmg.solve_bratu(level, **kw)
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        assert counts == {"fas_smooth_restrict_ext": 3 * ns,
                          "fas_prolong_smooth_ext_resnorm": 3,
                          **({"fas_prolong_smooth_ext": 3 * (ns - 1)}
                             if ns > 1 else {})}
        for name in ("fas_smooth_restrict_ext", "fas_prolong_smooth_ext"):
            monkeypatch.setattr(localfas, name,
                                getattr(localfas, name + "_plain"))
        kernels.reset_launch_counts()
        plain = tmg.solve_bratu(level, **kw)
        assert not any(kernels.launch_counts().values())
        assert torch.equal(res.u, plain.u)
        torch.testing.assert_close(res.res_history, plain.res_history,
                                   rtol=1e-5, atol=0)
        monkeypatch.undo()
        with pytest.raises(ValueError, match="carries only"):
            tmg.solve_nonlinear_poisson(level, phi=lambda u: u * u * u,
                                        dphi=lambda u: 3.0 * u * u,
                                        config=cfg, mesh=mesh,
                                        dist_path="pallas", num_cycles=1)
    finally:
        tdist.destroy_process_group()


# ---------------------------------------------------------------------------
# The distributed 3D tier's kernels (K1_3-ext, K2_3-local and their var
# forms) and its solvers
# ---------------------------------------------------------------------------

# A (2, 2) shard block of a 64^3 grid (lz = ly = 48) and its four origins.
EXT3_SHAPE, EXT3_SHAPE_C, EXT3_N = (80, 80, 128), (56, 56, 128), 64
EXT3_ORIGINS = [(-16, -16), (32, -16), (-16, 32), (32, 32)]
# Chebyshev 3 and 2, RB-GS 1, and RB-GS 5, whose K1 splits into launches.
EXT3_SMOOTHERS = [("jacobi", ops.chebyshev_omegas(3, 0.4), 3),
                  ("jacobi", ops.chebyshev_omegas(2, 0.4), 2),
                  ("rbgs", 1.0, 1), ("rbgs", 1.0, 5)]


def _ext3_calls(u, b, ec, coef, origin, n, sm, om, sw):
    """[(name, kernel call, plain call)] of K1_3-ext, K2_3-local and
    K2_3-local-resnorm, or of their var forms on ``coef``."""
    from tpu_multigrid_torch.kernels import transfer3d as T3
    from tpu_multigrid_torch.kernels import vartransfer3d as V3
    mod, pre = (T3, "") if coef is None else (V3, "var_")
    cf = () if coef is None else (coef,)
    k1 = (u, b) + cf + (origin, n, tuple(ec.shape), sw, sm, om)
    k2 = (u, b, ec) + cf + (origin, n, sw, sm, om)
    out = [(pre + "smooth_restrict_ext3", pre + "smooth_restrict_ext3", k1,
            {})]
    out += [(pre + "prolong_smooth_ext3" + ("_resnorm" if w else ""),
             pre + "prolong_smooth_ext3", k2, dict(want_resnorm=w))
            for w in (False, True)]
    return [(name, lambda f=getattr(mod, fn), a=a, kw=kw: f(*a, **kw),
             lambda f=getattr(mod, fn + "_plain"), a=a, kw=kw: f(*a, **kw))
            for name, fn, a, kw in out]


@pytest.mark.parametrize("nplanes", [0, 3, 4, 6])
@pytest.mark.parametrize("smoother,omega,sweeps", EXT3_SMOOTHERS)
def test_dist3_kernels_match_plain_bitwise(gen, nplanes, smoother, omega,
                                           sweeps):
    """K1_3-ext (u', the whole coarse block), K2_3-local and
    K2_3-local-resnorm, and their var forms on 3, 4 and 6 planes, bitwise
    against their plain versions over the whole arrays (the owned sum of
    squares to rtol 1e-5), random ghosts, ec and coefficients, at the four
    origins of a 2 x 2 shard block; each entry counts its launches (two for
    RB-GS 5's split K1)."""
    u = torch.randn(EXT3_SHAPE, generator=gen, device="cuda")
    b = torch.randn(EXT3_SHAPE, generator=gen, device="cuda")
    ec = torch.randn(EXT3_SHAPE_C, generator=gen, device="cuda")
    coef = None
    if nplanes:
        coef = 0.5 + torch.rand((nplanes,) + EXT3_SHAPE, generator=gen,
                                device="cuda")
    for origin in EXT3_ORIGINS:
        for name, kern, plain in _ext3_calls(u, b, ec, coef, origin, EXT3_N,
                                             smoother, omega, sweeps):
            kernels.reset_launch_counts()
            got = kern()
            launched = kernels.launch_counts()[name]
            want = plain()
            assert launched == (2 if sweeps == 5 and "restrict" in name
                                else 1), (name, launched)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for g, w in zip(got, want):
                if g.dim() == 0:
                    torch.testing.assert_close(g, w, rtol=1e-5, atol=0)
                else:
                    assert torch.equal(g, w), (name, origin)


def test_dist3_kernels_refuse_what_they_do_not_take(gen):
    """A block outside the gate, an odd origin and a coarse block of another
    shape raise on the card; nothing runs plain there."""
    from tpu_multigrid_torch.kernels import transfer3d as T3
    from tpu_multigrid_torch.kernels import vartransfer3d as V3
    u = torch.zeros(EXT3_SHAPE, device="cuda")
    ec = torch.zeros(EXT3_SHAPE_C, device="cuda")
    coef = torch.ones((3,) + EXT3_SHAPE, device="cuda")
    bad = torch.zeros((80, 72, 128), device="cuda")
    with pytest.raises(ValueError, match="extended-block"):
        T3.smooth_restrict_ext3(bad, bad, (-16, -16), EXT3_N,
                                (56, 52, 128), 1)
    with pytest.raises(ValueError, match="even"):
        T3.prolong_smooth_ext3(u, u, ec, (-15, -16), EXT3_N, 1)
    with pytest.raises(ValueError, match="extended-block"):
        V3.var_prolong_smooth_ext3(u, u, ec[:, :48], coef, (-16, -16),
                                   EXT3_N, 1)
    with pytest.raises(ValueError, match="extended-block"):
        T3.smooth_restrict_ext3(u, u, (-16, -16), EXT3_N, EXT3_SHAPE_C, 8,
                                "rbgs")


def test_dist3_solvers_launch_the_kernels(gen, tmp_path):
    """The three 3D solvers on a one-rank NCCL group at level 6 (two
    sharded levels): one K1-ext and one K2-local per sharded level and
    cycle, the finest K2 with the resnorm; histories within rtol 1e-4 of the
    same solves on the CPU's plain versions, iterates within 1e-5 of
    max|u|."""
    import os
    import torch.distributed as tdist
    from tpu_multigrid_torch import dist
    cfg = tmg.MultigridConfig(finest_level=6, coarsest_level=3,
                              smoother="chebyshev", nu1=3, nu2=2)
    kw = dict(num_cycles=2, tol=0.0, replicate_below=16)
    winds = dict(eps=1.0, bx=lambda x, y, z: 4.0 * (1.0 + 0.0 * x),
                 by=lambda x, y, z: torch.sin(3.0 * x), bz=0.5)
    runs = [("", dist.sharded_solve_pallas3, {}),
            ("var_", dist.sharded_solve_pallas_var3,
             dict(coefficient=lambda x, y, z: 1.0 + x * y + z)),
            ("var_", dist.sharded_solve_pallas_conv3, winds)]
    cpu = dist.make_grid_mesh3((1, 1), device="cpu")
    refs = [solver(cfg, cpu, **kw, **extra)[0] for _, solver, extra in runs]
    tdist.init_process_group("nccl", init_method="file://" + os.path.join(
        tmp_path, "store"), world_size=1, rank=0)
    try:
        mesh = dist.make_grid_mesh3((1, 1))
        for (pre, solver, extra), ref in zip(runs, refs):
            kernels.reset_launch_counts()
            res, lv = solver(cfg, mesh, **kw, **extra)
            counts = {k: v for k, v in kernels.launch_counts().items() if v}
            ns = lv.num_sharded
            assert ns == 2
            assert counts == {pre + "smooth_restrict_ext3": 2 * ns,
                              pre + "prolong_smooth_ext3": 2 * (ns - 1),
                              pre + "prolong_smooth_ext3_resnorm": 2}
            torch.testing.assert_close(res.res_history, ref.res_history,
                                       rtol=1e-4, atol=0)
            scale = float(ref.u.abs().max())
            torch.testing.assert_close(res.u.cpu(), ref.u, rtol=0,
                                       atol=1e-5 * scale)
    finally:
        tdist.destroy_process_group()


# ---------------------------------------------------------------------------
# The marching kernels where their geometry is new: the streaming smoother's
# row march (csrc/stencil.cu) and K1v_3's z march (csrc/zmarch3.cuh)
# ---------------------------------------------------------------------------

def _rbgs_from(u, b, n, first, steps):
    """RB-GS half-steps first .. first + steps - 1, half-step j updating
    parity j % 2: the plain version's operations from any first step."""
    red, black = ops._parity_masks(u.shape[-1], n, u.device)
    v = u
    for j in range(first, first + steps):
        v = torch.where(black if j % 2 else red,
                        0.25 * (b + ops.neighbor_sum(v)), v)
    return v


def _streamed_direct(u, b, n, steps, first, rbgs, ws, want_u, want_r):
    """One tmt_streamed launch with the given first step: (u' or None,
    r or None)."""
    from tpu_multigrid_torch.kernels import _build
    v = torch.empty_like(u) if want_u else None
    r = torch.empty_like(u) if want_r else None
    wt = stencil.step_weights(ws)
    err = _build.lib().tmt_streamed(
        u.data_ptr(), b.data_ptr(), None if v is None else v.data_ptr(),
        None if r is None else r.data_ptr(), u.shape[-1], n, steps, first,
        rbgs, wt.ctypes.data, wt.size // 2,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "tmt_streamed")
    return v, r


# Ragged sizes for the row march: S not a multiple of a warp's output strip
# (120 columns at a halo of 4) or of its 128-row segment, odd row lengths
# (S % 4 != 0: the copies and stores one column at a time), a grid smaller
# than one strip.
MARCH_SIZES = [(130, 120), (1000, 998), (1030, 1024), (2304, 2048)]


@pytest.mark.parametrize("S,n", MARCH_SIZES)
@pytest.mark.parametrize("label,sm,om,sweeps", STENCIL_CASES
                         + [("rbgs1", "rbgs", None, 1),
                            ("rbgs8", "rbgs", None, 8)])
def test_row_march_all_entries_bitwise_at_ragged_sizes(gen, S, n, label, sm,
                                                       om, sweeps):
    """The five entries of the streaming smoother, bitwise over the whole
    array, at sizes that are not whole strips or segments; deep smoothing
    splits into launches of at most stencil_max_steps steps."""
    from tpu_multigrid_torch.kernels import _build
    u, b = _interior(S, n, gen), _interior(S, n, gen)
    chunk = _build.lib().stencil_max_steps
    steps = 2 * sweeps if sm == "rbgs" else sweeps
    kernels.reset_launch_counts()
    if sm == "rbgs":
        got = [stencil.rbgs_sweeps(u, b, n, sweeps),
               *stencil.rbgs_sweeps_residual(u, b, n, sweeps)]
        want = [stencil.rbgs_sweeps_plain(u, b, n, sweeps),
                *stencil.rbgs_sweeps_residual_plain(u, b, n, sweeps)]
    else:
        got = [stencil.jacobi_sweeps(u, b, n, om, sweeps),
               *stencil.jacobi_sweeps_residual(u, b, n, om, sweeps)]
        want = [stencil.jacobi_sweeps_plain(u, b, n, om, sweeps),
                *stencil.jacobi_sweeps_residual_plain(u, b, n, om, sweeps)]
    got.append(stencil.residual(u, b, n))
    want.append(stencil.residual_plain(u, b, n))
    for g, w in zip(got, want):
        assert torch.equal(g, w), label
    counts = kernels.launch_counts()
    assert counts[f"{sm}_sweeps"] == -(-steps // chunk)
    assert counts[f"{sm}_sweeps_residual"] == -(-steps // chunk)
    assert counts["residual"] == 1


@pytest.mark.parametrize("S,n", [(130, 120), (1030, 1024)])
@pytest.mark.parametrize("first", [0, 1, 5, 16])
@pytest.mark.parametrize("steps", [1, 4, 16])
@pytest.mark.parametrize("outs", [(True, False), (False, True),
                                  (True, True)])
def test_row_march_rbgs_first_step_and_null_outputs(gen, S, n, first, steps,
                                                    outs):
    """One RB-GS launch beginning at an odd or even global half-step, with
    u' or r left out (null), bitwise against the plain half-steps."""
    u, b = _interior(S, n, gen), _interior(S, n, gen)
    v, r = _streamed_direct(u, b, n, steps, first, 1, (1.0,), *outs)
    want = _rbgs_from(u, b, n, first, steps)
    if outs[0]:
        assert torch.equal(v, want)
    if outs[1]:
        assert torch.equal(r, ops.residual(want, b, n))


# A ragged 3D pair: extents that are not whole tiles (22 at a halo of 5) or
# z-segments, live planes across segment boundaries, a coarse grid past S/2.
ZMARCH_PAIR = ((130, 106, 100), (70, 54, 64), 96)
ZMARCH_SMOOTHERS = [("jacobi", ops.chebyshev_omegas(3, 0.4), 3),
                    ("jacobi", 2.0 / 3.0, 1), ("jacobi", 2.0 / 3.0, 0),
                    ("jacobi", ops.chebyshev_omegas(9, 0.4), 9),
                    ("rbgs", 1.0, 1), ("rbgs", 1.0, 2), ("rbgs", 1.0, 5),
                    ("rbgs", 1.0, 6)]


@pytest.mark.parametrize("nplanes", [3, 4, 6])
@pytest.mark.parametrize("sm,om,sweeps", ZMARCH_SMOOTHERS)
def test_zmarch_k1v3_bitwise_at_a_ragged_pair(gen, nplanes, sm, om, sweeps):
    """K1v_3 (u' and the whole coarse grid, its tail included) bitwise at a
    ragged pair: register-queued (up to 3 steps) and per-step coefficients
    (4-9 steps, RB-GS (5, 5) and (6, 6) split into launches, the last
    beginning at an even and an odd half-step), 3, 4 and 6 planes."""
    from tpu_multigrid_torch.kernels import _build
    from tpu_multigrid_torch.kernels import transfer3d as T3
    from tpu_multigrid_torch.kernels import vartransfer3d as VT3
    shape, shape_c, n = ZMARCH_PAIR
    u, b = _interior3(shape, n, gen), _interior3(shape, n, gen)
    coef = _planes3(nplanes, shape, gen)
    kernels.reset_launch_counts()
    ku, krc = VT3.var_smooth_restrict3(u, b, coef, n, shape_c, sweeps, sm, om)
    pu, prc = VT3.var_smooth_restrict3_plain(u, b, coef, n, shape_c, sweeps,
                                             sm, om)
    assert torch.equal(ku, pu) and torch.equal(krc, prc)
    lib = _build.lib()
    steps = 2 * sweeps if sm == "rbgs" else sweeps
    ws = om if isinstance(om, tuple) else (om,)
    plan = T3.k1_plan(steps, ws, lib.zmarch3_max_halo, lib.window3_max_halo)
    assert kernels.launch_counts()["var_smooth_restrict3"] == len(plan)


@pytest.mark.parametrize("nplanes", [3, 6])
@pytest.mark.parametrize("first", [1, 2, 3])
@pytest.mark.parametrize("steps", [2, 3, 4])
def test_zmarch_k1v3_rbgs_from_any_first_step(gen, nplanes, first, steps):
    """One K1v_3 launch of RB-GS half-steps beginning at global half-step
    ``first``, bitwise against the plain half-steps, residual and
    restriction."""
    from tpu_multigrid_torch.kernels import _build
    from tpu_multigrid_torch.kernels import transfer3d as T3
    from tpu_multigrid_torch.kernels import vartransfer3d as VT3
    shape, shape_c, n = ZMARCH_PAIR
    u, b = _interior3(shape, n, gen), _interior3(shape, n, gen)
    coef = _planes3(nplanes, shape, gen)
    out, rc = torch.empty_like(u), torch.empty(shape_c, device="cuda")
    wt = VT3.var_weights3((1.0,))
    err = _build.lib().tmt_var_smooth_restrict3(
        u.data_ptr(), b.data_ptr(), coef.data_ptr(), out.data_ptr(),
        rc.data_ptr(), *shape, *shape_c, n, steps, first, 1, nplanes,
        wt.ctypes.data, 1, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "tmt_var_smooth_restrict3")
    v = VT3.var_smooth3_plain(u, b, coef, n, steps, "rbgs", 1.0, first)
    want_rc = T3.restrict3_plain(VT3.var_residual3_plain(v, b, coef, n), n,
                                 shape_c)
    assert torch.equal(out, v) and torch.equal(rc, want_rc)


@pytest.mark.parametrize("nplanes", [3, 4, 6])
@pytest.mark.parametrize("smoother,omega,sweeps", [("rbgs", 1.0, 2),
                                                   ("rbgs", 1.0, 6),
                                                   ("jacobi", 2.0 / 3.0, 0)])
def test_zmarch_k1v3_ext_at_four_origins(gen, nplanes, smoother, omega,
                                         sweeps):
    """K1v_3-ext on the per-step-coefficient path (RB-GS (2, 2)), split with
    an odd first half-step (RB-GS (6, 6)) and with no steps, bitwise over
    the whole arrays at the four origins of a 2 x 2 shard block."""
    from tpu_multigrid_torch.kernels import vartransfer3d as VT3
    u = torch.randn(EXT3_SHAPE, generator=gen, device="cuda")
    b = torch.randn(EXT3_SHAPE, generator=gen, device="cuda")
    coef = 0.5 + torch.rand((nplanes,) + EXT3_SHAPE, generator=gen,
                            device="cuda")
    for origin in EXT3_ORIGINS:
        args = (u, b, coef, origin, EXT3_N, EXT3_SHAPE_C, sweeps, smoother,
                omega)
        ku, krc = VT3.var_smooth_restrict_ext3(*args)
        pu, prc = VT3.var_smooth_restrict_ext3_plain(*args)
        assert torch.equal(ku, pu) and torch.equal(krc, prc), origin


# The 7-point K1_3 on the z march: the ragged pair, and the 513^3 finest
# pair as the front door pads it.  Jacobi 1 and 2, Chebyshev 3, no steps,
# RB-GS (1, 1) and (2, 2), and depths that split into launches: Chebyshev
# 10 and RB-GS (6, 6) (10 and 12 steps).  K1_3-ext runs the same march:
# test_dist3_kernels_match_plain_bitwise holds it (nplanes 0).
K1_3_ZMARCH_PAIRS = [ZMARCH_PAIR, ((528, 528, 640), (272, 272, 384), 512)]
K1_3_ZMARCH_SMOOTHERS = [("jacobi", 2.0 / 3.0, 1),
                         ("jacobi", ops.chebyshev_omegas(2, 0.4), 2),
                         ("jacobi", ops.chebyshev_omegas(3, 0.4), 3),
                         ("jacobi", 2.0 / 3.0, 0), ("rbgs", 1.0, 1),
                         ("rbgs", 1.0, 2),
                         ("jacobi", ops.chebyshev_omegas(10, 0.4), 10),
                         ("rbgs", 1.0, 6)]


@pytest.mark.parametrize("shape,shape_c,n", K1_3_ZMARCH_PAIRS)
@pytest.mark.parametrize("sm,om,sweeps", K1_3_ZMARCH_SMOOTHERS)
def test_zmarch_k1_3_bitwise(gen, shape, shape_c, n, sm, om, sweeps):
    """K1_3 on the 7-point stencil (u' and the whole coarse grid, its tail
    included) bitwise against its plain version, in the launches of
    ``transfer3d.k1_plan`` under the z march's halo limit."""
    from tpu_multigrid_torch.kernels import _build
    from tpu_multigrid_torch.kernels import transfer3d as T3
    u, b = _interior3(shape, n, gen), _interior3(shape, n, gen)
    kernels.reset_launch_counts()
    ku, krc = T3.smooth_restrict3(u, b, n, shape_c, sweeps, sm, om)
    pu, prc = T3.smooth_restrict3_plain(u, b, n, shape_c, sweeps, sm, om)
    assert torch.equal(ku, pu) and torch.equal(krc, prc)
    lib = _build.lib()
    steps = 2 * sweeps if sm == "rbgs" else sweeps
    ws = om if isinstance(om, tuple) else (om,)
    plan = T3.k1_plan(steps, ws, lib.zmarch3_max_halo, lib.window3_max_halo)
    assert kernels.launch_counts()["smooth_restrict3"] == len(plan)


@pytest.mark.parametrize("first", [1, 2, 3])
@pytest.mark.parametrize("steps", [2, 3, 4])
def test_zmarch_k1_3_rbgs_from_any_first_step(gen, first, steps):
    """One 7-point K1_3 launch of RB-GS half-steps beginning at global
    half-step ``first``, bitwise against the plain half-steps, residual and
    restriction."""
    from tpu_multigrid_torch.kernels import _build
    from tpu_multigrid_torch.kernels import stencil3d as K3
    from tpu_multigrid_torch.kernels import transfer3d as T3
    shape, shape_c, n = ZMARCH_PAIR
    u, b = _interior3(shape, n, gen), _interior3(shape, n, gen)
    out, rc = torch.empty_like(u), torch.empty(shape_c, device="cuda")
    wt, taps = K3.rbgs_weights3(), T3.taps_array()
    err = _build.lib().tmt_smooth_restrict3(
        u.data_ptr(), b.data_ptr(), out.data_ptr(), rc.data_ptr(), *shape,
        *shape_c, n, steps, first, 1, wt.ctypes.data, 1, taps.ctypes.data, 0,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "tmt_smooth_restrict3")
    v = K3.smooth3_plain(u, b, n, steps, "rbgs", 1.0, first_step=first)
    want_rc = T3.restrict3_plain(K3.residual3_plain(v, b, n), n, shape_c)
    assert torch.equal(out, v) and torch.equal(rc, want_rc)


def _load_devtrace():
    """The benchmark's trace reader (h100bench/devtrace.py), by path."""
    import importlib.util
    import pathlib
    import sys
    path = pathlib.Path(__file__).resolve().parents[1] / "h100bench" / \
        "devtrace.py"
    spec = importlib.util.spec_from_file_location("devtrace", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules.setdefault("devtrace", mod)   # its dataclass looks it up
    spec.loader.exec_module(mod)
    return sys.modules["devtrace"]


def test_zmarch_k1_3_keeps_its_trace_identifier(gen):
    """Under torch.profiler, as the benchmark reads a trace
    (``devtrace.base_name``): the 7-point K1_3 launch is
    ``smooth_restrict3_kernel``, the z march's instance on ZConstOp3; the
    19-point one stays the window's; K1v_3 is
    ``zmarch_smooth_restrict3_kernel`` on ``VarOp3<``.
    ``LAUNCHES["smooth_restrict3"]`` counts one a K1_3 launch."""
    from torch.profiler import ProfilerActivity, profile
    from tpu_multigrid_torch.core.operators import Const19Op
    from tpu_multigrid_torch.kernels import transfer3d as T3
    from tpu_multigrid_torch.kernels import vartransfer3d as VT3
    devtrace = _load_devtrace()
    shape, shape_c, n = ZMARCH_PAIR
    u, b = _interior3(shape, n, gen), _interior3(shape, n, gen)
    coef = _planes3(3, shape, gen)
    om = ops.chebyshev_omegas(3, 0.4)
    calls = [lambda: T3.smooth_restrict3(u, b, n, shape_c, 3, "jacobi", om),
             lambda: T3.smooth_restrict3(u, b, n, shape_c, 3, "jacobi", om,
                                         Const19Op.STENCIL27),
             lambda: VT3.var_smooth_restrict3(u, b, coef, n, shape_c, 3,
                                              "jacobi", om)]
    names = []
    for call in calls:
        call()                        # built and warm outside the trace
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        device, _ = devtrace.events(prof)
        names.append([devtrace.short_name(name) for name, _, _ in device
                      if "smooth_restrict3_kernel" in name])
        counts = kernels.launch_counts()
        want = 0 if call is calls[2] else 1
        assert counts["smooth_restrict3"] == want, counts
    k7, k19, kv = names
    assert len(k7) == len(k19) == len(kv) == 1, names
    assert devtrace.base_name(k7[0]) == "smooth_restrict3_kernel", k7
    assert "zmarch::" in k7[0] and "ConstOp3" in k7[0], k7
    assert devtrace.base_name(k19[0]) == "smooth_restrict3_kernel", k19
    assert "zmarch" not in k19[0] and "ConstOp3<true>" in k19[0], k19
    assert devtrace.base_name(kv[0]) == "zmarch_smooth_restrict3_kernel", kv
    assert "VarOp3<" in kv[0], kv


# ---------------------------------------------------------------------------
# The 3D compensated residuals: ds_residual3 and ts_residual3 (the z march)
# ---------------------------------------------------------------------------

# (shape, n): levels 5, 7 and 9 as the 3D front door pads them, and a ragged
# grid whose sides are no multiple of the 8 x 4 x 64 block.
COMPRES3 = [((48, 48, 128), 32), ((144, 144, 256), 128),
            ((528, 528, 640), 512), ((70, 54, 130), 50)]


@pytest.mark.parametrize("shape,n", COMPRES3)
def test_comp_residuals3_match_plain_bitwise(gen, shape, n):
    """u_hi O(1), u_mid ~1e-8, u_lo ~1e-16, b ~h^2; the ragged grid holds
    noise outside the interior too (only masked nodes may see it)."""
    if n == 50:
        def comp(scale):
            return scale * torch.randn(shape, generator=gen, device="cuda")
    else:
        def comp(scale):
            return _interior3(shape, n, gen, scale)
    b, uh, um, ul = comp(1.0 / n ** 2), comp(1.0), comp(1e-8), comp(1e-16)
    assert torch.equal(compres.ds_residual3(b, uh, um, n),
                       precision.ds_residual(b, uh, um, n))
    assert torch.equal(compres.ts_residual3(b, uh, um, ul, n),
                       precision.ts_residual(b, uh, um, ul, n))


def test_comp_residuals3_launches_and_bad_inputs(gen):
    shape, n = COMPRES3[0]
    u = _interior3(shape, n, gen)
    kernels.reset_launch_counts()
    compres.ds_residual3(u, u, u, n)
    compres.ts_residual3(u, u, u, u, n)
    assert {k: v for k, v in kernels.launch_counts().items() if v} == {
        "ds_residual3": 1, "ts_residual3": 1}
    d = u.double()
    with pytest.raises(NotImplementedError):
        compres.ds_residual3(d, d, d, n)
    with pytest.raises(ValueError):     # shapes differ
        compres.ds_residual3(u, u, u[:, :, :64].contiguous(), n)
    with pytest.raises(ValueError):     # not contiguous
        compres.ts_residual3(u, u, u.transpose(0, 1), u, n)
    with pytest.raises(ValueError):     # a batch of grids
        v = torch.zeros((2, 48, 48, 128), device="cuda")
        compres.ds_residual3(v, v, v, n)
    with pytest.raises(ValueError):     # a 2D grid
        w = torch.zeros((256, 256), device="cuda")
        compres.ds_residual3(w, w, w, 64)
    with pytest.raises(ValueError):     # n past the grid
        compres.ts_residual3(u, u, u, u, 48)
    assert {k: v for k, v in kernels.launch_counts().items() if v} == {
        "ds_residual3": 1, "ts_residual3": 1}


@pytest.mark.parametrize("driver,ds_levels", [("ds", 0), ("ds", 2),
                                              ("ts", 2)])
def test_refined3d_residual_kernel_keeps_the_iterates(gen, monkeypatch,
                                                      driver, ds_levels):
    """A level-7 refined solve to 1e-10 with the 3D residual on the kernel
    and forced onto the plain version: the same iterations and the same
    bits; one ds residual per ds level and iteration plus the outer one."""
    cfg = tmg.MultigridConfig(finest_level=7, smoother="chebyshev", nu1=3,
                              nu2=2, use_kernels=True)
    prob = tmg.Poisson3DProblem(cfg, align=16, min_pad_level=0,
                                lane_align=128, device="cuda")
    b = prob.rhs()

    def solve():
        if driver == "ds":
            return precision.solve_refined_ds(prob.hierarchy, cfg, b,
                                              tol=1e-10, max_iters=30,
                                              ds_levels=ds_levels)
        return precision.solve_refined_ts(prob.hierarchy, cfg, b, tol=1e-10,
                                          max_iters=30, ds_levels=ds_levels)
    kernels.reset_launch_counts()
    ko = solve()
    counts = kernels.launch_counts()
    monkeypatch.setattr(compres, "supported3", lambda shape, dtype: False)
    po = solve()
    assert kernels.launch_counts()["ds_residual3"] == counts["ds_residual3"]
    it = ko[-2]
    assert ko[-1] and po[-2] == it
    for k, p in zip(ko[:-3], po[:-3]):
        assert torch.equal(k, p)
    torch.testing.assert_close(ko[-3], po[-3], rtol=0, atol=0,
                               equal_nan=True)
    if driver == "ds":
        assert counts["ds_residual3"] == (ds_levels + 1) * it
        assert counts["ts_residual3"] == 0
    else:
        assert counts["ds_residual3"] == ds_levels * it
        assert counts["ts_residual3"] == it
    assert counts["ds_residual"] == counts["ts_residual"] == 0
    # One compensated add an iteration, two a ds level, all on the kernel.
    assert counts["comp_add_ext"] == (1 + 2 * ds_levels) * it


def _hpgmg_beta(x, y, z):
    """HPGMG-FV's evaluateBeta: 1 inside a ball of radius 0.25, 10 out."""
    r = torch.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2)
    return 5.5 + 4.5 * torch.tanh(10.0 * (r - 0.25))


def test_refined_var3d_matches_the_cpu(gen):
    """A level-7 refined solve of HPGMG-FV's variable-beta problem to 1e-8:
    on the card (K1v_3 / K2v_3 and the float64 flux-form residual) in the
    iterations of the CPU's solve (the kernels' plain versions), each
    answer within 1e-8 of ||b|| by the float64 residual (the iterates
    themselves differ in their last bits: the coarse levels' plain ops and
    the dense coarse solve round differently on the two devices)."""
    cfg = tmg.MultigridConfig(finest_level=7, smoother="chebyshev", nu1=3,
                              nu2=2, use_kernels=True)
    got = {}
    for device in ("cuda", "cpu"):
        prob = tmg.Diffusion3DProblem(cfg, coefficient=_hpgmg_beta,
                                      device=device)
        b = prob.rhs()
        kernels.reset_launch_counts()
        u_hi, u_lo, _, it, ok = precision.solve_refined_ds(
            prob.hierarchy, cfg, b, tol=1e-8)
        counts = kernels.launch_counts()
        op = prob.hierarchy.levels[0].to("cpu")
        r = precision._comp_residual(b.cpu(), (u_hi.cpu(), u_lo.cpu()), op,
                                     False)
        rel = float(torch.linalg.vector_norm(r.double())
                    / torch.linalg.vector_norm(b.cpu().double()))
        got[device] = (it, ok, rel, counts)
    (it, ok, rel, counts), (cit, cok, crel, _) = got["cuda"], got["cpu"]
    assert ok and cok and it == cit
    assert rel <= 1e-8 and crel <= 1e-8
    # One fused pair at level 7: (144, 144, 256) -> (80, 80, 128).
    assert counts["var_smooth_restrict3"] == it
    assert counts["var_prolong_smooth3"] == it
    # One float64 flux-form residual an iteration, all on the kernel.
    assert counts["ds_residual_var3"] == it
    # One compensated add an iteration, on the kernel.
    assert counts["comp_add_ext"] == it


# ---------------------------------------------------------------------------
# The 3D flux stencil's float64 residual: ds_residual_var3 (a column march)
# ---------------------------------------------------------------------------

def _var3_op(level, shift):
    """The finest operator of a level-``level`` HPGMG-FV problem on the card
    (padded: Sx != S), with the reaction plane when ``shift``."""
    cfg = tmg.MultigridConfig(finest_level=level, smoother="chebyshev",
                              nu1=3, nu2=2, use_kernels=True)
    kw = {"shift": lambda x, y, z: 50.0 * (1 + x * y * z)} if shift else {}
    op = tmg.Diffusion3DProblem(cfg, coefficient=_hpgmg_beta, device="cuda",
                                **kw).hierarchy.levels[0]
    assert (op.c2 is not None) == shift and op.S != op.Sx
    return op


def _var3_pair(shape, gen):
    """u_hi ~N(0, 1), u_lo within half an ulp of it, b ~1e-3 N(0, 1)."""
    u_hi = torch.randn(shape, generator=gen, device="cuda")
    ulp = (torch.nextafter(u_hi.abs(), torch.tensor(float("inf"),
                                                    device="cuda"))
           - u_hi.abs())
    u_lo = (torch.rand(shape, generator=gen, device="cuda") - 0.5) * ulp
    return u_hi, u_lo, 1e-3 * torch.randn(shape, generator=gen,
                                          device="cuda")


def _past_n(a, n, gen):
    """A copy of ``a`` with large noise in every cell past n on some axis."""
    out = a.clone()
    noise = 1e3 * torch.randn(a.shape, generator=gen, device="cuda")
    past = torch.ones(a.shape, dtype=torch.bool, device="cuda")
    past[:n + 1, :n + 1, :n + 1] = False
    out[past] = noise[past]
    return out


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("level", [4, 5, 7])
def test_var_residual_kernel_matches_plain_bitwise(gen, level, shift):
    """The kernel against the plain float64 z-slab body on the same CUDA
    tensors, bit for bit; every input and plane holds noise past n, which
    neither may read; r is zero outside 1..n-1."""
    op = _var3_op(level, shift)
    n = op.n
    u_hi, u_lo, b = _var3_pair(op.grid_shape, gen)
    want = precision.ds_residual_var3_plain(op, b, u_hi, u_lo)
    op_n = type(op)(*(_past_n(t, n, gen) for t in (op.tz, op.ty, op.tx)),
                    op.inv_diag, n, op.S, op.Sx,
                    c2=_past_n(op.c2, n, gen) if shift else None)
    args = [_past_n(t, n, gen) for t in (b, u_hi, u_lo)]
    kernels.reset_launch_counts()
    got = compres.ds_residual_var3(op_n, *args)
    assert kernels.launch_counts()["ds_residual_var3"] == 1
    assert got.dtype == torch.float32 and torch.equal(got, want)
    inner = torch.zeros_like(got, dtype=torch.bool)
    inner[1:n, 1:n, 1:n] = True
    assert not got[~inner].any() and got[inner].any()
    # The plain body on the noisy inputs reads the same cells.
    assert torch.equal(precision.ds_residual_var3_plain(op_n, *args), want)


def test_var_residual_dispatch_and_launch_counts(gen):
    """The refinement's residual dispatch (``precision._comp_residual``)
    launches the kernel once a call on a flux stencil's float32 CUDA
    tensors, with or without ``use_kernels``, keeps float64 on the plain
    body, and the wrapper refuses grids that do not match the operator's."""
    op = _var3_op(4, False)
    u_hi, u_lo, b = _var3_pair(op.grid_shape, gen)
    kernels.reset_launch_counts()
    for k in range(1, 4):
        precision._comp_residual(b, (u_hi, u_lo), op, k % 2 == 0)
        assert {k2: v for k2, v in kernels.launch_counts().items() if v} == {
            "ds_residual_var3": k}
    op64 = type(op)(op.tz.double(), op.ty.double(), op.tx.double(),
                    op.inv_diag.double(), op.n, op.S, op.Sx)
    r64 = precision._comp_residual(
        b.double(), (u_hi.double(), u_lo.double()), op64, True)
    assert r64.dtype == torch.float64
    with pytest.raises(ValueError):     # shapes differ from the planes'
        compres.ds_residual_var3(op, b[:, :, :64].contiguous(),
                                 u_hi[:, :, :64].contiguous(),
                                 u_lo[:, :, :64].contiguous())
    with pytest.raises(ValueError):     # not contiguous
        compres.ds_residual_var3(op, b, u_hi.transpose(0, 1), u_lo)
    assert kernels.launch_counts()["ds_residual_var3"] == 3


def test_bratu3d_cell_kernel_route_matches_the_plain_route(gen):
    """The ``bratu3d-513.fas-vcycles-6`` cell's solve, 6 FAS V-cycles of
    the 513^3 Bratu problem at lam = 6 with the door's schedule from a
    seeded forcing: the kernel route (K1f_3 / K2f_3 on the three fused
    pairs, 36 launches) against the plain route on the same (528, 528, 640)
    layout, to float32 rounding."""
    from tpu_multigrid_torch.cycles import fas
    from tpu_multigrid_torch.core import ops3d
    from tpu_multigrid_torch.problems.bratu import Bratu3DProblem
    cfg = tmg.MultigridConfig(finest_level=9, coarsest_level=3,
                              use_kernels=True)
    prob = Bratu3DProblem(cfg, lam=6.0, device="cuda", align=16,
                          min_pad_level=0, lane_align=128)
    hier = prob.hierarchy
    op = hier.levels[0]
    assert op.grid_shape == (528, 528, 640)
    f = torch.randn(op.grid_shape, generator=gen, device="cuda")
    b = ops3d.mask_interior3(f * (1.0 / op.n) ** 2, op.n)
    kernels.reset_launch_counts()
    got = fas.fas_solve_fixed(hier, cfg, b, 6)
    assert {k: v for k, v in kernels.launch_counts().items() if v} == {
        "fas_smooth_restrict3": 18, "fas_prolong_smooth3": 12,
        "fas_prolong_smooth_resnorm3": 6}
    plain = fas.fas_solve_fixed(hier, dataclasses.replace(
        cfg, use_kernels=False), b, 6)
    gap = (got.u - plain.u).abs().max() / plain.u.abs().max()
    assert float(gap) < 1e-5
    hk, hp = got.res_history, plain.res_history
    assert torch.allclose(hk[:4], hp[:4], rtol=1e-3)
    assert float(hk[-1]) < 0.05 * float(hk[0])


def test_fmg_replays_its_captured_pass_bitwise(gen):
    """``cycles.fmg`` on one hierarchy: the first call issues the pass and
    captures nothing, the second captures it as a CUDA graph and replays
    it, later calls replay it; every answer is bitwise the issued pass's,
    every call counts one pass's launches, and a replayed answer is a copy
    the next replay leaves alone."""
    from tpu_multigrid_torch import cycles
    cfg = tmg.MultigridConfig(finest_level=11, coarsest_level=5, nu1=3,
                              nu2=2, smoother="chebyshev", use_kernels=True)
    hier = tmg.PoissonProblem(cfg, device="cuda", align=256,
                              min_pad_level=0).hierarchy
    op = hier.levels[0]
    bs = [_interior(op.S, op.n, gen) for _ in range(4)]
    want, counts = [], []
    for b in bs:
        kernels.reset_launch_counts()
        want.append(cycles._fmg(hier, cfg, b, None))
        counts.append(kernels.launch_counts())
    for i, (b, w, c) in enumerate(zip(bs, want, counts)):
        kernels.reset_launch_counts()
        got = cycles.fmg(hier, cfg, b)
        assert kernels.launch_counts() == c
        assert torch.equal(got, w)
        (graph,) = cycles._FMG_GRAPHS[hier].values()
        assert (graph is None) == (i == 0)
    held = cycles.fmg(hier, cfg, bs[0])
    cycles.fmg(hier, cfg, bs[1])
    assert torch.equal(held, want[0])
    # The refined solve from the replayed start: the issued start's.
    u_hi, u_lo, _, iters, ok = precision.solve_refined_ds(
        hier, cfg, bs[2], tol=1e-7, u0=cycles.fmg(hier, cfg, bs[2]))
    r_hi, r_lo, _, r_iters, _ = precision.solve_refined_ds(
        hier, cfg, bs[2], tol=1e-7, u0=want[2])
    assert ok and iters == r_iters
    assert torch.equal(u_hi, r_hi) and torch.equal(u_lo, r_lo)


# ---------------------------------------------------------------------------
# The refinement loop's compensated accumulation: precision._accumulate on
# comp_add_ext, in place, over any contiguous view
# ---------------------------------------------------------------------------

def _grids(layout, scales, gen):
    """Float32 CUDA grids of ~N(0, 1) times each scale.  ``offset``: views
    one float into a buffer of their own, so no pointer is 16-byte aligned;
    ``odd``: an odd count, not a multiple of a block's 256 threads."""
    shape = {"2d": (256, 768), "3d": (48, 48, 128), "odd": (37, 41, 43),
             "offset": (255, 257)}[layout]
    out = []
    for s in scales:
        if layout == "offset":
            n = shape[0] * shape[1]
            buf = torch.randn(n + 1, generator=gen, device="cuda")
            out.append(buf[1:].mul_(s).view(shape))
        else:
            out.append(s * torch.randn(shape, generator=gen, device="cuda"))
    return out


@pytest.mark.parametrize("layout", ["2d", "3d", "odd", "offset"])
@pytest.mark.parametrize("nparts", [2, 3])
@pytest.mark.parametrize("nys", [1, 2])
def test_accumulate_kernel_route_matches_the_chain_bitwise(gen, layout,
                                                           nparts, nys):
    """One comp_add_ext launch in one ``accumulate`` span writes, over the
    parts' own storage, the bits of the ds_add / ts_add chain."""
    parts = _grids(layout, (1.0, 1e-8, 1e-16)[:nparts], gen)
    ys = _grids(layout, (1e-3, 1e-9)[:nys], gen)
    if layout == "odd":
        assert parts[0].numel() % 4 == 3
    if layout == "offset":
        assert all(t.data_ptr() % 16 for t in parts + ys)
    want = [p.clone() for p in parts]
    precision._accumulate(want, ys)
    got = list(parts)
    kernels.reset_launch_counts()
    precision._accumulate(got, ys, True)
    assert {k: v for k, v in kernels.launch_counts().items() if v} == {
        "comp_add_ext": 1}
    assert all(g is p for g, p in zip(got, parts))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("ndim,driver,ds_levels", [
    (2, "ds", 0), (2, "ds", 2), (2, "ts", 2), (3, "ds", 0), (3, "ds", 2)])
def test_refined_accumulation_on_the_kernel_keeps_the_iterates(
        gen, monkeypatch, ndim, driver, ds_levels):
    """A refined solve with every add on comp_add_ext against the same
    solve with the adds on the plain chain: the same iterations and bits;
    one launch an iteration plus two a ds level, none on the chain; a
    caller's start (u0, u0_lo) is left as given."""
    cfg = tmg.MultigridConfig(finest_level=10 if ndim == 2 else 6,
                              coarsest_level=5 if ndim == 2 else 3,
                              smoother="chebyshev", nu1=3, nu2=2,
                              use_kernels=True)
    prob = (tmg.PoissonProblem(cfg, device="cuda", align=256,
                               min_pad_level=0) if ndim == 2 else
            tmg.Poisson3DProblem(cfg, align=16, min_pad_level=0,
                                 lane_align=128, device="cuda"))
    b = prob.rhs()
    if driver == "ds":
        x, x_lo = precision.solve_refined_ds(prob.hierarchy, cfg, b,
                                             num_cycles=1, tol=None)[:2]
        keep = (x.clone(), x_lo.clone())

    def solve():
        if driver == "ds":
            return precision.solve_refined_ds(
                prob.hierarchy, cfg, b, tol=1e-7, max_iters=30, u0=x,
                u0_lo=x_lo, ds_levels=ds_levels)
        return precision.solve_refined_ts(prob.hierarchy, cfg, b, tol=1e-10,
                                          max_iters=30, ds_levels=ds_levels)
    kernels.reset_launch_counts()
    ko = solve()
    counts = kernels.launch_counts()
    chain = precision._accumulate
    monkeypatch.setattr(precision, "_accumulate",
                        lambda parts, ys, use_kernels=False: chain(parts, ys))
    kernels.reset_launch_counts()
    po = solve()
    assert kernels.launch_counts()["comp_add_ext"] == 0
    it = ko[-2]
    assert ko[-1] and po[-2] == it
    assert counts["comp_add_ext"] == it * (1 + 2 * ds_levels)
    for k, p in zip(ko[:-3], po[:-3]):
        assert torch.equal(k, p)
    torch.testing.assert_close(ko[-3], po[-3], rtol=0, atol=0,
                               equal_nan=True)
    if driver == "ds":
        assert torch.equal(x, keep[0]) and torch.equal(x_lo, keep[1])
