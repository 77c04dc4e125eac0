"""The port's 2D variable-coefficient path against the JAX package, on the
CPU, from the same numpy inputs: the host set-up functions,
``VarStencilOp``, the var kernels' plain versions against the Pallas
kernels in interpret mode, the new transfers, ``solve_diffusion`` /
``solve_helmholtz``, and the kernel dispatch of the path, counted with
spies on the wrappers.

Tolerances.  The host set-up functions are the same numpy arithmetic in
the same order: bitwise.  ``VarStencilOp`` evaluates the JAX operator's
terms in its order; in float64 the two agree to rtol 1e-12 (XLA:CPU may
contract multiply-adds into FMAs, torch's CPU kernels do not).  The
kernels' plain versions follow the Pallas kernels' order, which is not
``VarStencilOp``'s; against the kernels run in interpret mode they agree
to 2e-5, the bound tests/test_varstencil_kernels.py holds the Pallas
kernels to (FMAs again, and the Pallas restriction sums in another order),
and the resnorm to rtol 1e-4.  float64 solves agree in iteration count
with histories to rtol 1e-10 above the float64 floor (atol 1e-14, as
tests/test_torch_slice.py); float32 histories to rtol 1e-3 while the
residual is above the float32 floor (``h^2``-scaled right-hand sides
floor near 1e-3 relative at 257^2).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import tpu_multigrid as jmg
from tpu_multigrid import cycles as jcycles
from tpu_multigrid.core import grids as jgrids
from tpu_multigrid.core import operators as jopr
from tpu_multigrid.core import ops as jops
from tpu_multigrid.kernels import varstencil as JV
from tpu_multigrid.kernels import vartransfer as JVT
from tpu_multigrid.problems import helmholtz as jhelm

import tpu_multigrid_torch as tmg
from tpu_multigrid_torch import interop, kernels
from tpu_multigrid_torch.core import grids, operators, ops
from tpu_multigrid_torch.kernels import transfer as TT
from tpu_multigrid_torch.kernels import varstencil as TV
from tpu_multigrid_torch.kernels import vartransfer as TVT
from tpu_multigrid_torch.problems import helmholtz

# One torch thread per test worker (see tests/test_torch_ops.py).
torch.set_num_threads(1)

F64_ATOL = 1e-14


def _cells(n, seed, dtype=np.float32):
    return (0.5 + np.random.default_rng(seed).random((n, n))).astype(dtype)


def _interior(S, n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    a = np.zeros((S, S), dtype)
    a[1:n, 1:n] = rng.standard_normal((n - 1, n - 1))
    return a


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _same_op(t, j):
    for name in ("coef", "inv_diag"):
        np.testing.assert_array_equal(_np(getattr(t, name)),
                                      _np(getattr(j, name)))
    assert (t.n, t.S, t.is_symmetric) == (j.n, j.S, j.is_symmetric)


# ---------------------------------------------------------------------------
# Host set-up
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_host_setup_matches_jax_bitwise(dtype):
    """diffusion_op_host and two chained galerkin_coarsen_host levels
    (flux 5-point, then 9-point) equal the JAX ones bitwise, and so do the
    kernels' coefficient planes."""
    n, S = 128, 256
    cells = _cells(n, 0, dtype)
    t = operators.diffusion_op_host(cells, n, S)
    j = jopr.diffusion_op_host(cells, n, S)
    _same_op(t, j)
    for Sc in (128, 64):
        t = operators.galerkin_coarsen_host(t, Sc)
        j = jopr.galerkin_coarsen_host(j, Sc)
        _same_op(t, j)
        np.testing.assert_array_equal(t.with_sym_planes().coef_sym,
                                      j.with_sym_planes().coef_sym)
    # The torch version computes the host one's arithmetic.
    d = operators.diffusion_op(torch.from_numpy(cells), n, S)
    _same_op(d, operators.diffusion_op_host(cells, n, S))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_helmholtz_op_host_matches_jax_bitwise(dtype):
    shift = lambda x, y: 3.0 + 40.0 * x * y  # noqa: E731
    for n, S in ((64, 65), (64, 256)):
        t = helmholtz.helmholtz_op_host(n, S, shift, dtype)
        j = jhelm.helmholtz_op_host(n, S, shift, dtype)
        _same_op(t, j)
    _same_op(helmholtz.helmholtz_op_host(32, 33, 2.5, dtype),
             jhelm.helmholtz_op_host(32, 33, 2.5, dtype))
    with pytest.raises(ValueError):
        helmholtz.helmholtz_op_host(8, 9, -1e4, dtype)


def test_galerkin_probe_matches_host_f64():
    """The comb probe (torch, through the port's transfers) against the
    closed-form host product, float64, on a flux level and a Galerkin one."""
    n, S = 64, 65
    fine = operators.diffusion_op_host(_cells(n, 1, np.float64), n, S)
    for Sc in (33, 17):
        host = operators.galerkin_coarsen_host(fine, Sc)
        probe = operators.galerkin_coarsen(fine.to("cpu"), Sc)
        np.testing.assert_allclose(_np(probe.coef), host.coef, rtol=0,
                                   atol=1e-12 * np.abs(host.coef).max())
        np.testing.assert_allclose(_np(probe.inv_diag), host.inv_diag,
                                   rtol=1e-12, atol=0)
        fine = host


def test_galerkin_hierarchy_and_coarse_inverse_match_jax():
    cj = jmg.MultigridConfig(finest_level=6, coarsest_level=4,
                             dtype=jnp.float64)
    ct = tmg.MultigridConfig(finest_level=6, coarsest_level=4,
                             dtype=torch.float64)
    cells = _cells(64, 2, np.float64)
    hj = jgrids.build_galerkin_hierarchy(jopr.diffusion_op_host(cells, 64, 65),
                                         cj)
    ht = grids.build_galerkin_hierarchy(
        operators.diffusion_op_host(cells, 64, 65), ct)
    for t, j in zip(ht.levels, hj.levels):
        _same_op(t, j)
    # Both store the float64 inverse in float32.
    np.testing.assert_array_equal(_np(ht.coarse_inv), _np(hj.coarse_inv))
    hp = grids.build_galerkin_hierarchy(
        operators.diffusion_op_host(cells, 64, 65), ct, method="probe")
    np.testing.assert_allclose(_np(hp.levels[-1].coef), ht.levels[-1].coef,
                               rtol=0, atol=1e-12)
    with pytest.raises(ValueError):
        grids.build_galerkin_hierarchy(ht.levels[0], ct, method="conv")


# ---------------------------------------------------------------------------
# VarStencilOp
# ---------------------------------------------------------------------------

def _op_pair(kind):
    """(port operator on the CPU, JAX operator), float64: the flux level,
    a Galerkin 9-point level, or a shifted-Poisson level."""
    n, S = 64, 128
    if kind == "helmholtz":
        shift = lambda x, y: 50.0 * x + 7.0  # noqa: E731
        return (helmholtz.helmholtz_op_host(n, S, shift, np.float64).to("cpu"),
                jhelm.helmholtz_op_host(n, S, shift, np.float64))
    if kind == "flux":
        cells = _cells(n, 3, np.float64)
        t = operators.diffusion_op_host(cells, n, S)
        j = jopr.diffusion_op_host(cells, n, S)
    else:
        cells = _cells(2 * n, 3, np.float64)
        t = operators.galerkin_coarsen_host(
            operators.diffusion_op_host(cells, 2 * n, 2 * S), S)
        j = jopr.galerkin_coarsen_host(
            jopr.diffusion_op_host(cells, 2 * n, 2 * S), S)
    return t.to("cpu"), j


@pytest.mark.parametrize("kind", ["flux", "galerkin", "helmholtz"])
def test_var_op_matches_jax_f64(kind):
    t, j = _op_pair(kind)
    n, S = t.n, t.S
    u, b = _interior(S, n, 4, np.float64), _interior(S, n, 5, np.float64)
    tu, tb = torch.from_numpy(u), torch.from_numpy(b)
    ju, jb = jnp.asarray(u), jnp.asarray(b)

    def close(got, want):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-12,
                                   atol=1e-12 * np.abs(_np(want)).max())

    close(t.apply(tu), j.apply(ju))
    close(t.residual(tu, tb), j.residual(ju, jb))
    for sm, om, sweeps in (("jacobi", 2.0 / 3.0, 3),
                           ("jacobi", ops.chebyshev_omegas(3, 0.4), 3),
                           ("rbgs", 2.0 / 3.0, 2)):
        close(t.smooth(tu, tb, smoother=sm, omega=om, sweeps=sweeps),
              j.smooth(ju, jb, smoother=sm, omega=om, sweeps=sweeps))


def test_var_op_unported_options_raise():
    """Box operators are not ported yet; the zebra smoothers are
    (tests/test_torch_aniso.py), and an unknown smoother raises."""
    t, _ = _op_pair("flux")
    z = torch.zeros((t.S, t.S), dtype=torch.float64)
    assert torch.equal(t.smooth(z, z, smoother="zebra_x", omega=1.0,
                                sweeps=1), z)
    with pytest.raises(ValueError):
        t.smooth(z, z, smoother="sor", omega=1.0, sweeps=1)
    with pytest.raises(NotImplementedError):
        operators.VarStencilOp(t.coef, t.inv_diag, t.n, t.S,
                               box=(0, 63, 1, 63))


# ---------------------------------------------------------------------------
# The var kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

def _kernel_planes(kind, n, S):
    """(port planes tensor, JAX planes array), float32: the flux operator
    (5 planes), a Galerkin 9-point level (5 planes, symmetric) or a
    nonsymmetric 9-point operator from a seed (9 planes)."""
    if kind == "flux":
        op = operators.diffusion_op_host(_cells(n, 6), n, S)
    elif kind == "galerkin":
        op = operators.galerkin_coarsen_host(
            operators.diffusion_op_host(_cells(2 * n, 6), 2 * n, 2 * S), S)
    else:
        rng = np.random.default_rng(6)
        coef = np.zeros((3, 3, S, S), np.float32)
        coef[:, :, 1:n, 1:n] = -0.25 - rng.random((3, 3, n - 1, n - 1))
        coef[1, 1, 1:n, 1:n] = 8.0 + rng.random((n - 1, n - 1))
        op = operators.VarStencilOp(coef, None, n, S, is_symmetric=False)
    planes = op.with_sym_planes().coef_sym
    assert planes.shape[0] == (9 if kind == "nonsym" else 5)
    return torch.from_numpy(planes), jnp.asarray(planes)


KINDS = ["flux", "galerkin", "nonsym"]
SMOOTHERS = [("jacobi", 2.0 / 3.0, 2),
             ("jacobi", ops.chebyshev_omegas(3, 0.4), 3),
             ("rbgs", 2.0 / 3.0, 1)]


def _close(got, want, tol=2e-5):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("sm,om,sweeps", SMOOTHERS)
def test_var_smooth_plain_matches_pallas(kind, sm, om, sweeps):
    S, n = 256, 250
    tc, jc = _kernel_planes(kind, n, S)
    u, b = _interior(S, n, 7), _interior(S, n, 8)
    with pltpu.force_tpu_interpret_mode():
        ju = JV.var_smooth(jnp.asarray(u), jnp.asarray(b), jc, n, sweeps, sm,
                           om)
        jv, jr = JV.var_smooth_residual(jnp.asarray(u), jnp.asarray(b), jc, n,
                                        sweeps, sm, om)
    tu, tb = torch.from_numpy(u), torch.from_numpy(b)
    _close(TV.var_smooth(tu, tb, tc, n, sweeps, sm, om), ju)
    tv, tr = TV.var_smooth_residual(tu, tb, tc, n, sweeps, sm, om)
    _close(tv, jv)
    _close(tr, jr)


# (S, Sc, n): the bottom pair (no row tiling) and a row-tiled pair.
VPAIRS = [(256, 256, 250), (512, 256, 500)]


@pytest.mark.parametrize("S,Sc,n", VPAIRS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("sm,om,sweeps", SMOOTHERS[1:])
def test_k1v_k2v_plain_match_pallas(S, Sc, n, kind, sm, om, sweeps):
    tc, jc = _kernel_planes(kind, n, S)
    u, b = _interior(S, n, 9), _interior(S, n, 10)
    ec = _interior(Sc, n // 2, 11)
    ju, jb, je = jnp.asarray(u), jnp.asarray(b), jnp.asarray(ec)
    with pltpu.force_tpu_interpret_mode():
        j1 = JVT.var_smooth_restrict_fused(ju, jb, jc, n, Sc, sweeps, sm, om)
        j2 = JVT.var_prolong_smooth_fused(ju, jb, je, jc, n, sweeps, sm, om)
        j3 = JVT.var_prolong_smooth_resnorm(ju, jb, je, jc, n, sweeps, sm, om)
    tu, tb, te = map(torch.from_numpy, (u, b, ec))
    t1 = TVT.var_smooth_restrict_fused(tu, tb, tc, n, Sc, sweeps, sm, om)
    _close(t1[0], j1[0])
    _close(t1[1], j1[1])
    assert not t1[1].numpy()[S // 2:].any()
    t2 = TVT.var_prolong_smooth_fused(tu, tb, te, tc, n, sweeps, sm, om)
    _close(t2, j2)
    t3, tnorm = TVT.var_prolong_smooth_resnorm(tu, tb, te, tc, n, sweeps, sm,
                                               om)
    assert torch.equal(t3, t2)
    assert tnorm.dtype == torch.float32 and tnorm.shape == ()
    np.testing.assert_allclose(float(tnorm), float(j3[1]), rtol=1e-4)


def test_plain_versions_follow_the_kernel_order_not_the_operator():
    """On the flux operator the kernels' plain versions and VarStencilOp's
    smoother differ only at float32 roundoff, and the plain residual of an
    operator with stored W/N/NW/NE planes equals its 5-plane derivation
    bitwise at every interior node."""
    S, n = 256, 250
    op = operators.diffusion_op_host(_cells(n, 12), n, S).with_sym_planes()
    t = op.to("cpu")
    u, b = torch.from_numpy(_interior(S, n, 13)), torch.from_numpy(
        _interior(S, n, 14))
    _close(TV.var_smooth(u, b, t.coef_sym, n, 2), t.smooth(
        u, b, smoother="jacobi", omega=2.0 / 3.0, sweeps=2), 1e-5)
    full = torch.stack(operators._sym_planes(t.coef)
                       + operators._minus_planes(t.coef))
    assert torch.equal(TV.var_residual_plain(u, b, full, n),
                       TV.var_residual_plain(u, b, t.coef_sym, n))


@pytest.mark.parametrize("S", [128, 256, 384, 1280, 2304, 4352])
@pytest.mark.parametrize("steps", [0, 2, 6, 7, 14, 15, 40])
def test_var_gates_match_jax(S, steps):
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.float64, torch.float64)):
        assert TV.supported(S, steps, tdt) == JV.supported(S, steps, jdt)
        for Sc in (S // 2, max(S // 2, 128) + 128, 128):
            assert TVT.supported(S, Sc, steps, tdt) == JVT.supported(
                S, Sc, steps, jdt), (S, Sc, steps, tdt)


def test_var_kernel_options_raise():
    tc, _ = _kernel_planes("flux", 250, 256)
    u = torch.zeros((256, 256))
    with pytest.raises(NotImplementedError):
        TV.var_smooth(u, u, tc, 250, 1, box=(0, 249, 1, 249))
    with pytest.raises(NotImplementedError):
        TVT.var_smooth_restrict_fused(u, u, tc, 250, 256, 1,
                                      cbox=(1, 124, 1, 124))
    with pytest.raises(NotImplementedError):
        TVT.var_prolong_smooth_resnorm(u.double(), u.double(), u.double(),
                                       tc.double(), 250, 1)
    with pytest.raises(ValueError):
        TV.var_smooth_residual(u, u, tc[:4], 250, 1)
    with pytest.raises(ValueError):
        TVT.var_prolong_smooth_fused(u, u, u, tc, 250, 1, "sor")


def test_cpu_var_wrappers_run_plain_and_launch_nothing():
    kernels.reset_launch_counts()
    S, n = 256, 250
    tc, _ = _kernel_planes("galerkin", n, S)
    u, b = torch.from_numpy(_interior(S, n, 15)), torch.from_numpy(
        _interior(S, n, 16))
    assert TV.var_smooth(u, b, tc, n, 0) is u
    assert torch.equal(TV.var_smooth(u, b, tc, n, 2, "rbgs"),
                       TV.var_smooth_plain(u, b, tc, n, 2, "rbgs"))
    for g, w in zip(TVT.var_smooth_restrict_fused(u, b, tc, n, 256, 1),
                    TVT.var_smooth_restrict_plain(u, b, tc, n, 256, 1)):
        assert torch.equal(g, w)
    assert set(kernels.launch_counts().values()) == {0}
    assert {"var_smooth", "var_smooth_residual", "var_smooth_restrict_fused",
            "var_prolong_smooth_fused", "var_prolong_smooth_resnorm"} <= set(
                kernels.launch_counts())


# ---------------------------------------------------------------------------
# The new transfers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nf,Sf,Sc", [(64, 65, 33), (128, 256, 256),
                                      (250, 256, 128)])
def test_injection_and_p1_match_jax(nf, Sf, Sc):
    r = _interior(Sf, nf, 17, np.float64)
    e = _interior(Sc, nf // 2, 18, np.float64)
    np.testing.assert_array_equal(
        ops.restrict_injection(torch.from_numpy(r), nf, Sc).numpy(),
        np.asarray(jops.restrict_injection(jnp.asarray(r), nf, Sc)))
    np.testing.assert_allclose(
        ops.prolong_p1(torch.from_numpy(e), nf // 2, Sf).numpy(),
        np.asarray(jops.prolong_p1(jnp.asarray(e), nf // 2, Sf)),
        rtol=1e-15, atol=0)


# ---------------------------------------------------------------------------
# The slice: solve_diffusion and solve_helmholtz
# ---------------------------------------------------------------------------

def _configs(**kw):
    jkw, tkw = dict(kw), dict(kw)
    dtype = kw.get("dtype", "float32")
    jkw["dtype"] = getattr(jnp, dtype)
    tkw["dtype"] = getattr(torch, dtype)
    jkw.pop("use_kernels", None)
    return jmg.MultigridConfig(**jkw), tmg.MultigridConfig(**tkw)


def _coef(x, y):
    return 1.0 + 12.0 * x * (1.0 - x) * y * y


def _shift(x, y):
    return 30.0 * x * y + 2.0


def _hist(res):
    return _np(res.res_history)


@pytest.mark.parametrize("entry", ["diffusion", "helmholtz"])
@pytest.mark.parametrize("smoother", ["rbgs", "jacobi"])
def test_f64_solves_match_jax(entry, smoother):
    """Until-tol solves with a smoothed coarsest level: 60 sweeps there, as
    10 leave a 33^2 coarsest grid unsolved and both solves stall.  (The
    Chebyshev schedule unrolls its 60 coarse sweeps into the JAX program,
    a minute of compiling; the f32 tests below drive it.)"""
    cj, ct = _configs(finest_level=7, coarsest_level=5, dtype="float64",
                      smoother=smoother, nu1=1 if smoother == "rbgs" else 2,
                      nu2=1 if smoother == "rbgs" else 2,
                      coarse_solver="smooth", coarse_smooth_sweeps=60)
    if entry == "diffusion":
        rj = jmg.solve_diffusion(7, coefficient=_coef, config=cj, tol=1e-8)
        rt = tmg.solve_diffusion(7, coefficient=_coef, config=ct, tol=1e-8,
                                 device="cpu")
    else:
        rj = jmg.solve_helmholtz(7, shift=_shift, config=cj, tol=1e-8)
        rt = tmg.solve_helmholtz(7, shift=_shift, config=ct, tol=1e-8,
                                 device="cpu")
    assert rt.iterations == int(rj.iterations)
    assert rt.converged == bool(rj.converged) is True
    np.testing.assert_allclose(_hist(rt), _hist(rj), rtol=1e-10,
                               atol=F64_ATOL)
    np.testing.assert_allclose(_np(rt.u), _np(rj.u), rtol=0, atol=1e-12)


def test_f64_fmg_and_boundary_match_jax():
    cj, ct = _configs(finest_level=6, coarsest_level=5, dtype="float64",
                      coarse_solver="smooth")
    g = lambda x, y: 1.0 + x - 2.0 * y  # noqa: E731
    rj = jmg.solve_diffusion(6, coefficient=_coef, config=cj, boundary=g,
                             use_fmg=True, num_cycles=2, tol=None)
    rt = tmg.solve_diffusion(6, coefficient=_coef, config=ct, boundary=g,
                             use_fmg=True, num_cycles=2, tol=None,
                             device="cpu")
    np.testing.assert_allclose(_hist(rt), _hist(rj), rtol=1e-10,
                               atol=F64_ATOL)
    np.testing.assert_allclose(_np(rt.u), _np(rj.u), rtol=0, atol=1e-12)


@pytest.mark.parametrize("use_fmg", [False, True])
def test_f32_kernel_path_matches_jax(use_fmg):
    """The port's kernel path (its plain versions on the CPU, every level
    padded to 256 as the kernels need) against the JAX jnp route.  The
    kernels' arithmetic is not the operator's, so two cycles from zero, well
    above the float32 floor, agree to rtol 1e-3 (measured 1.1e-4).  The FMG
    guess's residual sits within a decade of the floor: its first cycle
    agrees to rtol 1e-2, as tests/test_torch_refine.py holds FMG."""
    kw = dict(finest_level=7, coarsest_level=5, smoother="rbgs", nu1=1,
              nu2=1)
    cj, ct = _configs(**kw)
    rj = jmg.solve_diffusion(7, coefficient=_coef, config=cj, num_cycles=2,
                             tol=None, use_fmg=use_fmg)
    kernels.reset_launch_counts()
    rt = tmg.solve_diffusion(7, coefficient=_coef, config=dataclasses.replace(
        ct, use_kernels=True), num_cycles=2, tol=None, use_fmg=use_fmg,
        device="cpu")
    assert set(kernels.launch_counts().values()) == {0}
    assert rt.u.shape == (256, 256)
    if use_fmg:
        np.testing.assert_allclose(_hist(rt)[:2], _hist(rj)[:2], rtol=1e-2)
    else:
        np.testing.assert_allclose(_hist(rt), _hist(rj), rtol=1e-3)
    uj = np.asarray(jmg.extract_solution(rj.u, 128))
    np.testing.assert_allclose(tmg.extract_solution(rt.u, 128).numpy(), uj,
                               rtol=0, atol=1e-5 * np.abs(uj).max())


def test_f32_helmholtz_kernel_path_matches_jax():
    kw = dict(finest_level=7, coarsest_level=5, smoother="chebyshev", nu1=3,
              nu2=2)
    cj, ct = _configs(**kw)
    rj = jmg.solve_helmholtz(7, shift=_shift, config=cj, num_cycles=2,
                             tol=None)
    rt = tmg.solve_helmholtz(7, shift=_shift, config=dataclasses.replace(
        ct, use_kernels=True), num_cycles=2, tol=None, device="cpu")
    np.testing.assert_allclose(_hist(rt), _hist(rj), rtol=1e-3)


def test_var_interop_round_trip():
    """A JAX Galerkin hierarchy carried across with its kernel planes: the
    port's until-tol solve on it equals the JAX one."""
    cj, ct = _configs(finest_level=6, coarsest_level=5, dtype="float64",
                      smoother="rbgs", nu1=1, nu2=1)
    pj = jmg.DiffusionProblem(cj, coefficient=_coef)
    levels = []
    for op in pj.hierarchy.levels:
        levels.append(dict(coef=np.asarray(op.coef),
                           inv_diag=np.asarray(op.inv_diag), n=op.n, S=op.S,
                           is_symmetric=op.is_symmetric,
                           coef_sym=np.asarray(JV._flat_coef(op))))
    hier = interop.var_hierarchy_from_numpy(
        levels, np.asarray(pj.hierarchy.coarse_inv))
    assert hier.levels[0].coef_sym.shape == (5, 65, 65)
    b = interop.tensor_from_numpy(np.asarray(pj.rhs()))
    rt = tmg.solve_until_tol(hier, ct, b, tol=1e-8)
    rj = jcycles.solve_until_tol(pj.hierarchy, cj, pj.rhs(), tol=1e-8)
    assert rt.iterations == int(rj.iterations) and rt.converged
    np.testing.assert_allclose(_hist(rt), _hist(rj), rtol=1e-3)


@pytest.mark.parametrize("kw", [{"mesh": object()}, {"u0": np.zeros(3)},
                                {"smooth_dtype": torch.bfloat16}])
def test_unported_var_front_door_options_raise(kw):
    kw = dict(kw)
    cfg = tmg.MultigridConfig(finest_level=5, coarsest_level=4,
                              smooth_dtype=kw.pop("smooth_dtype", None))
    err = ValueError if "u0" in kw else NotImplementedError
    with pytest.raises(err):
        tmg.solve_diffusion(5, config=cfg, device="cpu", **kw)
    if "u0" not in kw:
        with pytest.raises(NotImplementedError):
            tmg.solve_helmholtz(5, config=cfg, device="cpu", **kw)


def test_front_doors_default_to_the_card():
    """With no ``device`` the front doors run on the card; on a host without
    one they raise instead of returning a CPU result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is that card")
    cfg = tmg.MultigridConfig(finest_level=5, coarsest_level=4)
    for call in (lambda: tmg.solve_poisson(5),
                 lambda: tmg.solve_poisson(5, config=cfg, num_cycles=1),
                 lambda: tmg.solve_diffusion(5, config=cfg),
                 lambda: tmg.solve_helmholtz(5, config=cfg),
                 lambda: tmg.PoissonProblem(cfg),
                 lambda: tmg.DiffusionProblem(cfg),
                 lambda: tmg.HelmholtzProblem(cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert tmg.default_device("cpu") == torch.device("cpu")
    res = tmg.solve_poisson(5, config=cfg, num_cycles=1, device="cpu")
    assert res.u.device.type == "cpu"


# ---------------------------------------------------------------------------
# Dispatch: which wrapper each step of the path calls
# ---------------------------------------------------------------------------

SPIED = {TV: ["var_smooth", "var_smooth_residual"],
         TVT: ["var_smooth_restrict_fused", "var_prolong_smooth_fused",
               "var_prolong_smooth_resnorm"],
         TT: ["restrict_fw", "prolong_add"]}


@pytest.fixture
def calls(monkeypatch):
    """Counts of calls per wrapper, through spies on the kernel modules."""
    counts = {}
    for mod, names in SPIED.items():
        for name in names:
            counts[name] = 0

            def spy(*a, _fn=getattr(mod, name), _name=name, **kw):
                counts[_name] += 1
                return _fn(*a, **kw)
            monkeypatch.setattr(mod, name, spy)
    return counts


def var_solve_calls(cycles, pairs):
    """Wrapper calls of ``cycles`` until-tol or fixed cycles of the fused
    var path over ``pairs`` level pairs: K1v on each pair, K2v on each but
    the finest, whose K2v fuses the residual norm."""
    return {"var_smooth_restrict_fused": cycles * pairs,
            "var_prolong_smooth_fused": cycles * (pairs - 1),
            "var_prolong_smooth_resnorm": cycles}


def _solve(calls, cycles, **kw):
    cfg = tmg.MultigridConfig(finest_level=8, coarsest_level=5,
                              use_kernels=True, **kw)
    res = tmg.solve_diffusion(8, coefficient=_coef, config=cfg,
                              num_cycles=cycles, tol=None, device="cpu")
    want = dict.fromkeys(calls, 0)
    return res, want


def test_diffusion_dispatch_counts(calls):
    """The main path at a small depth: levels 8 -> 5 padded to 256, RB-GS
    (1, 1); per cycle the counts chip_smoke.py checks at 4097^2 (there with
    8 levels: 7 K1v, 6 K2v, 1 K2v-resnorm)."""
    _, want = _solve(calls, 2, smoother="rbgs", nu1=1, nu2=1)
    want.update(var_solve_calls(2, pairs=3))
    assert calls == want
    assert var_solve_calls(1, pairs=7) == {
        "var_smooth_restrict_fused": 7, "var_prolong_smooth_fused": 6,
        "var_prolong_smooth_resnorm": 1}


def test_injection_dispatch_counts(calls):
    """restriction="injection" runs every level pair unfused: the var
    smoother with the residual fused, the plain injection, the standalone
    prolong-add kernel and the var smoother."""
    _, want = _solve(calls, 2, smoother="rbgs", nu1=1, nu2=1,
                     restriction="injection")
    want.update(var_smooth_residual=2 * 3, prolong_add=2 * 3,
                var_smooth=2 * 3)
    assert calls == want


def test_smoothed_coarsest_dispatch_counts(calls):
    """Jacobi with a smoothed coarsest level: its 6 sweeps (steps + 2 <= 8
    at S = 256) run on the var smoother, once per cycle."""
    res, want = _solve(calls, 2, smoother="jacobi", coarse_solver="smooth",
                       coarse_smooth_sweeps=6)
    want.update(var_solve_calls(2, pairs=3), var_smooth=2)
    assert calls == want
    assert res.res_history[2] < res.res_history[0]
