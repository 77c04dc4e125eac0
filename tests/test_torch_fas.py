"""The port's nonlinear FAS tier against the JAX package, on the CPU, from
the same numpy inputs: the carried nonlinearities, the nonlinear operators
of ``core.nonlinear``, the solution injections, the FAS kernels' plain
versions against the Pallas kernels in interpret mode, the FAS cycles and
drivers on both routes, the three front doors in 2D and 3D, the linear-
reduction invariant, the ``interop`` carry, the gates, and the kernel
dispatch of the path, counted with spies on the wrappers.

Tolerances.  The operators evaluate the JAX package's jnp operations in
its order: in float64 they agree to 1e-12 relative (the exponentials of
XLA and of torch may differ in the last bit), in float32 to 1e-5 of the
largest value.  The kernels' plain versions follow the Pallas kernels'
order; in float32 they agree to 1e-5 * max|ref| (XLA:CPU may contract
multiply-adds into FMAs, torch does not), the resnorm to rtol 1e-5.
Solve histories agree in float32 to rtol 1e-3 while the residual is above
the float32 floor, in float64 to rtol 1e-10, and iteration counts exactly.
The injections are copies: bitwise.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import tpu_multigrid as jmg
from tpu_multigrid.core import nonlinear as jnl
from tpu_multigrid.core.operators import ConstStencilOp3D as JConst3
from tpu_multigrid.core.operators import poisson_op as jpoisson_op
from tpu_multigrid.cycles import fas as jfas
from tpu_multigrid.kernels import fas as JKF
from tpu_multigrid.kernels import fas3d as JKF3
from tpu_multigrid.problems import bratu as jbratu
from tpu_multigrid.problems import nldiffusion as jnld

import tpu_multigrid_torch as tmg
from tpu_multigrid_torch import interop
from tpu_multigrid_torch.core import nonlinear as tnl
from tpu_multigrid_torch.core.operators import ConstStencilOp3D, poisson_op
from tpu_multigrid_torch.cycles import fas as tfas
from tpu_multigrid_torch.kernels import fas as KF
from tpu_multigrid_torch.kernels import fas3d as KF3
from tpu_multigrid_torch.problems import bratu, nldiffusion

# One torch thread per test worker (see tests/test_torch_ops.py).
torch.set_num_threads(1)

LAM, GAMMA = 4.0, 2.0


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _grid(shape, n, seed, scale=1.0, dtype=np.float32):
    a = np.zeros(shape, dtype)
    inner = (slice(1, n),) * len(shape)
    a[inner] = scale * np.random.default_rng(seed).standard_normal(
        (n - 1,) * len(shape))
    return a


def _close(got, want, rel):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-300))


def _jphi(u):
    return -LAM * jnp.exp(u)


def _ja(u):
    return 1.0 + GAMMA * u * u


def _cubic(u):
    return u * u * u


def _dcubic(u):
    return 3.0 * u * u


def _jdtype(dtype):
    return getattr(jnp, dtype)


def _tdtype(dtype):
    return getattr(torch, dtype)


# ---------------------------------------------------------------------------
# The carried nonlinearities and the operators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_carried_nonlinearities_compute_the_jax_lambdas(dtype):
    """BratuNonlinearity is -lam exp(u) (the exponentials of XLA and torch
    to 2 ulp), QuadraticCoefficient 1 + gamma u^2 and its da bitwise."""
    u = np.random.default_rng(0).standard_normal(1000).astype(dtype)
    phi, a = tnl.BratuNonlinearity(LAM), tnl.QuadraticCoefficient(GAMMA)
    t, j = torch.from_numpy(u), jnp.asarray(u)
    np.testing.assert_allclose(_np(phi(t)), _np(_jphi(j)),
                               rtol=4 * np.finfo(dtype).eps)
    np.testing.assert_array_equal(_np(a(t)), _np(_ja(j)))
    np.testing.assert_array_equal(_np(a.da(t)), _np(2.0 * GAMMA * j))
    assert (phi.kind, phi.scalar) == (tnl.KIND_BRATU, LAM)
    assert (a.kind, a.scalar) == (tnl.KIND_QUADRATIC, GAMMA)


def _pointwise_pair(ndim, dtype, cubic=False):
    """The same pointwise operator in both packages, with a_dense: Bratu or
    the cubic reaction (phi and dphi distinct)."""
    n = 16 if ndim == 2 else 8
    jd = _jdtype(dtype)
    a = jmg.core.nonlinear.dense_poisson_matrix(n, ndim)
    if cubic:
        tp, td, jp, jd_ = _cubic, _dcubic, _cubic, _dcubic
    else:
        tp = td = tnl.BratuNonlinearity(LAM)
        jp = jd_ = _jphi
    if ndim == 2:
        jlin, tlin, diag = jpoisson_op(n, n + 1), poisson_op(n, n + 1), 4.0
    else:
        jlin, tlin, diag = JConst3(n, n + 1), ConstStencilOp3D(n, n + 1), 6.0
    jop = jnl.PointwiseNonlinearOp(jlin, jp, jd_, diag,
                                   jnp.asarray(a, jd))
    top = tnl.PointwiseNonlinearOp(tlin, tp, td, diag,
                                   torch.tensor(a, dtype=_tdtype(dtype)))
    return n, jop, top


@pytest.mark.parametrize("dtype,rel", [("float64", 1e-12),
                                       ("float32", 1e-5)])
@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("cubic", [False, True])
def test_pointwise_op_matches_jax(dtype, rel, ndim, cubic):
    """apply, residual, three Jacobi-Newton sweeps and the three-step dense
    Newton coarse solve."""
    n, jop, top = _pointwise_pair(ndim, dtype, cubic)
    shape = (n + 1,) * ndim
    u = _grid(shape, n, 1, 0.3, dtype)
    b = _grid(shape, n, 2, 0.05, dtype)
    tu, tb = torch.from_numpy(u), torch.from_numpy(b)
    ju, jb = jnp.asarray(u), jnp.asarray(b)
    _close(top.apply(tu), jop.apply(ju), rel)
    _close(top.residual(tu, tb), jop.residual(ju, jb), rel)
    _close(top.nsmooth(tu, tb, omega=2 / 3, sweeps=3),
           jop.nsmooth(ju, jb, omega=2 / 3, sweeps=3), rel)
    _close(top.coarse_newton(tu, tb), jop.coarse_newton(ju, jb), rel)
    assert top.nsmooth(tu, tb, omega=2 / 3, sweeps=0) is tu


@pytest.mark.parametrize("dtype,rel", [("float64", 1e-12),
                                       ("float32", 1e-5)])
@pytest.mark.parametrize("ndim", [2, 3])
def test_quasilinear_op_matches_jax(dtype, rel, ndim):
    """The flux operator's apply, residual and Picard-Jacobi sweeps."""
    n = 16 if ndim == 2 else 8
    shape = (n + 1,) * ndim
    ta = tnl.QuadraticCoefficient(GAMMA)
    if ndim == 2:
        top = tnl.QuasilinearFluxOp(n, n + 1, ta, ta.da)
        jop = jnl.QuasilinearFluxOp(n, n + 1, _ja, None)
    else:
        top = tnl.QuasilinearFluxOp3(n, n + 1, ta, ta.da)
        jop = jnl.QuasilinearFluxOp3(n, n + 1, _ja, None)
    u = _grid(shape, n, 3, 0.5, dtype)
    b = _grid(shape, n, 4, 0.05, dtype)
    tu, tb = torch.from_numpy(u), torch.from_numpy(b)
    ju, jb = jnp.asarray(u), jnp.asarray(b)
    _close(top.apply(tu), jop.apply(ju), rel)
    _close(top.residual(tu, tb), jop.residual(ju, jb), rel)
    _close(top.nsmooth(tu, tb, omega=2 / 3, sweeps=3),
           jop.nsmooth(ju, jb, omega=2 / 3, sweeps=3), rel)


@pytest.mark.parametrize("S,n,Sc", [(17, 16, 9), (256, 64, 256),
                                    (768, 512, 512)])
def test_inject_solution_matches_jax_bitwise(S, n, Sc):
    u = _grid((S, S), n, 5)
    np.testing.assert_array_equal(
        _np(tnl.inject_solution(torch.from_numpy(u), n, Sc)),
        np.asarray(jnl.inject_solution(jnp.asarray(u), n, Sc)))


@pytest.mark.parametrize("shape,n,shape_c", [
    ((9, 9, 9), 8, (5, 5, 5)), ((48, 48, 128), 32, (32, 32, 128)),
    ((144, 144, 256), 128, (80, 80, 128))])
def test_inject_solution3_matches_jax_bitwise(shape, n, shape_c):
    u = _grid(shape, n, 6)
    np.testing.assert_array_equal(
        _np(tnl.inject_solution3(torch.from_numpy(u), n, shape_c)),
        np.asarray(jnl.inject_solution3(jnp.asarray(u), n, shape_c)))


# ---------------------------------------------------------------------------
# The kernels' plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

def _nl(family):
    """(torch args, JAX args, entry prefix) of a family's entries."""
    if family == "bratu":
        phi = tnl.BratuNonlinearity(LAM)
        return (phi, phi), (_jphi, _jphi), "fas_"
    if family == "cubic":
        return (_cubic, _dcubic), (_cubic, _dcubic), "fas_"
    return (tnl.QuadraticCoefficient(GAMMA),), (_ja,), "qfas_"


def _entries(tmod, jmod, prefix, name, targs, jargs, tnl_, jnl_, extra):
    """(port result, JAX result in interpret mode) of one entry."""
    with pltpu.force_tpu_interpret_mode():
        want = getattr(jmod, prefix + name)(*jargs, *jnl_, *extra)
    return getattr(tmod, prefix + name)(*targs, *tnl_, *extra), want


# test_fas_kernels.py's cases: multi-tile rows, a non-power-of-two
# interior, edge clamping.
CASES2 = [(512, 256, 384), (512, 500, 384)]


@pytest.mark.parametrize("S,n,Sc", CASES2)
@pytest.mark.parametrize("family", ["bratu", "quadratic", "cubic"])
def test_fas_plain_matches_pallas(S, n, Sc, family):
    tnl_, jnl_, prefix = _nl(family)
    extra = ((1.0 / n) ** 2, 4.0) if prefix == "fas_" else ()
    u, b = _grid((S, S), n, 0, 0.1), _grid((S, S), n, 1)
    ec = _grid((Sc, Sc), n // 2, 3, 0.05)
    t = tuple(map(torch.from_numpy, (u, b, ec)))
    j = tuple(map(jnp.asarray, (u, b, ec)))
    got, want = _entries(KF, JKF, prefix, "smooth_restrict",
                         (t[0], t[1], n, Sc, 2, 2 / 3),
                         (j[0], j[1], n, Sc, 2, 2 / 3), tnl_, jnl_, extra)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)
    got, want = _entries(KF, JKF, prefix, "prolong_smooth_resnorm",
                         (*t, n, 2, 2 / 3), (*j, n, 2, 2 / 3), tnl_, jnl_,
                         extra)
    _close(got[0], want[0], 1e-5)
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-5)
    k2 = getattr(KF, prefix + "prolong_smooth")(*t, n, 2, 2 / 3, *tnl_,
                                                *extra)
    assert torch.equal(k2, got[0])


@pytest.mark.parametrize("family", ["bratu", "quadratic"])
def test_fas3_plain_matches_pallas(family):
    """test_fas3d_kernels.py's shapes: (144, 144, 256) -> (80, 80, 128)."""
    tnl_, jnl_, prefix = _nl(family)
    shape, n, shape_c = (144, 144, 256), 128, (80, 80, 128)
    extra = ((1.0 / n) ** 2, 6.0) if prefix == "fas_" else ()
    u, b = _grid(shape, n, 0, 0.1), _grid(shape, n, 1)
    ec = _grid(shape_c, n // 2, 3, 0.05)
    t = tuple(map(torch.from_numpy, (u, b, ec)))
    j = tuple(map(jnp.asarray, (u, b, ec)))
    got, want = _entries(KF3, JKF3, prefix, "smooth_restrict3",
                         (t[0], t[1], n, shape_c, 2, 2 / 3),
                         (j[0], j[1], n, shape_c, 2, 2 / 3), tnl_, jnl_,
                         extra)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)
    got, want = _entries(KF3, JKF3, prefix, "prolong_smooth_resnorm3",
                         (*t, n, 2, 2 / 3), (*j, n, 2, 2 / 3), tnl_, jnl_,
                         extra)
    _close(got[0], want[0], 1e-5)
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-5)
    k2 = getattr(KF3, prefix + "prolong_smooth3")(*t, n, 2, 2 / 3, *tnl_,
                                                  *extra)
    assert torch.equal(k2, got[0])


def test_fas3_plain_matches_pallas_small_window():
    """The smallest 3D layout, (48, 48, 128) -> (32, 32, 128), 3 sweeps."""
    tnl_, jnl_, prefix = _nl("bratu")
    shape, n, shape_c = (48, 48, 128), 32, (32, 32, 128)
    extra = ((1.0 / n) ** 2, 6.0)
    u, b = _grid(shape, n, 7, 0.1), _grid(shape, n, 8)
    got, want = _entries(KF3, JKF3, prefix, "smooth_restrict3",
                         (torch.from_numpy(u), torch.from_numpy(b), n,
                          shape_c, 3, 2 / 3),
                         (jnp.asarray(u), jnp.asarray(b), n, shape_c, 3,
                          2 / 3), tnl_, jnl_, extra)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


@pytest.mark.parametrize("S,Sc,steps", [
    (256, 256, 2), (256, 128, 2), (512, 256, 2), (768, 512, 14),
    (768, 512, 15), (4352, 2304, 2), (300, 256, 1), (4352, 2048, 2)])
def test_fas_gate_admits_what_jax_admits(S, Sc, steps):
    assert KF.fas_supported(S, Sc, steps, torch.float32) == bool(
        JKF.fas_supported(S, Sc, steps, jnp.float32))
    assert not KF.fas_supported(S, Sc, steps, torch.float64)


@pytest.mark.parametrize("shape,shape_c,steps", [
    ((144, 144, 256), (80, 80, 128), 2), ((48, 48, 128), (32, 32, 128), 2),
    ((528, 528, 640), (272, 272, 384), 2),
    ((272, 272, 384), (144, 144, 256), 14),
    ((272, 272, 384), (144, 144, 256), 15)])
def test_fas3_gate_admits_what_jax_admits(shape, shape_c, steps):
    assert KF3.fas3_supported(shape, shape_c, steps, torch.float32) == bool(
        JKF3.fas3_supported(shape, shape_c, steps, jnp.float32))


# ---------------------------------------------------------------------------
# The cycles and drivers, on both routes
# ---------------------------------------------------------------------------

def _configs(**kw):
    """(JAX config, port config on the kernel route)."""
    dtype = kw.pop("dtype", "float32")
    jc = jmg.MultigridConfig(dtype=_jdtype(dtype), **kw)
    tc = tmg.MultigridConfig(dtype=_tdtype(dtype), use_kernels=True, **kw)
    return jc, tc


def _problems(family, jc, tc, ndim=2, pad=True):
    """The same problem in both packages, levels padded for the kernels."""
    if ndim == 3:
        kw = dict(align=16, min_pad_level=0, lane_align=128) if pad else {}
        if family == "bratu":
            return (jbratu.Bratu3DProblem(jc, lam=LAM, **kw),
                    bratu.Bratu3DProblem(tc, lam=LAM, device="cpu", **kw))
        return (jnld.QuasilinearDiffusion3DProblem(jc, gamma=GAMMA, **kw),
                nldiffusion.QuasilinearDiffusion3DProblem(
                    tc, gamma=GAMMA, device="cpu", **kw))
    kw = dict(align=256, min_pad_level=0) if pad else {}
    if family == "bratu":
        return (jbratu.BratuProblem(jc, lam=LAM, **kw),
                bratu.BratuProblem(tc, lam=LAM, device="cpu", **kw))
    return (jnld.QuasilinearDiffusionProblem(jc, gamma=GAMMA, **kw),
            nldiffusion.QuasilinearDiffusionProblem(tc, gamma=GAMMA,
                                                    device="cpu", **kw))


def _family_config(family, **kw):
    if family == "quadratic":
        kw.update(coarse_solver="smooth", coarse_smooth_sweeps=40)
    return _configs(**kw)


@pytest.mark.parametrize("family", ["bratu", "quadratic"])
def test_f32_cycles_match_jax_on_both_routes(family):
    """Level 7 padded to 256 (4 fused pairs), forcing 4: one fas_cycle from
    a seeded iterate, fas_solve_fixed (3 cycles), fas_solve_until_tol to
    1e-3 (identical iteration counts; the float32 floor of this h^2-scaled
    right-hand side is near 2e-4) and fmg_fas, on the kernel route (the
    plain versions here) and the plain route, against the JAX jnp route on
    the same padded levels."""
    jc, tc = _family_config(family, finest_level=7, coarsest_level=3)
    jp, tp = _problems(family, jc, tc)
    jp.forcing = tp.forcing = 4.0
    jh, th = jp.hierarchy, tp.hierarchy
    jb, tb = jp.rhs(), tp.rhs()
    np.testing.assert_array_equal(_np(tb), np.asarray(jb))
    assert tfas._use_fas_super_kernels(th.levels[0], th.levels[1], tc,
                                       torch.float32)
    u0 = _grid((256, 256), 128, 9, 0.1)
    j_cycle = jfas.fas_cycle(jh, jc, jnp.asarray(u0), jb)
    j_fixed = jfas.fas_solve_fixed(jh, jc, jb, 3)
    j_tol = jfas.fas_solve_until_tol(jh, jc, jb, tol=1e-3)
    j_fmg = jfas.fmg_fas(jh, jc, jp.rhs_all_levels())
    for cfg in (tc, dataclasses.replace(tc, use_kernels=False)):
        _close(tfas.fas_cycle(th, cfg, torch.from_numpy(u0), tb), j_cycle,
               1e-4)
        rt = tfas.fas_solve_fixed(th, cfg, tb, 3)
        np.testing.assert_allclose(_np(rt.res_history),
                                   _np(j_fixed.res_history), rtol=1e-3)
        rt = tfas.fas_solve_until_tol(th, cfg, tb, tol=1e-3)
        assert rt.iterations == int(j_tol.iterations) and rt.converged
        np.testing.assert_allclose(_np(rt.res_history)[:4],
                                   _np(j_tol.res_history)[:4], rtol=1e-3)
        _close(tfas.fmg_fas(th, cfg, tp.rhs_all_levels()), j_fmg, 1e-4)


@pytest.mark.parametrize("family", ["bratu", "quadratic"])
def test_f32_3d_cycles_match_jax(family):
    """Level 7 in 3D on the kernels' layout: the pair (144, 144, 256) ->
    (80, 80, 128) fuses, the others run plain; 2 fixed cycles on the kernel
    route against the JAX jnp route."""
    jc, tc = _family_config(family, finest_level=7, coarsest_level=3)
    jp, tp = _problems(family, jc, tc, ndim=3)
    th = tp.hierarchy
    assert tfas._use_fas_super_kernels(th.levels[0], th.levels[1], tc,
                                       torch.float32)
    assert not tfas._use_fas_super_kernels(th.levels[1], th.levels[2], tc,
                                           torch.float32)
    rt = tfas.fas_solve_fixed(th, tc, tp.rhs(), 2)
    rj = jfas.fas_solve_fixed(jp.hierarchy, jc, jp.rhs(), 2)
    np.testing.assert_allclose(_np(rt.res_history), _np(rj.res_history),
                               rtol=1e-3)
    _close(rt.u, rj.u, 1e-4)


@pytest.mark.parametrize("family", ["bratu", "quadratic"])
def test_f64_solve_until_tol_matches_jax(family):
    """Level 6 in float64 on the plain route, tol 1e-10: identical
    iteration counts, histories to rtol 1e-10 above the float64 floor
    (1e-12 of the initial residual), the solution to 1e-12."""
    jc, tc = _family_config(family, finest_level=6, coarsest_level=3,
                            dtype="float64")
    jp, tp = _problems(family, jc, tc, pad=False)
    jp.forcing = tp.forcing = 4.0
    tc = dataclasses.replace(tc, use_kernels=False)
    rt = tfas.fas_solve_until_tol(tp.hierarchy, tc, tp.rhs(), tol=1e-10)
    rj = jfas.fas_solve_until_tol(jp.hierarchy, jc, jp.rhs(), tol=1e-10)
    assert rt.iterations == int(rj.iterations) and rt.converged
    hist = _np(rj.res_history)
    np.testing.assert_allclose(_np(rt.res_history), hist, rtol=1e-10,
                               atol=1e-12 * hist[0])
    _close(rt.u, rj.u, 1e-12)


@pytest.mark.parametrize("cyc", ["V", "W", "F"])
def test_fas_reduces_to_linear_cycle(cyc):
    """With phi = 0 one FAS cycle equals one linear cycle (the JAX package's
    test_fas_reduces_to_linear_cycle), in float64 to 1e-12: the coarse
    solve of N_c(u_c) = N_c(u_hat) + r_hat from u_hat is the correction-
    scheme coarse solve shifted by u_hat (the smoothed coarsest level is
    affine, so the equivalence holds exactly)."""
    tc = tmg.MultigridConfig(finest_level=5, coarsest_level=2,
                             coarse_solver="smooth", coarse_smooth_sweeps=7,
                             cycle=cyc, dtype=torch.float64)
    zero = torch.zeros_like
    th = bratu.build_pointwise_hierarchy(tc, zero, zero)
    u0 = torch.from_numpy(_grid((33, 33), 32, 10, 1.0, np.float64))
    b = tmg.problems.poisson_rhs(32, 33, 4.0, torch.float64)
    _close(tfas.fas_cycle(th, tc, u0, b),
           tmg.cycle(tmg.build_poisson_hierarchy(tc), tc, u0, b), 1e-12)


# ---------------------------------------------------------------------------
# The front doors
# ---------------------------------------------------------------------------

def _same_result(rt, rj):
    """Equal iteration counts and outcomes; histories to rtol 1e-3 over the
    first 3 cycles, above the float32 floor."""
    assert rt.iterations == int(rj.iterations)
    assert rt.converged == bool(rj.converged)
    np.testing.assert_allclose(_np(rt.res_history)[:4],
                               _np(rj.res_history)[:4], rtol=1e-3)


@pytest.mark.parametrize("door", ["bratu", "quasilinear", "cubic"])
@pytest.mark.parametrize("ndim", [2, 3])
def test_front_doors_match_jax(door, ndim):
    """The three doors with their defaults on the CPU (the plain route,
    float32) against the JAX doors: level 6 in 2D and level 5 in 3D to tol
    1e-3 (above the float32 floor), FMG first for the quasilinear door."""
    level = 6 if ndim == 2 else 5
    kw = dict(ndim=ndim, tol=1e-3)
    if door == "bratu":
        rj = jmg.solve_bratu(level, lam=LAM, **kw)
        rt = tmg.solve_bratu(level, lam=LAM, device="cpu", **kw)
    elif door == "quasilinear":
        rj = jmg.solve_quasilinear_diffusion(level, gamma=GAMMA,
                                             use_fmg=True, **kw)
        rt = tmg.solve_quasilinear_diffusion(level, gamma=GAMMA,
                                             use_fmg=True, device="cpu",
                                             **kw)
    else:
        rj = jmg.solve_nonlinear_poisson(level, phi=_cubic, dphi=_dcubic,
                                         **kw)
        rt = tmg.solve_nonlinear_poisson(level, phi=_cubic, dphi=_dcubic,
                                         device="cpu", **kw)
    _same_result(rt, rj)
    assert rt.converged
    _close(rt.u, rj.u, 1e-4)


def test_bratu_door_on_the_kernel_route_matches_jax():
    """solve_bratu(7) with use_kernels=True (levels padded to 256, the
    kernels' plain versions here) against the JAX jnp door, to tol 1e-3
    (the float32 floor is near 2e-4), and FMG-FAS with three cycles (the
    histories to rtol 1e-2 over the first 2)."""
    jc, tc = _configs(finest_level=7, coarsest_level=3)
    rj = jmg.solve_bratu(7, lam=LAM, config=jc, tol=1e-3)
    rt = tmg.solve_bratu(7, lam=LAM, config=tc, tol=1e-3, device="cpu")
    assert rt.u.shape == (256, 256)
    _same_result(rt, rj)
    _close(tmg.extract_solution(rt.u, 128),
           jmg.extract_solution(rj.u, 128), 1e-4)
    rj = jmg.solve_bratu(7, lam=LAM, config=jc, use_fmg=True, num_cycles=3,
                         tol=None)
    rt = tmg.solve_bratu(7, lam=LAM, config=tc, use_fmg=True, num_cycles=3,
                         tol=None, device="cpu")
    np.testing.assert_allclose(_np(rt.res_history)[:3],
                               _np(rj.res_history)[:3], rtol=1e-2)


def test_interop_carries_a_jax_fas_hierarchy():
    """A JAX Bratu hierarchy (2D, dense-Newton coarsest) and a 3D
    quasilinear one carried across by fas_hierarchy_from_numpy: the port's
    solves on them equal its solves on its own hierarchies bitwise."""
    jc, tc = _configs(finest_level=6, coarsest_level=3, dtype="float64")
    tc = dataclasses.replace(tc, use_kernels=False)
    jp = jbratu.BratuProblem(jc, lam=LAM, forcing=4.0)
    jh = jp.hierarchy
    hier = interop.fas_hierarchy_from_numpy(
        [(op.n, op.S) for op in jh.levels], "bratu", LAM,
        np.asarray(jh.levels[-1].a_dense))
    tp = bratu.BratuProblem(tc, lam=LAM, forcing=4.0, device="cpu")
    u, b = interop.fas_state_from_numpy(
        *interop.fas_state_to_numpy(jnp.zeros_like(jp.rhs()), jp.rhs()))
    assert torch.equal(b, tp.rhs()) and not u.any()
    assert torch.equal(hier.levels[-1].a_dense, tp.hierarchy.levels[-1].a_dense)
    r1 = tfas.fas_solve_fixed(hier, tc, b, 3, u0=u)
    r2 = tfas.fas_solve_fixed(tp.hierarchy, tc, b, 3)
    assert torch.equal(r1.u, r2.u)

    jc3, tc3 = _family_config("quadratic", finest_level=5, coarsest_level=3)
    jp3, tp3 = _problems("quadratic", jc3, tc3, ndim=3)
    hier3 = interop.fas_hierarchy_from_numpy(
        [(op.n, op.S, op.Sx) for op in jp3.hierarchy.levels], "quadratic",
        GAMMA)
    assert [op.grid_shape for op in hier3.levels] == [
        op.grid_shape for op in tp3.hierarchy.levels]
    b3 = interop.tensor_from_numpy(np.asarray(jp3.rhs()))
    assert torch.equal(b3, tp3.rhs())
    assert torch.equal(tfas.fas_solve_fixed(hier3, tc3, b3, 2).u,
                       tfas.fas_solve_fixed(tp3.hierarchy, tc3, b3, 2).u)
    with pytest.raises(ValueError):
        interop.fas_hierarchy_from_numpy([(8, 9)], "cubic", 1.0)


@pytest.mark.parametrize("case", ["mesh", "dist_path", "own_phi", "own_a",
                                  "gate", "ndim", "tol"])
def test_unported_and_refused_options_raise(case):
    """mesh= and dist_path="pallas" are not ported (NotImplementedError);
    use_kernels=True with a caller's own nonlinearity raises ValueError at
    the door and at the cycle's gate; a bad ndim and no stopping rule
    raise ValueError."""
    cfg = tmg.MultigridConfig(finest_level=6, coarsest_level=3,
                              use_kernels=True)
    if case == "mesh":
        with pytest.raises(NotImplementedError):
            tmg.solve_bratu(6, mesh=object(), device="cpu")
    elif case == "dist_path":
        with pytest.raises(NotImplementedError):
            tmg.solve_bratu(6, dist_path="pallas", device="cpu")
    elif case == "own_phi":
        with pytest.raises(ValueError, match="carry only"):
            tmg.solve_nonlinear_poisson(6, phi=_cubic, dphi=_dcubic,
                                        config=cfg, device="cpu")
    elif case == "own_a":
        with pytest.raises(ValueError, match="carry only"):
            tmg.solve_quasilinear_diffusion(6, a=lambda u: 1.0 + u * u,
                                            config=cfg, device="cpu")
    elif case == "gate":
        p = bratu.NonlinearPoissonProblem(
            dataclasses.replace(cfg, use_kernels=False), phi=_cubic,
            dphi=_dcubic, device="cpu", align=256, min_pad_level=0)
        with pytest.raises(ValueError, match="carry only"):
            tfas.fas_cycle(p.hierarchy, cfg, p.rhs(), p.rhs())
    elif case == "ndim":
        with pytest.raises(ValueError):
            tmg.solve_bratu(6, ndim=4, device="cpu")
    else:
        with pytest.raises(ValueError):
            tmg.solve_bratu(6, tol=None, device="cpu")


def test_front_doors_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is that card")
    for call in (lambda: tmg.solve_bratu(5),
                 lambda: tmg.solve_quasilinear_diffusion(5, ndim=3),
                 lambda: tmg.BratuProblem(tmg.MultigridConfig(5))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_default_config_turns_the_kernels_on_only_on_the_card():
    """With config=None the doors pick Jacobi (2, 2) at coarsest level 3 and
    the kernels off on the CPU; the quasilinear door smooths its coarsest
    level with 40 sweeps; a non-Jacobi smoother warns."""
    from tpu_multigrid_torch import api
    dev = torch.device("cpu")
    c = api._fas_config(None, 7, dev, True, None, "jnp", 2)
    assert (c.use_kernels, c.nu1, c.nu2, c.coarsest_level) == (False, 2, 2,
                                                                3)
    c = api._fas_config(None, 7, torch.device("cuda"), True, None, "jnp", 2)
    assert c.use_kernels
    c = api._fas_config(None, 7, torch.device("cuda"), False, None, "jnp", 2)
    assert not c.use_kernels
    cfg = tmg.MultigridConfig(finest_level=5, coarsest_level=3,
                              smoother="rbgs")
    with pytest.warns(UserWarning, match="ignored"):
        tmg.solve_bratu(5, config=cfg, num_cycles=1, tol=None, device="cpu")


# ---------------------------------------------------------------------------
# Dispatch: which wrapper each step of the path calls
# ---------------------------------------------------------------------------

FAS_ENTRIES = list(KF.LAUNCHES) + list(KF3.LAUNCHES)


@pytest.fixture
def launched(monkeypatch):
    """Calls per FAS wrapper (one launch each on the card at these depths)."""
    counts = dict.fromkeys(FAS_ENTRIES, 0)
    for mod in (KF, KF3):
        for name in mod.LAUNCHES:
            def spy(*a, _fn=getattr(mod, name), _name=name, **kw):
                counts[_name] += 1
                return _fn(*a, **kw)
            monkeypatch.setattr(mod, name, spy)
    return counts


def fas_launches(prefix, cycles, pairs, suffix=""):
    """Launches of ``cycles`` FAS cycles over ``pairs`` fused pairs: K1f on
    each, K2f on each but the finest, whose K2f fuses the residual norm
    (chip_smoke.py checks the same formula)."""
    want = dict.fromkeys(FAS_ENTRIES, 0)
    want[prefix + "smooth_restrict" + suffix] = cycles * pairs
    want[prefix + "prolong_smooth" + suffix] = cycles * (pairs - 1)
    want[prefix + "prolong_smooth_resnorm" + suffix] = cycles
    return want


@pytest.mark.parametrize("family", ["bratu", "quadratic"])
def test_2d_dispatch_counts(launched, family):
    """Level 7 padded to 256: 4 fused pairs per cycle; 2 fixed cycles."""
    door = (tmg.solve_bratu if family == "bratu"
            else tmg.solve_quasilinear_diffusion)
    cfg = tmg.MultigridConfig(finest_level=7, coarsest_level=3,
                              use_kernels=True)
    door(7, config=cfg, num_cycles=2, tol=None, device="cpu")
    prefix = "fas_" if family == "bratu" else "qfas_"
    assert launched == fas_launches(prefix, 2, pairs=4)


def test_3d_dispatch_counts(launched):
    """3D level 7 on the kernels' layout: only the finest pair fuses (the
    coarser levels are 128 wide); W cycles run it once per cycle too."""
    cfg = tmg.MultigridConfig(finest_level=7, coarsest_level=3,
                              use_kernels=True, cycle="W")
    tmg.solve_bratu(7, ndim=3, lam=LAM, config=cfg, num_cycles=1, tol=None,
                    device="cpu")
    assert launched == fas_launches("fas_", 1, pairs=1, suffix="3")


def test_plain_route_and_own_callables_launch_nothing(launched):
    """use_kernels=False, a caller's own phi on the door's default config,
    and f64 launch no FAS kernel."""
    tmg.solve_nonlinear_poisson(7, phi=_cubic, dphi=_dcubic, num_cycles=1,
                                tol=None, device="cpu")
    cfg = tmg.MultigridConfig(finest_level=7, coarsest_level=3,
                              use_kernels=True, dtype=torch.float64)
    tmg.solve_bratu(7, config=cfg, num_cycles=1, tol=None, device="cpu")
    assert set(launched.values()) == {0}
