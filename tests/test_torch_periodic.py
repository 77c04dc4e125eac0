"""The port's periodic path against the JAX package, on the CPU, from the
same numpy inputs: the torus operators ``PeriodicOp`` and ``PeriodicOp3``,
the pseudo-inverses and right-hand sides, the extended-block helpers of the
fused tier, K1-local and K2-local's plain versions against the Pallas
kernels in interpret mode, the gates, the fused tier against the JAX fused
tier and against the JAX protocol path, the two front doors, the
``interop`` carry, the raises, and the kernel dispatch of the fused tier,
counted with spies on the wrappers.

Tolerances.  The torus operators evaluate the JAX package's jnp operations
in its order: float64 agrees to 1e-12 relative, float32 to 1e-6 of the
largest value.  The pseudo-inverses come from the same numpy call and the
extended-block helpers copy values: bitwise.  The kernels' plain versions
follow the Pallas kernels' order on the owned region; in float32 they agree
to 1e-5 * max|ref| (XLA:CPU may contract multiply-adds into FMAs, torch
does not), the resnorm to rtol 1e-5.  Fused-tier histories agree to rtol
3e-3 and atol 2e-4 r0, as the JAX package's own fused tests hold its tier
against its protocol path (the float32 floor of this h^2-scaled right-hand
side is ~2e-4 of r0 at level 8, where the Pallas and plain roundings part),
and the iterates to 2e-5 of max|u|.  Float64 door iterates agree to 1e-10
of max|u| with identical until-tol counts, on a smoothed coarsest level:
both packages store the pseudo-inverse in float32 and apply it in
different orders, which parts float64 iterates by ~1e-9 (the float32
route holds the pseudo-inverse); their residual norms, float64
in both packages, are stored in float32 histories, so those agree to one
float32 ulp (rtol 1.2e-7), and near the float64 floor to 1e-14 |b| (the
roundoff of evaluating b - A u).  The mean-zero gauge of a float32 V-cycle
iterate holds to 1e-6 of max|u| (the float32 pseudo-inverse solves move the
mean by rounding, W-cycles more often: ~1e-5 on both packages at level 10).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import tpu_multigrid as jmg
from tpu_multigrid.cycles import periodic_fused as jpf
from tpu_multigrid.cycles import solve_fixed as jsolve_fixed
from tpu_multigrid.kernels import local as JL
from tpu_multigrid.problems import periodic as jper
from tpu_multigrid.problems import periodic3d as jper3

import tpu_multigrid_torch as tmg
from tpu_multigrid_torch import interop
from tpu_multigrid_torch.core import ops
from tpu_multigrid_torch.cycles import periodic_fused as tpf
from tpu_multigrid_torch.kernels import local as KL
from tpu_multigrid_torch.problems import periodic, periodic3d

# One torch thread per test worker (see tests/test_torch_ops.py).
torch.set_num_threads(1)

DT = {np.float64: (jnp.float64, torch.float64),
      np.float32: (jnp.float32, torch.float32)}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want, rel):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-300))


def _xp(x):
    return torch if isinstance(x, torch.Tensor) else jnp


def forcing(x, y):
    """8 pi^2 sin(2 pi x) cos(2 pi y): zero mean on the torus."""
    xp = _xp(x)
    return 8 * math.pi ** 2 * xp.sin(2 * math.pi * x) * xp.cos(2 * math.pi * y)


def forcing3(x, y, z):
    xp = _xp(x)
    return 12 * math.pi ** 2 * (xp.sin(2 * math.pi * x)
                                * xp.sin(2 * math.pi * y)
                                * xp.cos(2 * math.pi * z))


def poly_forcing(x, y):
    """Arithmetic only, so both packages evaluate it bitwise alike."""
    return (x * (1.0 - x) - y * y) * 3.0


def _cfgs(level, coarsest, dtype=np.float32, **kw):
    jd, td = DT[dtype]
    kernels = kw.pop("kernels", False)
    return (jmg.MultigridConfig(finest_level=level, coarsest_level=coarsest,
                                dtype=jd, use_pallas=kernels, **kw),
            tmg.MultigridConfig(finest_level=level, coarsest_level=coarsest,
                                dtype=td, use_kernels=kernels, **kw))


# ---------------------------------------------------------------------------
# The torus operators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,dtype,rel", [(16, np.float64, 1e-12),
                                         (32, np.float64, 1e-12),
                                         (32, np.float32, 1e-6)])
def test_periodic_op_matches_jax(n, dtype, rel):
    rng = np.random.default_rng(n)
    u, b = (rng.standard_normal((n, n)).astype(dtype) for _ in range(2))
    ec = rng.standard_normal((n // 2, n // 2)).astype(dtype)
    jop, top = jper.PeriodicOp(n), periodic.PeriodicOp(n)
    jc, jf = jper.PeriodicOp(n // 2), jper.PeriodicOp(n)
    tc = periodic.PeriodicOp(n // 2)
    ju, jb, jec = (jnp.asarray(a) for a in (u, b, ec))
    tu, tb, tec = (torch.tensor(a) for a in (u, b, ec))
    _close(top.apply(tu), jop.apply(ju), rel)
    _close(top.residual(tu, tb), jop.residual(ju, jb), rel)
    cheb = ops.chebyshev_omegas(3, 0.4)
    for sm, om, sweeps in (("jacobi", 2.0 / 3.0, 2), ("jacobi", cheb, 3),
                           ("jacobi", cheb[:2], 3), ("rbgs", None, 2)):
        _close(top.smooth(tu, tb, smoother=sm, omega=om, sweeps=sweeps),
               jop.smooth(ju, jb, smoother=sm, omega=om, sweeps=sweeps), rel)
    _close(tc.restrict_into(tu, top), jc.restrict_into(ju, jf), rel)
    _close(tc.prolong_add_into(tu, tec, top),
           jc.prolong_add_into(ju, jec, jf), rel)
    assert top.grid_shape == (n, n) and top.S == n


@pytest.mark.parametrize("n,dtype,rel", [(8, np.float64, 1e-12),
                                         (16, np.float64, 1e-12),
                                         (16, np.float32, 1e-6)])
def test_periodic_op3_matches_jax(n, dtype, rel):
    rng = np.random.default_rng(n)
    u, b = (rng.standard_normal((n,) * 3).astype(dtype) for _ in range(2))
    ec = rng.standard_normal((n // 2,) * 3).astype(dtype)
    jop, top = jper3.PeriodicOp3(n), periodic3d.PeriodicOp3(n)
    jc, tc = jper3.PeriodicOp3(n // 2), periodic3d.PeriodicOp3(n // 2)
    ju, jb, jec = (jnp.asarray(a) for a in (u, b, ec))
    tu, tb, tec = (torch.tensor(a) for a in (u, b, ec))
    _close(top.apply(tu), jop.apply(ju), rel)
    _close(top.residual(tu, tb), jop.residual(ju, jb), rel)
    for sm, om in (("jacobi", 0.8), ("jacobi", (1.2, 0.7)), ("rbgs", None)):
        _close(top.smooth(tu, tb, smoother=sm, omega=om, sweeps=2),
               jop.smooth(ju, jb, smoother=sm, omega=om, sweeps=2), rel)
    _close(tc.restrict_into(tu, top), jc.restrict_into(ju, jop), rel)
    _close(tc.prolong_add_into(tu, tec, top),
           jc.prolong_add_into(ju, jec, jop), rel)


def test_pseudo_inverses_are_bitwise_jax():
    assert np.array_equal(_np(periodic.periodic_coarse_pinv(8)),
                          np.asarray(jper.periodic_coarse_pinv(8)))
    assert np.array_equal(_np(periodic3d.periodic3_coarse_pinv(4)),
                          np.asarray(jper3.periodic3_coarse_pinv(4)))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_rhs_matches_jax(dtype):
    """The right-hand sides bitwise for an arithmetic forcing; 1e-12 / 1e-6
    of the largest value for the trigonometric ones (the sines of XLA and
    of torch may differ in the last bit)."""
    cj, ct = _cfgs(5, 3, dtype)
    jp = jper.PeriodicPoissonProblem(cj, forcing=poly_forcing)
    tp = periodic.PeriodicPoissonProblem(ct, forcing=poly_forcing,
                                         device="cpu")
    assert np.array_equal(_np(tp.rhs()), np.asarray(jp.rhs()))
    rel = 1e-12 if dtype == np.float64 else 1e-6
    jp = jper.PeriodicPoissonProblem(cj, forcing=forcing)
    tp = periodic.PeriodicPoissonProblem(ct, forcing=forcing, device="cpu")
    _close(tp.rhs(), jp.rhs(), rel)
    cj3, ct3 = _cfgs(4, 2, dtype)
    jp3 = jper3.Periodic3DPoissonProblem(cj3, forcing=forcing3)
    tp3 = periodic3d.Periodic3DPoissonProblem(ct3, forcing=forcing3,
                                              device="cpu")
    _close(tp3.rhs(), jp3.rhs(), rel)
    assert abs(float(tp3.rhs().sum())) < 1e-5


# ---------------------------------------------------------------------------
# The extended blocks of the fused tier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [128, 256])
def test_extend_owned_refresh_match_jax(n):
    """n = 128 < GC: the ghost columns wrap more than once, and refresh's
    column strips overlap their sources."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, n)).astype(np.float32)
    te = tpf.extend(torch.tensor(x))
    assert np.array_equal(_np(te), np.pad(x, ((16, 16), (256, 256)),
                                          mode="wrap"))
    assert np.array_equal(_np(te), np.asarray(jpf.extend(jnp.asarray(x))))
    assert np.array_equal(_np(tpf.owned(te)), x)
    bad = _np(te).copy()
    bad[:3] = -1.0
    bad[:, -5:] = 2.0
    bad[7, 300] = 9.0   # an owned cell: refreshed into the ghosts
    got = tpf.refresh(torch.tensor(bad))
    assert np.array_equal(_np(got), np.asarray(jpf.refresh(jnp.asarray(bad))))


def test_gates_admit_what_jax_admits():
    for R in (16, 32, 48, 288, 304, 8224):
        for C in (512, 640, 768, 1024, 18 * 1024 + 512):
            for steps in (0, 6, 14, 15):
                for jd, td in DT.values():
                    want = JL.supported_local(R, C, steps, jd)
                    if C > JL.MAX_C:
                        # the port takes any width (no on-chip budget)
                        want = JL.supported_local(R, 768, steps, jd)
                    assert KL.supported_local(R, C, steps, td) == want, \
                        (R, C, steps, td)
    for level in (8, 9):
        for sm, nu in (("chebyshev", 3), ("rbgs", 6), ("rbgs", 7),
                       ("jacobi", 13), ("jacobi", 14), ("zebra_x", 1)):
            for dtype in (np.float32, np.float64):
                for kernels in (True, False):
                    cj, ct = _cfgs(level, 4, dtype, smoother=sm, nu1=nu,
                                   nu2=2, kernels=kernels,
                                   coarse_solver="smooth")
                    hj = jper.build_periodic_hierarchy(cj)
                    ht = periodic.build_periodic_hierarchy(ct)
                    assert (tpf.fused_levels(ht, ct, ct.dtype)
                            == jpf.fused_levels(hj, cj, cj.dtype))


# ---------------------------------------------------------------------------
# K1-local and K2-local: plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

def _smoother(name, sweeps):
    if name == "chebyshev":
        return "jacobi", ops.chebyshev_omegas(sweeps, 0.4)
    return name, 2.0 / 3.0


# The fused tier's origin with the virtual n, and a shard's (the top-left
# block of a 2 x 2 decomposed 512^2 grid, whose ghosts lie outside it).
ORIGINS = [((2, 2), 1 << 30), ((-16, -256), 512)]


@pytest.mark.parametrize("origin,n", ORIGINS)
@pytest.mark.parametrize("name,nu1,nu2", [("jacobi", 2, 2),
                                          ("chebyshev", 3, 2),
                                          ("rbgs", 1, 1), ("rbgs", 2, 2)])
def test_local_plain_matches_pallas(origin, n, name, nu1, nu2):
    """(288, 768) -> (160, 640): the smallest block the gate takes, two TPU
    row strips.  Compared on the owned regions."""
    R, C = 288, 768
    Rc, Cc = KL.coarse_shape(R, C)
    rng = np.random.default_rng(nu1 + 10 * nu2)
    u, b = (rng.standard_normal((R, C)).astype(np.float32) for _ in range(2))
    ec = rng.standard_normal((Rc, Cc)).astype(np.float32)
    sm1, om1 = _smoother(name, nu1)
    sm2, om2 = _smoother(name, nu2)
    org = jnp.asarray([origin], jnp.int32)
    with pltpu.force_tpu_interpret_mode():
        ju, jrc = JL.smooth_restrict_ext(jnp.asarray(u), jnp.asarray(b), org,
                                         n, nu1, sm1, om1)
        ju2, jss = JL.prolong_smooth_ext(jnp.asarray(u), jnp.asarray(b),
                                         jnp.asarray(ec), org, n, nu2, sm2,
                                         om2, want_resnorm=True)
    tu, trc = KL.smooth_restrict_ext(torch.tensor(u), torch.tensor(b),
                                     origin, n, nu1, sm1, om1)
    tu2, tss = KL.prolong_smooth_ext(torch.tensor(u), torch.tensor(b),
                                     torch.tensor(ec), origin, n, nu2, sm2,
                                     om2, want_resnorm=True)
    tu3 = KL.prolong_smooth_ext(torch.tensor(u), torch.tensor(b),
                                torch.tensor(ec), origin, n, nu2, sm2, om2)
    fine = (slice(16, R - 16), slice(256, C - 256))
    coarse = (slice(16, Rc - 16), slice(256, Cc - 256))
    _close(_np(tu)[fine], np.asarray(ju)[fine], 1e-5)
    _close(_np(trc)[coarse], np.asarray(jrc)[coarse], 1e-5)
    _close(_np(tu2)[fine], np.asarray(ju2)[fine], 1e-5)
    assert torch.equal(tu3, tu2)
    np.testing.assert_allclose(float(tss), float(jss), rtol=1e-5)
    # Defined outside the owned region: the coarse cells no fine cell
    # restricts to are zero.
    frame = _np(trc).copy()
    frame[8:8 + R // 2, 128:128 + C // 2] = 0.0
    assert not frame.any()


def test_local_entries_refuse_what_they_do_not_take():
    u = torch.zeros((288, 768))
    with pytest.raises(NotImplementedError):
        KL.smooth_restrict_ext(u.double(), u.double(), (2, 2), 1 << 30, 1)
    with pytest.raises(ValueError):
        KL.prolong_smooth_ext(u, u, u, (2, 2), 1 << 30, 1, "zebra_x")
    with pytest.raises(ValueError):
        KL.smooth_restrict_ext(u[:287, :767], u[:287, :767], (2, 2),
                               1 << 30, 1)


# ---------------------------------------------------------------------------
# The fused tier
# ---------------------------------------------------------------------------

def test_fused_tier_matches_jax_fused_tier():
    """Level 8, coarsest 4: the 256^2 level fuses (depth 1), 3 fixed
    cycles, the JAX tier's Pallas kernels in interpret mode."""
    cj, ct = _cfgs(8, 4, smoother="chebyshev", nu1=3, nu2=2, kernels=True)
    jp = jper.PeriodicPoissonProblem(cj, forcing=forcing)
    tp = periodic.PeriodicPoissonProblem(ct, forcing=forcing, device="cpu")
    assert tpf.fused_levels(tp.hierarchy, ct, torch.float32) == 1
    b = jp.rhs()
    with pltpu.force_tpu_interpret_mode():
        rj = jax.jit(lambda h, bb: jpf.solve_fixed_periodic(h, cj, bb, 3))(
            jp.hierarchy, b)
        jax.block_until_ready(rj.u)
    rt = tpf.solve_fixed_periodic(tp.hierarchy, ct, torch.tensor(_np(b)), 3)
    want = np.asarray(rj.res_history)
    np.testing.assert_allclose(_np(rt.res_history), want, rtol=3e-3,
                               atol=2e-4 * float(want[0]))
    _close(rt.u, rj.u, 2e-5)


@pytest.mark.parametrize("cyc", ["V", "W"])
def test_fused_tier_matches_jax_protocol_path(cyc):
    """Level 9, coarsest 4 (depth 2: 512^2 and 256^2 fuse), 4 fixed cycles,
    against the JAX package's plain PeriodicOp path."""
    cj, ct = _cfgs(9, 4, smoother="chebyshev", nu1=3, nu2=2, cycle=cyc,
                   kernels=True)
    jp = jper.PeriodicPoissonProblem(cj, forcing=forcing)
    tp = periodic.PeriodicPoissonProblem(ct, forcing=forcing, device="cpu")
    assert tpf.fused_levels(tp.hierarchy, ct, torch.float32) == 2
    b = jp.rhs()
    cjp = jmg.MultigridConfig(**{**cj.__dict__, "use_pallas": False})
    rj = jsolve_fixed(jp.hierarchy, cjp, b, 4)
    rt = tpf.solve_fixed_periodic(tp.hierarchy, ct, torch.tensor(_np(b)), 4)
    want = np.asarray(rj.res_history)
    np.testing.assert_allclose(_np(rt.res_history), want, rtol=3e-3,
                               atol=2e-4 * float(want[0]))
    _close(rt.u, rj.u, 2e-5)
    if cyc == "V":
        assert abs(float(rt.u.mean())) < 1e-6 * float(rt.u.abs().max())


# ---------------------------------------------------------------------------
# The front doors
# ---------------------------------------------------------------------------

def test_2d_door_matches_jax_in_f64():
    """Level 7 in float64 on the protocol path until tol (identical counts),
    then the FMG start against the JAX package's."""
    cj, ct = _cfgs(7, 3, np.float64, smoother="chebyshev", nu1=3, nu2=2,
                   coarse_solver="smooth")
    tp = periodic.PeriodicPoissonProblem(ct, forcing=forcing, device="cpu")
    floor = 1e-14 * float(torch.linalg.norm(tp.rhs()))
    rj = jmg.solve_poisson(7, bc="periodic", forcing=forcing, config=cj,
                           tol=1e-10)
    rt = tmg.solve_poisson(7, bc="periodic", forcing=forcing, config=ct,
                           tol=1e-10, device="cpu")
    assert rt.iterations == int(rj.iterations) and rt.converged
    k = rt.iterations + 1
    np.testing.assert_allclose(_np(rt.res_history)[:k],
                               np.asarray(rj.res_history)[:k], rtol=1.2e-7,
                               atol=floor)
    _close(rt.u, rj.u, 1e-10)
    jp = jper.PeriodicPoissonProblem(cj, forcing=forcing)
    _close(tmg.fmg(tp.hierarchy, ct, tp.rhs()),
           jmg.fmg(jp.hierarchy, cj, jp.rhs()), 1e-12)


def test_2d_door_on_the_kernel_route_matches_jax():
    """Level 8 with use_kernels on float32: the fused tier (plain versions
    here) until tol 1e-3, against the JAX door on its fused tier in
    interpret mode; the same iterations."""
    cj, ct = _cfgs(8, 4, smoother="chebyshev", nu1=3, nu2=2, kernels=True)
    with pltpu.force_tpu_interpret_mode():
        rj = jmg.solve_poisson(8, bc="periodic", forcing=forcing, config=cj,
                               tol=1e-3)
    rt = tmg.solve_poisson(8, bc="periodic", forcing=forcing, config=ct,
                           tol=1e-3, device="cpu")
    assert rt.iterations == int(rj.iterations) and rt.converged
    k = rt.iterations + 1
    want = np.asarray(rj.res_history)[:k]
    np.testing.assert_allclose(_np(rt.res_history)[:k], want, rtol=3e-3,
                               atol=2e-4 * float(want[0]))
    _close(rt.u, rj.u, 2e-5)


def test_3d_door_matches_jax_in_f64():
    cj, ct = _cfgs(5, 2, np.float64, smoother="chebyshev", nu1=3, nu2=2,
                   coarse_solver="smooth")
    tp = periodic3d.Periodic3DPoissonProblem(ct, forcing=forcing3,
                                             device="cpu")
    floor = 1e-14 * float(torch.linalg.norm(tp.rhs()))
    rj = jmg.solve_poisson3d(5, bc="periodic", forcing=forcing3, config=cj,
                             tol=1e-10)
    rt = tmg.solve_poisson3d(5, bc="periodic", forcing=forcing3, config=ct,
                             tol=1e-10, device="cpu")
    assert rt.iterations == int(rj.iterations) and rt.converged
    k = rt.iterations + 1
    np.testing.assert_allclose(_np(rt.res_history)[:k],
                               np.asarray(rj.res_history)[:k], rtol=1.2e-7,
                               atol=floor)
    _close(rt.u, rj.u, 1e-10)


def test_extract_solution_closes_the_torus():
    u = torch.arange(16.0).reshape(4, 4)
    got = tmg.extract_solution(u, 4)
    want = np.asarray(jmg.extract_solution(jnp.asarray(_np(u)), 4))
    assert np.array_equal(_np(got), want) and got.shape == (5, 5)
    u3 = torch.arange(8.0).reshape(2, 2, 2)
    got3 = tmg.extract_solution(u3, 2)
    want3 = np.asarray(jmg.extract_solution(jnp.asarray(_np(u3)), 2))
    assert np.array_equal(_np(got3), want3)
    # a Dirichlet grid is cropped as before
    assert tmg.extract_solution(torch.zeros(256, 256), 128).shape == (129,
                                                                      129)


@pytest.mark.parametrize("case", ["boundary", "refined", "order", "constant",
                                  "tol", "mesh", "3d-refined",
                                  "3d-boundary", "3d-constant"])
def test_periodic_option_raises(case):
    cfg = tmg.MultigridConfig(finest_level=5, coarsest_level=3)
    kw = dict(bc="periodic", forcing=forcing, config=cfg, device="cpu")
    if case == "mesh":
        with pytest.raises(NotImplementedError):
            tmg.solve_poisson(5, mesh=object(), **kw)
        return
    err = ValueError
    if case.startswith("3d"):
        kw["forcing"] = forcing3
        extra = {"3d-refined": dict(refined=True),
                 "3d-boundary": dict(boundary=1.0),
                 "3d-constant": dict(forcing=6.0)}[case]
        with pytest.raises(err):
            tmg.solve_poisson3d(5, **{**kw, **extra})
        return
    extra = {"boundary": dict(boundary=1.0), "refined": dict(refined=True),
             "order": dict(order=4), "constant": dict(forcing=4.0),
             "tol": dict(tol=None)}[case]
    with pytest.raises(err):
        tmg.solve_poisson(5, **{**kw, **extra})


def test_interop_carries_a_jax_torus_hierarchy():
    cj, ct = _cfgs(6, 3, np.float64, smoother="rbgs", nu1=1, nu2=1)
    for ndim, build in ((2, jper.build_periodic_hierarchy),
                        (3, jper3.build_periodic3_hierarchy)):
        jh = build(cj if ndim == 2 else jmg.MultigridConfig(
            finest_level=4, coarsest_level=2, dtype=jnp.float64))
        th = interop.periodic_hierarchy_from_numpy(
            [op.n for op in jh.levels], np.asarray(jh.coarse_inv), ndim=ndim)
        assert [op.n for op in th.levels] == [op.n for op in jh.levels]
        assert all(op.ndim == ndim for op in th.levels)
        assert np.array_equal(_np(th.coarse_inv), np.asarray(jh.coarse_inv))
    tp = periodic.PeriodicPoissonProblem(ct, forcing=forcing, device="cpu")
    th = interop.periodic_hierarchy_from_numpy(
        [op.n for op in tp.hierarchy.levels],
        _np(tp.hierarchy.coarse_inv))
    b = tp.rhs()
    assert torch.equal(tmg.solve_fixed(th, ct, b, 2).res_history,
                       tmg.solve_fixed(tp.hierarchy, ct, b, 2).res_history)


def test_periodic_doors_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is that card")
    for call in (lambda: tmg.solve_poisson(5, bc="periodic", forcing=forcing),
                 lambda: tmg.solve_poisson3d(4, bc="periodic",
                                             forcing=forcing3),
                 lambda: tmg.PeriodicPoissonProblem(
                     tmg.MultigridConfig(5), forcing=forcing)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# ---------------------------------------------------------------------------
# Dispatch: which wrapper each step of the fused tier calls
# ---------------------------------------------------------------------------

@pytest.fixture
def launched(monkeypatch):
    """Calls per K1-local / K2-local entry (one launch each on the card);
    a resnorm call counts under its own name."""
    counts = dict.fromkeys(("smooth_restrict_ext", "prolong_smooth_ext",
                            "prolong_smooth_ext_resnorm"), 0)

    def k1(*a, _fn=KL.smooth_restrict_ext, **kw):
        counts["smooth_restrict_ext"] += 1
        return _fn(*a, **kw)

    def k2(*a, _fn=KL.prolong_smooth_ext, **kw):
        counts["prolong_smooth_ext_resnorm" if kw.get("want_resnorm")
               else "prolong_smooth_ext"] += 1
        return _fn(*a, **kw)
    monkeypatch.setattr(KL, "smooth_restrict_ext", k1)
    monkeypatch.setattr(KL, "prolong_smooth_ext", k2)
    return counts


@pytest.mark.parametrize("cyc,per_cycle", [("V", (2, 1, 1)),
                                           ("W", (3, 2, 1))])
def test_fused_dispatch_counts(launched, cyc, per_cycle):
    """Level 9, coarsest 4: 512^2 and 256^2 fuse.  A V-cycle is K1 at both
    and K2 at the 256^2 level, the finest K2 fusing the norm; a W-cycle
    visits the 256^2 level twice.  chip_smoke.py checks the same counts."""
    cfg = tmg.MultigridConfig(finest_level=9, coarsest_level=4, cycle=cyc,
                              smoother="chebyshev", nu1=3, nu2=2,
                              use_kernels=True)
    res = tmg.solve_poisson(9, bc="periodic", forcing=forcing, config=cfg,
                            num_cycles=2, tol=None, device="cpu")
    k1, k2, k2r = per_cycle
    assert launched == {"smooth_restrict_ext": 2 * k1,
                        "prolong_smooth_ext": 2 * k2,
                        "prolong_smooth_ext_resnorm": 2 * k2r}
    assert res.u.shape == (512, 512)


def test_protocol_route_launches_nothing(launched):
    """use_kernels=False, float64, and an FMG start's own cycles launch no
    K1-local / K2-local."""
    for cfg in (tmg.MultigridConfig(finest_level=8, coarsest_level=4),
                tmg.MultigridConfig(finest_level=8, coarsest_level=4,
                                    use_kernels=True, dtype=torch.float64)):
        tmg.solve_poisson(8, bc="periodic", forcing=forcing, config=cfg,
                          num_cycles=1, tol=None, device="cpu")
    assert set(launched.values()) == {0}
    cfg = tmg.MultigridConfig(finest_level=8, coarsest_level=4,
                              use_kernels=True)
    tmg.solve_poisson(8, bc="periodic", forcing=forcing, config=cfg,
                      num_cycles=1, tol=None, use_fmg=True, device="cpu")
    assert launched == {"smooth_restrict_ext": 1, "prolong_smooth_ext": 0,
                        "prolong_smooth_ext_resnorm": 1}
