"""The port's 3D constant-coefficient path against the JAX package on the
CPU: ``core.ops3d`` and the 3D operators in float64, the plain versions of
the 3D kernels against the Pallas kernels in interpret mode, the
``solve_poisson3d`` front door (7- and 19-point, FMG, refinement), and the
kernel dispatch of the path, counted with spies on the wrappers.

Tolerances.  In float64 the port evaluates the JAX package's operations in
its order: the ops and operators agree to 1e-12 (measured: bitwise).  In
float32 XLA:CPU contracts multiply-adds into FMAs where torch does not, so
the kernels' plain versions agree with the Pallas kernels to a few ulps of
their largest entry (1e-6 relative; measured <= 1.7e-7), the fused norms to
1e-5, and solve histories to rtol 1e-3 above the float32 floor with equal
iteration counts.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import tpu_multigrid as jmg
from tpu_multigrid import precision as jprecision
from tpu_multigrid.core import grids as jgrids
from tpu_multigrid.core import ops3d as jops3d
from tpu_multigrid.core import operators as joperators
from tpu_multigrid.core.ops import chebyshev_omegas
from tpu_multigrid.cycles import cycle_with_norm as jcycle_with_norm
from tpu_multigrid.kernels import stencil3d as JK3
from tpu_multigrid.kernels import transfer3d as JT3

import tpu_multigrid_torch as tmg
from tpu_multigrid_torch import interop, kernels, precision
from tpu_multigrid_torch.core import grids, operators, ops3d
from tpu_multigrid_torch.kernels import stencil3d as TK3
from tpu_multigrid_torch.kernels import transfer3d as TT3

# One torch thread per test worker (see tests/test_torch_ops.py).
torch.set_num_threads(1)

STENCIL19 = operators.Const19Op.STENCIL27


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _interior(shape, n, rng, dtype=np.float64):
    a = np.zeros(shape, dtype)
    a[1:n, 1:n, 1:n] = rng.standard_normal((n - 1,) * 3)
    return a


def _close(got, want, rel):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-300))


# ---------------------------------------------------------------------------
# float64: ops3d, the operators, the coarse inverses, the refinement pieces
# ---------------------------------------------------------------------------

SHAPE64, N64, SHAPE64_C = (24, 24, 40), 20, (16, 16, 24)


@pytest.fixture
def grids64():
    rng = np.random.default_rng(0)
    u, b = _interior(SHAPE64, N64, rng), _interior(SHAPE64, N64, rng)
    ec = np.zeros(SHAPE64_C)
    ec[1:10, 1:10, 1:10] = rng.standard_normal((9, 9, 9))
    return u, b, ec


@pytest.mark.parametrize("name", ["neighbor_sum3", "apply_poisson3",
                                  "residual3", "jacobi3", "jacobi3_tuple",
                                  "rbgs3", "restrict_fw3", "prolong3"])
def test_ops3d_match_jax_f64(grids64, name):
    u, b, ec = grids64
    n = N64
    calls = {
        "neighbor_sum3": lambda m, u, b, e: m.neighbor_sum3(u),
        "apply_poisson3": lambda m, u, b, e: m.apply_poisson3(u, n),
        "residual3": lambda m, u, b, e: m.residual3(u, b, n),
        "jacobi3": lambda m, u, b, e: m.jacobi_sweeps3(u, b, n, 0.66, 3),
        "jacobi3_tuple": lambda m, u, b, e: m.jacobi_sweeps3(
            u, b, n, (1.2, 0.7, 0.5), 4),
        "rbgs3": lambda m, u, b, e: m.redblack_gs_sweeps3(u, b, n, 2),
        "restrict_fw3": lambda m, u, b, e: m.restrict_fw3(u, n, SHAPE64_C),
        "prolong3": lambda m, u, b, e: m.prolong3(e, n // 2, SHAPE64),
    }
    got = calls[name](ops3d, *map(torch.tensor, (u, b, ec)))
    want = calls[name](jops3d, *map(jnp.asarray, (u, b, ec)))
    assert got.dtype == torch.float64 and tuple(got.shape) == want.shape
    _close(got, want, 1e-12)


@pytest.mark.parametrize("kind", ["7", "19"])
def test_operators_match_jax_f64(grids64, kind):
    u, b, _ = grids64
    cls = "ConstStencilOp3D" if kind == "7" else "Const19Op"
    t = getattr(operators, cls)(N64, SHAPE64[0], SHAPE64[2])
    j = getattr(joperators, cls)(N64, SHAPE64[0], SHAPE64[2])
    assert t.grid_shape == j.grid_shape and t.ndim == 3
    tu, tb, ju, jb = torch.tensor(u), torch.tensor(b), jnp.asarray(u), \
        jnp.asarray(b)
    _close(t.apply(tu), j.apply(ju), 1e-12)
    _close(t.residual(tu, tb), j.residual(ju, jb), 1e-12)
    for sm, om, sweeps in (("jacobi", (1.3, 0.6), 3), ("rbgs", 1.0, 2)):
        _close(t.smooth(tu, tb, smoother=sm, omega=om, sweeps=sweeps),
               j.smooth(ju, jb, smoother=sm, omega=om, sweeps=sweeps), 1e-12)
    if kind == "19":
        assert t.STENCIL27 == j.STENCIL27


@pytest.mark.parametrize("kind", ["7", "19"])
def test_coarse_inverse_and_solve_match_jax(kind):
    """The closed-form 7-point inverse and the probed 19-point one at the
    front door's coarsest level (n = 8, a 343^2 matrix)."""
    cls = "ConstStencilOp3D" if kind == "7" else "Const19Op"
    t = getattr(operators, cls)(8, 16, 128)
    j = getattr(joperators, cls)(8, 16, 128)
    inv = grids.coarse_dense_inverse(t, dtype=torch.float64)
    jinv = jgrids.coarse_dense_inverse(j, jnp.float64)
    assert inv.shape == (343, 343)
    _close(inv, jinv, 1e-12)
    b = _interior((16, 16, 128), 8, np.random.default_rng(1))
    _close(grids.coarse_solve(t, inv, torch.tensor(b)),
           jgrids.coarse_solve(j, jinv, jnp.asarray(b)), 1e-12)


def test_refinement_pieces_match_jax_f64(grids64):
    """The 3D compensated residuals (six neighbours, the exact 4u + 2u
    split) and prolong_comp3, against the JAX package."""
    u, b, ec = grids64
    lo, lo2 = 1e-8 * u[::-1].copy(), 1e-16 * u
    t = [torch.tensor(x) for x in (b, u, lo, lo2)]
    j = [jnp.asarray(x) for x in (b, u, lo, lo2)]
    _close(precision.ds_residual(*t[:3], N64),
           jprecision.ds_residual(*j[:3], N64), 1e-12)
    _close(precision.ts_residual(*t, N64), jprecision.ts_residual(*j, N64),
           1e-12)
    hi, err = precision.prolong_comp3(torch.tensor(ec), N64 // 2, SHAPE64)
    jhi, jerr = jprecision.prolong_comp3(jnp.asarray(ec), N64 // 2, SHAPE64)
    _close(hi, jhi, 1e-12)
    _close(err, jerr, 1e-12)
    exact = ops3d.prolong3(torch.tensor(ec), N64 // 2, SHAPE64)
    _close(hi + err, exact, 1e-15)


def test_ds_residual_never_reaches_the_2d_kernel():
    """A 3D grid whose last side the 2D compensated-residual kernel would
    take (Sx = 256, level 7) reaches the 3D entry, never the 2D one: on the
    CPU the 3D entry returns the 3D plain version."""
    b = torch.zeros((144, 144, 256))
    b[1:128, 1:128, 1:128] = 1.0
    op = operators.ConstStencilOp3D(128, 144, 256)
    r = precision._comp_residual(b, (b, torch.zeros_like(b)), op, True)
    assert torch.equal(r, precision.ds_residual(b, b, torch.zeros_like(b),
                                                128))


def _components3(shape, n, seed):
    """b ~h^2, u_hi O(1), u_mid ~1e-8, u_lo ~1e-16 (float32), and noise
    outside the interior, which only masked nodes may see."""
    rng = np.random.default_rng(seed)
    out = []
    for scale in (1.0 / n ** 2, 1.0, 1e-8, 1e-16):
        a = _interior(shape, n, rng) + 0.1 * rng.standard_normal(shape)
        out.append(torch.tensor(scale * a, dtype=torch.float32))
    return out


@pytest.mark.parametrize("shape,n", [((48, 48, 128), 32), ((20, 24, 136), 17)])
def test_residual3_entries_on_cpu_are_the_plain_versions(shape, n):
    from tpu_multigrid_torch.kernels import compres
    b, uh, um, ul = _components3(shape, n, 3)
    assert torch.equal(compres.ds_residual3(b, uh, um, n),
                       precision.ds_residual(b, uh, um, n))
    assert torch.equal(compres.ts_residual3(b, uh, um, ul, n),
                       precision.ts_residual(b, uh, um, ul, n))
    assert set(kernels.launch_counts().values()) == {0}


@pytest.mark.parametrize("use_kernels", [False, True])
def test_residual3_dispatch_on_cpu_equals_the_plain_versions(use_kernels):
    b, uh, um, ul = _components3((48, 48, 128), 32, 4)
    op = operators.ConstStencilOp3D(32, 48, 128)
    assert torch.equal(precision._comp_residual(b, (uh, um), op,
                                                use_kernels),
                       precision.ds_residual(b, uh, um, 32))
    assert torch.equal(
        precision._comp_residual(b, (uh, um, ul), op, use_kernels),
        precision.ts_residual(b, uh, um, ul, 32))


@pytest.mark.parametrize("driver,ds_levels", [("ds", 0), ("ds", 2),
                                              ("ts", 2)])
def test_refined3d_calls_the_3d_residual_entries(monkeypatch, driver,
                                                 ds_levels):
    """With kernels on, every compensated residual of a 3D refined solve
    goes to the 3D entries (one per ds level and iteration, plus the outer
    one), none to the 2D entries; with kernels off, none at all."""
    from tpu_multigrid_torch.kernels import compres
    calls = dict.fromkeys(["ds_residual", "ts_residual", "ds_residual3",
                           "ts_residual3"], 0)
    for name in calls:
        def spy(*a, _fn=getattr(compres, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(compres, name, spy)
    _, ct = _configs(6, use_kernels=True)
    p6 = tmg.Poisson3DProblem(ct, align=16, min_pad_level=0, lane_align=128,
                              device="cpu")
    for cfg in (ct, dataclasses.replace(ct, use_kernels=False)):
        for k in calls:
            calls[k] = 0
        if driver == "ds":
            out = precision.solve_refined_ds(p6.hierarchy, cfg, p6.rhs(),
                                             num_cycles=2, tol=None,
                                             ds_levels=ds_levels)
        else:
            out = precision.solve_refined_ts(p6.hierarchy, cfg, p6.rhs(),
                                             num_cycles=2, tol=None,
                                             ds_levels=ds_levels)
        assert out[-2] == 2
        want = dict.fromkeys(calls, 0)
        if cfg.use_kernels and driver == "ds":
            want["ds_residual3"] = 2 * (ds_levels + 1)
        elif cfg.use_kernels:
            want.update(ds_residual3=2 * ds_levels, ts_residual3=2)
        assert calls == want


# ---------------------------------------------------------------------------
# The kernels' plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

N, SHAPE, SHAPE_C = 32, (48, 48, 128), (32, 32, 128)
OM3, OM2 = chebyshev_omegas(3, 0.4), chebyshev_omegas(2, 0.4)


@pytest.fixture
def grids32():
    rng = np.random.default_rng(2)
    u = _interior(SHAPE, N, rng, np.float32)
    b = _interior(SHAPE, N, rng, np.float32)
    ec = np.zeros(SHAPE_C, np.float32)
    ec[1:16, 1:16, 1:16] = rng.standard_normal((15,) * 3)
    return u, b, ec


def test_streaming_smoother_plain_matches_pallas(grids32):
    u, b, _ = grids32
    t = [torch.tensor(x) for x in (u, b)]
    j = [jnp.asarray(x) for x in (u, b)]
    with pltpu.force_tpu_interpret_mode():
        want = [JK3.jacobi_sweeps3(*j, N, OM3, 3),
                *JK3.jacobi_sweeps_residual3(*j, N, OM3, 3),
                JK3.rbgs_sweeps3(*j, N, 1),
                *JK3.rbgs_sweeps_residual3(*j, N, 1),
                JK3.residual3(*j, N)]
    got = [TK3.jacobi_sweeps3(*t, N, OM3, 3),
           *TK3.jacobi_sweeps_residual3(*t, N, OM3, 3),
           TK3.rbgs_sweeps3(*t, N, 1), *TK3.rbgs_sweeps_residual3(*t, N, 1),
           TK3.residual3(*t, N)]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w, 1e-6)


@pytest.mark.parametrize("stencil", [None, STENCIL19], ids=["7pt", "19pt"])
@pytest.mark.parametrize("smoother", ["chebyshev", "rbgs"])
def test_level_visit_plain_matches_pallas(grids32, stencil, smoother):
    """K1_3 and K2_3 (with and without the resnorm), Chebyshev (3, 2) or
    RB-GS (1, 1), on the 7-point stencil and the 19-point weights."""
    u, b, ec = grids32
    sm, a1, a2 = (("jacobi", (OM3, 3), (OM2, 2)) if smoother == "chebyshev"
                  else ("rbgs", (1.0, 1), (1.0, 1)))
    t = [torch.tensor(x) for x in (u, b, ec)]
    j = [jnp.asarray(x) for x in (u, b, ec)]
    with pltpu.force_tpu_interpret_mode():
        ju, jrc = JT3.smooth_restrict3(j[0], j[1], N, SHAPE_C, a1[1], sm,
                                       a1[0], stencil=stencil)
        jv = JT3.prolong_smooth3(*j, N, a2[1], sm, a2[0], stencil=stencil)
        jvr, jn = JT3.prolong_smooth_resnorm3(*j, N, a2[1], sm, a2[0],
                                              stencil=stencil)
    tu, trc = TT3.smooth_restrict3(t[0], t[1], N, SHAPE_C, a1[1], sm, a1[0],
                                   stencil=stencil)
    tv = TT3.prolong_smooth3(*t, N, a2[1], sm, a2[0], stencil=stencil)
    tvr, tn = TT3.prolong_smooth_resnorm3(*t, N, a2[1], sm, a2[0],
                                          stencil=stencil)
    assert trc.shape == SHAPE_C and tn.dtype == torch.float32
    for g, w in ((tu, ju), (trc, jrc), (tv, jv), (tvr, jvr)):
        _close(g, w, 1e-6)
    assert torch.equal(tv, tvr)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-5)


def test_gates_match_jax_on_the_front_door_shapes():
    """The front door's level shapes (S = round_up(n+1, 16), Sx =
    round_up(n+1, 128)) for levels 2..10, at smoother depths up to 16
    steps.  From 17 steps on, the TPU kernel's VMEM budget refuses level 10
    (from 25, level 9); the port's smoother takes any depth, split into
    launches."""
    def shape(level):
        n = 2 ** level
        return (-(-(n + 1) // 16) * 16,) * 2 + (-(-(n + 1) // 128) * 128,)
    for level in range(2, 11):
        sh = shape(level)
        for steps in range(0, 17):
            assert TK3.supported3(sh, torch.float32, steps) == \
                JK3.supported3(sh, jnp.float32, steps), (sh, steps)
        assert TK3.supported3(sh, torch.float32, 40)
        assert not TK3.supported3(sh, torch.float64, 1)
        if level >= 3:
            shc = shape(level - 1)
            for steps in range(0, 20):
                assert TT3.supported3(sh, shc, steps, torch.float32) == \
                    JT3.supported3(sh, shc, steps, jnp.float32), (sh, steps)


def test_kernel_options_raise():
    u = torch.zeros(SHAPE, dtype=torch.float64)
    with pytest.raises(NotImplementedError):
        TK3.jacobi_sweeps3(u, u, N, 0.5, 1)
    with pytest.raises(NotImplementedError):
        TT3.smooth_restrict3(u, u, N, SHAPE_C, 1)
    with pytest.raises(ValueError):
        TT3.prolong_smooth3(u.float(), u.float(), u.float(), N, 1, "sor")


# ---------------------------------------------------------------------------
# The front door and the drivers against the JAX package
# ---------------------------------------------------------------------------

def _configs(level, use_kernels=False, **kw):
    """(JAX config on its jnp route, port config) of the front door's
    default schedule at ``level``."""
    fields = dict(finest_level=level, smoother="chebyshev", nu1=3, nu2=2)
    fields.update(kw)
    return (jmg.MultigridConfig(dtype=jnp.float32, **fields),
            tmg.MultigridConfig(use_kernels=use_kernels, **fields))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_solve_poisson3d_matches_jax(use_kernels):
    """Level 5 to tol 1e-8 without refinement: every path stalls at the
    f32 floor after 8 cycles (measured ~1.1e-5 of r0)."""
    cj, ct = _configs(5)
    rj = jmg.solve_poisson3d(5, config=cj, tol=1e-8)
    rt = tmg.solve_poisson3d(5, config=dataclasses.replace(
        ct, use_kernels=use_kernels), tol=1e-8, device="cpu")
    assert rt.u.shape == (48, 48, 128) and rj.u.shape == (48, 48, 128)
    assert rt.iterations == int(rj.iterations) == 8
    assert rt.stalled and not rt.converged
    hist, jhist = _np(rt.res_history), _np(rj.res_history)
    np.testing.assert_allclose(hist[:5], jhist[:5], rtol=1e-3)
    ut = tmg.extract_solution(rt.u, 32)
    uj = np.asarray(jmg.extract_solution(rj.u, 32))
    assert ut.shape == (33, 33, 33)
    _close(ut, uj, 1e-5)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_solve_poisson3d_refined_matches_jax(use_kernels):
    cj, ct = _configs(5)
    rj = jmg.solve_poisson3d(5, config=cj, tol=1e-10, refined=True)
    rt = tmg.solve_poisson3d(5, config=dataclasses.replace(
        ct, use_kernels=use_kernels), tol=1e-10, refined=True, device="cpu")
    assert rt.converged and bool(rj.converged)
    assert rt.iterations == int(rj.iterations)
    np.testing.assert_allclose(_np(rt.res_history), _np(rj.res_history),
                               rtol=1e-4)


def test_refined_level5_against_a_sparse_direct_solve():
    """The double-single refined solve to 1e-10 against scipy's sparse
    float64 direct solve of the same 7-point system (29791 unknowns), both
    from the float32 right-hand side: measured 1.01e-11 relative after 12
    iterations."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spl
    _, ct = _configs(5, use_kernels=True)
    prob = tmg.Poisson3DProblem(ct, align=16, min_pad_level=0,
                                lane_align=128, device="cpu")
    b = prob.rhs()
    u_hi, u_lo, _, _, ok = precision.solve_refined_ds(prob.hierarchy, ct, b,
                                                      tol=1e-10)
    assert ok
    m = 31
    one = sp.identity(m)
    t = sp.diags([-np.ones(m - 1), 2 * np.ones(m), -np.ones(m - 1)],
                 [-1, 0, 1])
    a = (sp.kron(sp.kron(t, one), one) + sp.kron(sp.kron(one, t), one)
         + sp.kron(sp.kron(one, one), t)).tocsc()
    ref = spl.spsolve(a, b[1:32, 1:32, 1:32].double().reshape(-1).numpy())
    got = (u_hi.double() + u_lo.double())[1:32, 1:32, 1:32].reshape(-1)
    err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
    assert err <= 1e-7, err


@pytest.mark.parametrize("use_kernels", [False, True])
def test_cycle_ds_3d_matches_jax(use_kernels):
    cj, ct = _configs(5, use_kernels=use_kernels)
    pj = jmg.Poisson3DProblem(cj, align=16, min_pad_level=0, lane_align=128)
    pt = tmg.Poisson3DProblem(ct, align=16, min_pad_level=0, lane_align=128,
                              device="cpu")
    jhi, jlo = jprecision.cycle_ds(pj.hierarchy, cj, pj.rhs(), ds_levels=2)
    thi, tlo = precision.cycle_ds(pt.hierarchy, ct, pt.rhs(), ds_levels=2)
    assert thi.shape == tlo.shape == (48, 48, 128)
    scale = float(np.abs(np.asarray(jhi)).max())
    _close(thi, jhi, 1e-6)
    tsum = thi.numpy().astype(np.float64) + tlo.numpy()
    jsum = np.asarray(jhi, np.float64) + np.asarray(jlo, np.float64)
    np.testing.assert_allclose(tsum, jsum, rtol=0, atol=1e-6 * scale)


def test_solve_refined_ts_3d_matches_jax():
    cj, ct = _configs(5)
    pj = jmg.Poisson3DProblem(cj, align=16, min_pad_level=0, lane_align=128)
    pt = tmg.Poisson3DProblem(ct, align=16, min_pad_level=0, lane_align=128,
                              device="cpu")
    jout = jprecision.solve_refined_ts(pj.hierarchy, cj, pj.rhs(), tol=1e-11,
                                       max_iters=20, ds_levels=2)
    tout = precision.solve_refined_ts(pt.hierarchy, ct, pt.rhs(), tol=1e-11,
                                      max_iters=20, ds_levels=2)
    assert tout[5] is True and bool(jout[5])
    assert tout[4] == int(jout[4])
    np.testing.assert_allclose(tout[3].numpy(), np.asarray(jout[3]),
                               rtol=1e-4)
    # The iterate crosses to the JAX package and back unchanged.
    state = interop.refinement_state_to_numpy(tout[:3])
    assert [a.shape for a in state] == [(48, 48, 128)] * 3
    back = interop.refinement_state_from_numpy(state)
    assert all(torch.equal(a, b) for a, b in zip(back, tout[:3]))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_order4_matches_jax(use_kernels):
    """The 19-point Mehrstellen route on the JAX package's own padded
    hierarchy (the kernel path's layout) or its cubic default."""
    cj, ct = _configs(5)
    ct = dataclasses.replace(ct, use_kernels=use_kernels)
    pad = (dict(align=16, min_pad_level=0, lane_align=128) if use_kernels
           else {})
    from tpu_multigrid.problems.poisson4_3d import Poisson4_3DProblem
    pj = Poisson4_3DProblem(cj, **pad)
    rj = jmg.solve_until_tol(pj.hierarchy, cj, pj.rhs(), tol=1e-4)
    rt = tmg.solve_poisson3d(5, config=ct, tol=1e-4, order=4, device="cpu")
    assert tuple(rt.u.shape) == tuple(pj.finest.grid_shape)
    assert rt.converged and rt.iterations == int(rj.iterations) == 4
    # The last cycle lands near the f32 floor (measured 2e-3 apart there).
    np.testing.assert_allclose(_np(rt.res_history)[:4],
                               _np(rj.res_history)[:4], rtol=1e-3)
    with pytest.raises(ValueError):
        tmg.solve_poisson3d(5, config=ct, order=4, refined=True,
                            device="cpu")


def test_fmg_3d_with_kernels_matches_jax():
    """FMG on the kernel path's hierarchy (plain versions on the CPU), then
    two cycles from its guess, through the front door."""
    cj, ct = _configs(5, use_kernels=True)
    pj = jmg.Poisson3DProblem(cj, align=16, min_pad_level=0, lane_align=128)
    pt = tmg.Poisson3DProblem(ct, align=16, min_pad_level=0, lane_align=128,
                              device="cpu")
    _close(tmg.fmg(pt.hierarchy, ct, pt.rhs()),
           jmg.fmg(pj.hierarchy, cj, pj.rhs()), 1e-5)
    rj = jmg.solve_poisson3d(5, config=cj, num_cycles=2, use_fmg=True)
    rt = tmg.solve_poisson3d(5, config=ct, num_cycles=2, use_fmg=True,
                             device="cpu")
    np.testing.assert_allclose(_np(rt.res_history), _np(rj.res_history),
                               rtol=1e-3)
    assert rt.res_history[2] < 0.02 * rt.res_history[0]


def test_boundary_lift_3d_matches_jax():
    g = lambda x, y, z: 1.0 + x * y - z  # noqa: E731
    cj, ct = _configs(4, coarsest_level=2)
    rj = jmg.solve_poisson3d(4, config=cj, boundary=g, num_cycles=3)
    rt = tmg.solve_poisson3d(4, config=ct, boundary=g, num_cycles=3,
                             device="cpu")
    np.testing.assert_allclose(_np(rt.res_history), _np(rj.res_history),
                               rtol=1e-3)
    _close(tmg.extract_solution(rt.u, 16),
           jmg.extract_solution(rj.u, 16), 1e-5)


def test_hierarchy3d_from_numpy():
    cj, ct = _configs(5, use_kernels=True)
    pj = jmg.Poisson3DProblem(cj, align=16, min_pad_level=0, lane_align=128)
    sizes = [(op.n, op.S, op.Sx) for op in pj.hierarchy.levels]
    hier = interop.hierarchy3d_from_numpy(
        sizes, np.asarray(pj.hierarchy.coarse_inv))
    pt = tmg.Poisson3DProblem(ct, align=16, min_pad_level=0, lane_align=128,
                              device="cpu")
    b = pt.rhs()
    assert torch.equal(tmg.solve_fixed(hier, ct, b, 2).res_history,
                       tmg.solve_fixed(pt.hierarchy, ct, b, 2).res_history)
    h4 = interop.hierarchy3d_from_numpy(sizes, order=4)
    assert isinstance(h4.levels[0], operators.Const19Op)


@pytest.mark.parametrize("kw", [{"mesh": object()}, {"neumann": ("zlo",)}])
def test_unported_3d_options_raise(kw):
    _, ct = _configs(4, coarsest_level=2)
    with pytest.raises(NotImplementedError):
        tmg.solve_poisson3d(4, config=ct, device="cpu", **kw)


def test_default_config_takes_the_kernels_on_the_card_only(monkeypatch):
    seen = {}

    def fake_run(problem, config, *a, **k):
        seen["config"] = config
        return None
    from tpu_multigrid_torch import api
    monkeypatch.setattr(api, "_run", fake_run)
    tmg.solve_poisson3d(3, device="cpu")
    cfg = seen["config"]
    assert (cfg.smoother, cfg.nu1, cfg.nu2, cfg.use_kernels) == \
        ("chebyshev", 3, 2, False)


# ---------------------------------------------------------------------------
# Dispatch: which wrapper each step of the path calls
# ---------------------------------------------------------------------------

ENTRIES3 = {TK3: ["jacobi_sweeps3", "jacobi_sweeps_residual3", "rbgs_sweeps3",
                  "rbgs_sweeps_residual3", "residual3"],
            TT3: ["smooth_restrict3", "prolong_smooth3",
                  "prolong_smooth_resnorm3"]}


@pytest.fixture
def calls(monkeypatch):
    """Counts of calls per 3D wrapper of the port, through spies."""
    counts = {}
    for mod, names in ENTRIES3.items():
        for name in names:
            counts[name] = 0

            def spy(*a, _fn=getattr(mod, name), _name=name, **kw):
                counts[_name] += 1
                return _fn(*a, **kw)
            monkeypatch.setattr(mod, name, spy)
    return counts


@pytest.fixture
def jax_calls(monkeypatch):
    """Counts of calls per 3D kernel entry of the JAX package; the spies
    return zeros of the kernels' output shapes (dispatch depends on shapes
    only)."""
    counts = dict.fromkeys(ENTRIES3[TK3] + ENTRIES3[TT3], 0)

    def make(name):
        def spy(u, b, *a, **kw):
            counts[name] += 1
            z = jnp.zeros_like(u)
            if name == "smooth_restrict3":
                return z, jnp.zeros(a[1], u.dtype)
            if name == "prolong_smooth_resnorm3":
                return z, jnp.float32(1.0)
            if name.endswith("residual3") and name != "residual3":
                return z, z
            return z
        return spy
    for mod, names in ((JK3, ENTRIES3[TK3]), (JT3, ENTRIES3[TT3])):
        for name in names:
            monkeypatch.setattr(mod, name, make(name))
    return counts


def test_level7_dispatch_counts(calls, jax_calls):
    """Level 7 is the first level K1_3/K2_3 take (Sx = 256); levels 6, 5
    and 4 run the streaming smoother.  Per cycle_with_norm: one K1_3, one
    K2_3-resnorm, three fused smoother + residual and three smoothers, in
    both packages (chip_smoke.py checks the same formula at level 9)."""
    cj, ct = _configs(7, use_kernels=True)
    pj = jmg.Poisson3DProblem(dataclasses.replace(cj, use_pallas=True),
                              align=16, min_pad_level=0, lane_align=128)
    b = pj.rhs()
    jcycle_with_norm(pj.hierarchy, dataclasses.replace(
        cj, use_pallas=True), jnp.zeros_like(b), b)
    res = tmg.solve_poisson3d(7, config=ct, num_cycles=2, device="cpu")
    want = dict.fromkeys(calls, 0)
    want.update(smooth_restrict3=1, prolong_smooth_resnorm3=1,
                jacobi_sweeps_residual3=3, jacobi_sweeps3=3)
    assert jax_calls == want
    assert calls == {k: 2 * v for k, v in want.items()}
    assert res.res_history[2] < 0.02 * res.res_history[0]


def test_level6_and_rbgs_dispatch_counts(calls):
    """Level 6 is too narrow for K1_3: cycle_with_norm takes residual3 for
    the norm.  RB-GS (1, 1) at level 7 runs the RB-GS entries."""
    _, ct = _configs(6, use_kernels=True)
    tmg.solve_poisson3d(6, config=ct, num_cycles=1, device="cpu")
    want = dict.fromkeys(calls, 0)
    want.update(jacobi_sweeps_residual3=3, jacobi_sweeps3=3, residual3=1)
    assert calls == want
    for k in calls:
        calls[k] = 0
    _, rb = _configs(7, smoother="rbgs", nu1=1, nu2=1, use_kernels=True)
    tmg.solve_poisson3d(7, config=rb, num_cycles=1, device="cpu")
    want = dict.fromkeys(calls, 0)
    want.update(smooth_restrict3=1, prolong_smooth_resnorm3=1,
                rbgs_sweeps_residual3=3, rbgs_sweeps3=3)
    assert calls == want


def test_refined_order4_and_fmg_dispatch_counts(calls):
    """Per refined iteration K1_3 and K2_3 (no resnorm) on the fused pair;
    the 19-point levels below level 7 run Const19Op's plain smoother; FMG's
    transfers are plain torch."""
    _, ct = _configs(7, use_kernels=True)
    res = tmg.solve_poisson3d(7, config=ct, refined=True, num_cycles=1,
                              device="cpu")
    want = dict.fromkeys(calls, 0)
    want.update(smooth_restrict3=1, prolong_smooth3=1,
                jacobi_sweeps_residual3=3, jacobi_sweeps3=3)
    assert res.iterations == 1 and calls == want
    for k in calls:
        calls[k] = 0
    tmg.solve_poisson3d(7, config=ct, order=4, num_cycles=1, device="cpu")
    want = dict.fromkeys(calls, 0)
    want.update(smooth_restrict3=1, prolong_smooth_resnorm3=1)
    assert calls == want
    for k in calls:
        calls[k] = 0
    kernels.reset_launch_counts()
    _, c6 = _configs(6, use_kernels=True)
    p6 = tmg.Poisson3DProblem(c6, align=16, min_pad_level=0, lane_align=128,
                              device="cpu")
    tmg.fmg(p6.hierarchy, c6, p6.rhs())
    # nu0 = 1 V-cycle at each of levels 4, 5 and 6, of 1, 2 and 3 levels
    # on the streaming smoother; no launches on the CPU.
    assert calls["jacobi_sweeps_residual3"] == calls["jacobi_sweeps3"] == 6
    assert set(kernels.launch_counts().values()) == {0}
