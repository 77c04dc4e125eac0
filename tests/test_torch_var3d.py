"""The port's 3D variable-coefficient path against the JAX package on the
CPU: the host builders bitwise, ``VarStencilOp3D`` and ``Directional7Op`` in
float64, the plain versions of K1v_3 / K2v_3 against the Pallas kernels in
interpret mode, the ``solve_diffusion3d`` and variable-wind
``solve_convection_diffusion3d`` front doors, a level-5 solve against a
scipy sparse direct solve, the dispatch of the path counted with spies, and
the split launch plan that lets K1_3 / K2_3 take every depth.

Tolerances.  In float64 both packages evaluate the operators in the jnp
order: 1e-12 relative (measured: bitwise), solve histories 1e-10 with equal
iteration counts.  The kernels' plain versions keep the Pallas kernels'
order, but XLA:CPU contracts multiply-adds into FMAs where torch does not:
f32 roundoff, 1e-6 of the largest entry (measured <= 4e-7), norms 1e-5.
Float32 solves agree to 1e-4 relative above the f32 floor (the kernel path
and the jnp path sum in different orders), iteration counts within 1.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import tpu_multigrid as jmg
from tpu_multigrid.core import grids as jgrids
from tpu_multigrid.core import operators as joperators
from tpu_multigrid.core.ops import chebyshev_omegas
from tpu_multigrid.cycles import cycle as jcycle
from tpu_multigrid.cycles import cycle_with_norm as jcycle_with_norm
from tpu_multigrid.kernels import vartransfer3d as JV3
from tpu_multigrid.problems import convection3d as jconv3
from tpu_multigrid.problems import diffusion3d as jdiff3

import tpu_multigrid_torch as tmg
from tpu_multigrid_torch import interop
from tpu_multigrid_torch.core import grids, operators
from tpu_multigrid_torch.kernels import transfer3d as TT3
from tpu_multigrid_torch.kernels import vartransfer3d as TV3
from tpu_multigrid_torch.problems import convection3d as tconv3
from tpu_multigrid_torch.problems import diffusion3d as tdiff3

# One torch thread per test worker (see tests/test_torch_ops.py).
torch.set_num_threads(1)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rel):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-300))


def _interior(shape, n, rng, dtype=np.float64):
    a = np.zeros(shape, dtype)
    a[1:n, 1:n, 1:n] = rng.standard_normal((n - 1,) * 3)
    return a


def coefficient(x, y, z):
    """The JAX package's 3D var benchmark coefficient (bench_var3.py)."""
    return 1.0 + x + 2.0 * y + z


def reaction(x, y, z):
    return 100.0 * (1.0 + x * y * z)


def _sin(t):
    return torch.sin(t) if isinstance(t, torch.Tensor) else np.sin(t)


def _cos(t):
    return torch.cos(t) if isinstance(t, torch.Tensor) else np.cos(t)


# The recirculating winds of the JAX package's bench_dir3.py, for numpy
# (the JAX builders) and torch (the port's) coordinates alike.
WINDS = dict(bx=lambda x, y, z: _sin(2 * math.pi * x) * (0.5 + z),
             by=lambda x, y, z: _cos(2 * math.pi * y) - 0.3,
             bz=lambda x, y, z: x - y)


# ---------------------------------------------------------------------------
# The host builders, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_diffusion_op3_host_and_shift_match_jax_bitwise(dtype):
    n, S, Sx = 16, 32, 128
    cells = tdiff3.cell_coefficients3(n, coefficient)
    np.testing.assert_array_equal(cells,
                                  jdiff3.cell_coefficients3(n, coefficient))
    t = operators.diffusion_op3_host(cells.astype(dtype), n, S, Sx)
    j = joperators.diffusion_op3_host(cells.astype(dtype), n, S, Sx)
    for name in ("tz", "ty", "tx", "inv_diag"):
        np.testing.assert_array_equal(getattr(t, name),
                                      np.asarray(getattr(j, name)))
    for a, b in zip(t.t_minus, j.t_minus):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(t.coef_stack, j.coef_stack)
    assert np.shares_memory(t.tz, t.coef_stack)
    ts = tdiff3._with_shift3(t, reaction, np.dtype(dtype))
    js = jdiff3._with_shift3(j, reaction, np.dtype(dtype))
    for name in ("c2", "inv_diag", "coef_stack"):
        np.testing.assert_array_equal(getattr(ts, name),
                                      np.asarray(getattr(js, name)))
    with pytest.raises(ValueError):
        tdiff3._with_shift3(t, -1e6, np.dtype(dtype))


def test_convection_op3_matches_jax_bitwise():
    n, S, Sx = 16, 32, 128
    t = tconv3.convection_diffusion_op3(n, S, Sx, 0.01, **WINDS)
    j = jconv3.convection_diffusion_op3(n, S, Sx, 0.01, **WINDS)
    assert t.STENCIL27 is None and j.STENCIL27 is None
    for name in ("coef_stack", "diag", "inv_diag"):
        np.testing.assert_array_equal(getattr(t, name),
                                      np.asarray(getattr(j, name)))
    tc = tconv3.convection_diffusion_op3(n, S, Sx, 0.5, 1.0, -2.0, 0.5)
    jc = jconv3.convection_diffusion_op3(n, S, Sx, 0.5, 1.0, -2.0, 0.5)
    assert tc.STENCIL27 == jc.STENCIL27 and tc.coef_stack is None


# ---------------------------------------------------------------------------
# The operators in float64
# ---------------------------------------------------------------------------

SHAPE64, N64 = (24, 24, 40), 20


def _ops64(kind, rng):
    """(port operator, JAX operator) on (24, 24, 40), float64."""
    S, Sx = SHAPE64[0], SHAPE64[2]
    if kind == "wind":
        t = tconv3.convection_diffusion_op3(N64, S, Sx, 0.01, **WINDS,
                                            dtype=np.float64)
        j = jconv3.convection_diffusion_op3(N64, S, Sx, 0.01, **WINDS,
                                            dtype=np.float64)
        return t.to("cpu"), j
    cells = 0.5 + rng.random((N64,) * 3)
    t = operators.diffusion_op3_host(cells, N64, S, Sx)
    j = joperators.diffusion_op3_host(cells, N64, S, Sx)
    if kind == "shift":
        t = tdiff3._with_shift3(t, reaction, np.dtype(np.float64))
        j = jdiff3._with_shift3(j, reaction, np.dtype(np.float64))
    if kind == "rolled":       # no stored minus planes: rolls of the planes
        t.t_minus = None
        j = joperators.VarStencilOp3D(j.tz, j.ty, j.tx, j.inv_diag, N64, S,
                                      Sx)
    return t.to("cpu"), j


@pytest.mark.parametrize("kind", ["flux", "shift", "rolled", "wind"])
def test_operators_match_jax_f64(kind):
    rng = np.random.default_rng(0)
    t, j = _ops64(kind, rng)
    u, b = _interior(SHAPE64, N64, rng), _interior(SHAPE64, N64, rng)
    tu, tb, ju, jb = torch.tensor(u), torch.tensor(b), jnp.asarray(u), \
        jnp.asarray(b)
    assert t.grid_shape == j.grid_shape and t.ndim == 3
    _close(t.apply(tu), j.apply(ju), 1e-12)
    _close(t.residual(tu, tb), j.residual(ju, jb), 1e-12)
    for sm, om, sweeps in (("jacobi", (1.3, 0.6), 3), ("jacobi", 0.8, 2),
                           ("rbgs", 1.0, 2)):
        _close(t.smooth(tu, tb, smoother=sm, omega=om, sweeps=sweeps),
               j.smooth(ju, jb, smoother=sm, omega=om, sweeps=sweeps), 1e-12)
    # A batch of grids applies as each grid alone (the coarse-inverse probe).
    batch = torch.stack([tu, tb])
    _close(t.apply(batch)[1], t.apply(tb), 0.0)


@pytest.mark.parametrize("kind", ["shift", "wind"])
def test_coarse_inverse_matches_jax(kind):
    """The probed inverse at the front door's coarsest level (n = 8, a
    343^2 matrix), float32 probes as in the JAX package."""
    S, Sx, n = 16, 128, 8
    if kind == "wind":
        t = tconv3.convection_diffusion_op3(n, S, Sx, 0.01, **WINDS)
        j = jconv3.convection_diffusion_op3(n, S, Sx, 0.01, **WINDS)
    else:
        cells = tdiff3.cell_coefficients3(n, coefficient).astype(np.float32)
        t = tdiff3._with_shift3(operators.diffusion_op3_host(cells, n, S, Sx),
                                reaction, np.dtype(np.float32))
        j = jdiff3._with_shift3(joperators.diffusion_op3_host(cells, n, S, Sx),
                                reaction, np.dtype(np.float32))
    inv = grids.coarse_dense_inverse(t)
    jinv = jgrids.coarse_dense_inverse(j)
    assert inv.shape == (343, 343) and inv.dtype == torch.float32
    _close(inv, jinv, 1e-6)


# ---------------------------------------------------------------------------
# The kernels' plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

N, SHAPE, SHAPE_C = 32, (48, 48, 128), (32, 32, 128)
OM3, OM2 = chebyshev_omegas(3, 0.4), chebyshev_omegas(2, 0.4)


@pytest.mark.parametrize("nplanes", [3, 4, 6])
@pytest.mark.parametrize("smoother", ["chebyshev", "rbgs"])
def test_var_level_visit_plain_matches_pallas(nplanes, smoother):
    """K1v_3, K2v_3 and K2v_3-resnorm, Chebyshev (3, 2) or RB-GS (1, 1), on
    3, 4 and 6 positive planes from a seed."""
    rng = np.random.default_rng(nplanes)
    u = _interior(SHAPE, N, rng, np.float32)
    b = _interior(SHAPE, N, rng, np.float32)
    ec = np.zeros(SHAPE_C, np.float32)
    ec[1:16, 1:16, 1:16] = rng.standard_normal((15,) * 3)
    coef = (0.5 + rng.random((nplanes,) + SHAPE)).astype(np.float32)
    sm, a1, a2 = (("jacobi", (OM3, 3), (OM2, 2)) if smoother == "chebyshev"
                  else ("rbgs", (1.0, 1), (1.0, 1)))
    t = [torch.tensor(x) for x in (u, b, ec, coef)]
    j = [jnp.asarray(x) for x in (u, b, ec, coef)]
    with pltpu.force_tpu_interpret_mode():
        ju, jrc = JV3.var_smooth_restrict3(j[0], j[1], j[3], N, SHAPE_C,
                                           a1[1], sm, a1[0])
        jv = JV3.var_prolong_smooth3(*j, N, a2[1], sm, a2[0])
        jvr, jn = JV3.var_prolong_smooth_resnorm3(*j, N, a2[1], sm, a2[0])
    tu, trc = TV3.var_smooth_restrict3(t[0], t[1], t[3], N, SHAPE_C, a1[1],
                                       sm, a1[0])
    tv = TV3.var_prolong_smooth3(*t, N, a2[1], sm, a2[0])
    tvr, tn = TV3.var_prolong_smooth_resnorm3(*t, N, a2[1], sm, a2[0])
    assert trc.shape == SHAPE_C and tn.dtype == torch.float32
    for g, w in ((tu, ju), (trc, jrc), (tv, jv), (tvr, jvr)):
        _close(g, w, 1e-6)
    assert torch.equal(tv, tvr)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-5)


def test_var_gates_match_jax_on_the_front_door_shapes():
    """The front door's level pairs, levels 4..9, 3, 4 and 6 planes, at
    depths up to 16 steps: the same pairs fuse in both packages, except
    where the TPU kernels' VMEM tiling binds (level 9 with 6 planes from 11
    steps on), which the port does not carry: its kernels split deep
    smoothing into launches."""
    def shape(level):
        n = 2 ** level
        return (-(-(n + 1) // 16) * 16,) * 2 + (-(-(n + 1) // 128) * 128,)
    for level in range(4, 10):
        sh, shc = shape(level), shape(level - 1)
        for nplanes in (3, 4, 6):
            for steps in range(0, 17):
                got = TV3.supported_var3(sh, shc, steps, torch.float32,
                                         nplanes)
                want = JV3.supported_var3(sh, shc, steps, jnp.float32,
                                          nplanes)
                if level == 9 and nplanes == 6 and 11 <= steps <= 14:
                    assert got and not want
                else:
                    assert got == want, (sh, nplanes, steps)
        assert not TV3.supported_var3(sh, shc, 3, torch.float64)
        assert not TV3.supported_var3(sh, shc, 3, torch.float32, 5)


def test_var_kernel_options_raise():
    u = torch.zeros(SHAPE)
    coef = torch.ones((3,) + SHAPE)
    with pytest.raises(NotImplementedError):
        TV3.var_smooth_restrict3(u, u, coef, N, SHAPE_C, 1, box=(1,) * 6)
    with pytest.raises(NotImplementedError):
        TV3.var_prolong_smooth3(u.double(), u.double(), u.double(),
                                coef.double(), N, 1)
    ud = u.double()
    with pytest.raises(NotImplementedError):
        TV3.var_smooth_restrict_ext3(ud, ud, coef.double(), (0, 0), N,
                                     SHAPE_C, 1)
    with pytest.raises(NotImplementedError):
        TV3.var_prolong_smooth_ext3(ud, ud, ud, coef.double(), (0, 0), N, 1)
    with pytest.raises(ValueError):
        TV3.var_prolong_smooth3(u, u, u, torch.ones((5,) + SHAPE), N, 1)
    with pytest.raises(ValueError):
        TV3.var_prolong_smooth3(u, u, u, coef, N, 1, "sor")


# ---------------------------------------------------------------------------
# K1_3 / K2_3 at every depth: the split launch plan
# ---------------------------------------------------------------------------

def test_split_plan():
    """One launch where steps + extra fits the window's halo (11 layers);
    else as few launches as fit, the halo spread evenly, each launch's
    weights rotated to its first step."""
    ws = (1.0, 2.0, 3.0)
    assert TT3.split_plan(9, 2, 11, ws) == [(0, 9, ws)]
    assert TT3.split_plan(10, 1, 11, ws) == [(0, 10, ws)]
    assert TT3.split_plan(0, 2, 11, ws) == [(0, 0, (1.0,))]
    assert TT3.split_plan(10, 2, 11, ws) == [(0, 6, ws), (6, 4, ws)]
    assert TT3.split_plan(14, 2, 11, ws) == [(0, 8, ws),
                                             (8, 6, (3.0, 1.0, 2.0))]
    assert TT3.split_plan(12, 0, 11, ws) == [(0, 6, ws), (6, 6, ws)]
    for steps in range(0, 40):
        for extra in (0, 1, 2):
            plan = TT3.split_plan(steps, extra, 11, ws)
            assert sum(k for _, k, _ in plan) == steps
            assert [f for f, _, _ in plan] == [sum(k for _, k, _ in plan[:i])
                                                for i in range(len(plan))]
            assert all(k <= 11 for _, k, _ in plan)
            assert plan[-1][1] + extra <= 11
            assert len(plan) == max(1, -(-(steps + extra) // 11))
            for first, k, lw in plan:
                for s in range(k):
                    assert lw[s % len(lw)] == ws[(first + s) % 3]


@pytest.mark.parametrize("sm,om,sweeps",
                         [("rbgs", 1.0, 5),
                          ("jacobi", chebyshev_omegas(10, 0.4), 10)])
def test_deep_k1_3_k2_3_on_cpu_equal_plain(sm, om, sweeps):
    """RB-GS (5, 5) and Chebyshev 10, which the kernels run split into
    launches, through the wrappers on CPU tensors: their plain versions, on
    the 7-point stencil and the 19-point weights."""
    rng = np.random.default_rng(3)
    u = torch.tensor(_interior(SHAPE, N, rng, np.float32))
    b = torch.tensor(_interior(SHAPE, N, rng, np.float32))
    ec = torch.tensor(_interior(SHAPE_C, N // 2, rng, np.float32))
    for st in (None, operators.Const19Op.STENCIL27):
        got = TT3.smooth_restrict3(u, b, N, SHAPE_C, sweeps, sm, om, st)
        want = TT3.smooth_restrict3_plain(u, b, N, SHAPE_C, sweeps, sm, om,
                                          st)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        args = (u, b, ec, N, sweeps, sm, om, st)
        assert torch.equal(TT3.prolong_smooth3(*args),
                           TT3.prolong_smooth3_plain(*args))


def test_deep_rbgs_poisson3d_runs_on_the_kernel_path():
    """solve_poisson3d with RB-GS (5, 5) on the kernel route's hierarchy
    (K1_3 / K2_3 dispatched, their plain versions on the CPU) matches the
    JAX package."""
    fields = dict(finest_level=5, coarsest_level=3, smoother="rbgs", nu1=5,
                  nu2=5)
    rj = jmg.solve_poisson3d(5, config=jmg.MultigridConfig(
        dtype=jnp.float32, **fields), num_cycles=2)
    rt = tmg.solve_poisson3d(5, config=tmg.MultigridConfig(
        use_kernels=True, **fields), num_cycles=2, device="cpu")
    np.testing.assert_allclose(_np(rt.res_history), _np(rj.res_history),
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# The front doors against the JAX package
# ---------------------------------------------------------------------------

def _configs(level, dtype, **kw):
    """(JAX config on its jnp route, port config with the kernels on)."""
    fields = dict(finest_level=level, coarsest_level=3)
    fields.update(kw)
    jdt, tdt = ((jnp.float64, torch.float64) if dtype == "f64"
                else (jnp.float32, torch.float32))
    return (jmg.MultigridConfig(dtype=jdt, **fields),
            tmg.MultigridConfig(dtype=tdt, use_kernels=True, **fields))


def _check_histories(rt, rj, dtype):
    hist, jhist = _np(rt.res_history), _np(rj.res_history)
    if dtype == "f64":
        assert rt.iterations == int(rj.iterations)
        np.testing.assert_allclose(hist[:rt.iterations + 1],
                                   jhist[:rt.iterations + 1], rtol=1e-10)
    else:
        assert abs(rt.iterations - int(rj.iterations)) <= 1
        # Above the f32 floor (~3e-4 of r0 at level 7): the cycles before
        # the last, all above 1e-2 of r0.
        k = min(rt.iterations, int(rj.iterations))
        assert hist[k - 1] > 1e-2 * hist[0]
        np.testing.assert_allclose(hist[:k], jhist[:k], rtol=1e-4)


# (dtype, level, tol).  Float32 at level 7 (144, 144, 256), where the pair
# 7 -> 6 goes to K1v_3 / K2v_3 (their plain versions on the CPU), with the
# direct coarsest solve.  The kernels take float32 only, so float64 runs
# the plain operators at every level: it runs at level 6, a sixth of the
# work, with a smoothed coarsest level (both packages store the dense
# coarse inverse in f32 for every dtype, so with "direct" the histories
# would differ by its two matvecs' summation orders).
DTYPES = [("f64", 6, 0.2), ("f32", 7, 1e-2)]


def _shape(level):
    n = 2 ** level
    return (-(-(n + 1) // 16) * 16,) * 2 + (-(-(n + 1) // 128) * 128,)


@pytest.mark.parametrize("dtype,level,tol", DTYPES)
@pytest.mark.parametrize("shift", [0.0, reaction], ids=["plain", "shift"])
def test_solve_diffusion3d_matches_jax(dtype, level, tol, shift):
    """The front door (3 coefficient planes, 4 with the shift) against the
    JAX package on its jnp route."""
    kw = dict(coarse_solver="smooth") if dtype == "f64" else {}
    cj, ct = _configs(level, dtype, smoother="chebyshev", nu1=3, nu2=2, **kw)
    rj = jmg.solve_diffusion3d(level, coefficient=coefficient, shift=shift,
                               config=cj, tol=tol)
    rt = tmg.solve_diffusion3d(level, coefficient=coefficient, shift=shift,
                               config=ct, tol=tol, device="cpu")
    assert rt.u.shape == _shape(level) and rt.converged
    _check_histories(rt, rj, dtype)


@pytest.mark.parametrize("dtype,level,tol", DTYPES)
def test_solve_convection3d_variable_winds_match_jax(dtype, level, tol):
    """The JAX package's variable-wind configuration (bench_dir3.py): eps
    0.01, RB-GS (2, 2), coarsest level 3, on the padded layout (6 planes on
    K1v_3 / K2v_3 at level 7)."""
    kw = dict(coarse_solver="smooth") if dtype == "f64" else {}
    cj, ct = _configs(level, dtype, smoother="rbgs", nu1=2, nu2=2, **kw)
    pj = jconv3.ConvectionDiffusion3DProblem(cj, eps=0.01, **WINDS, align=16,
                                             min_pad_level=0, lane_align=128)
    rj = jmg.solve_until_tol(pj.hierarchy, cj, pj.rhs(), tol=tol)
    rt = tmg.solve_convection_diffusion3d(level, eps=0.01, **WINDS,
                                          config=ct, tol=tol, device="cpu")
    assert rt.u.shape == _shape(level) and rt.converged
    _check_histories(rt, rj, dtype)


def test_level5_against_a_sparse_direct_solve():
    """solve_diffusion3d(5) in float64 to 1e-10 against scipy's sparse
    direct solve of the same flux system (29791 unknowns)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spl
    cfg = tmg.MultigridConfig(finest_level=5, coarsest_level=3,
                              smoother="chebyshev", nu1=3, nu2=2,
                              dtype=torch.float64)
    res = tmg.solve_diffusion3d(5, coefficient=coefficient, config=cfg,
                                tol=1e-10, device="cpu")
    assert res.converged
    prob = tmg.Diffusion3DProblem(cfg, coefficient=coefficient, device="cpu")
    op, b = prob.finest, prob.rhs()
    n, m = 32, 31
    idx = np.arange(m ** 3).reshape(m, m, m)
    inner = (slice(1, n),) * 3
    rows, cols, vals = [idx.ravel()], [idx.ravel()], [
        op._diag(torch.float64)[inner].reshape(-1).numpy()]
    tzm, tym, txm = op._tm()
    for ax, plus, minus in ((0, op.tz, tzm), (1, op.ty, tym), (2, op.tx, txm)):
        for sign, plane in ((1, plus), (-1, minus)):
            src = [slice(None)] * 3
            dst = [slice(None)] * 3
            src[ax] = slice(0, m - 1) if sign == 1 else slice(1, m)
            dst[ax] = slice(1, m) if sign == 1 else slice(0, m - 1)
            w = plane[inner].numpy()[tuple(src)]
            rows.append(idx[tuple(src)].ravel())
            cols.append(idx[tuple(dst)].ravel())
            vals.append(-w.ravel())
    a = sp.csc_matrix((np.concatenate(vals), (np.concatenate(rows),
                                              np.concatenate(cols))))
    ref = spl.spsolve(a, b[inner].reshape(-1).numpy())
    got = res.u[inner].reshape(-1).numpy()
    assert np.abs(got - ref).max() <= 1e-8 * np.abs(ref).max()


def test_fmg_and_boundary_on_the_var3_path_match_jax():
    cj, ct = _configs(4, "f32", smoother="chebyshev", nu1=3, nu2=2,
                      coarsest_level=2)
    g = lambda x, y, z: 1.0 + x * y - z  # noqa: E731
    rj = jmg.solve_diffusion3d(4, coefficient=coefficient, config=cj,
                               num_cycles=2, use_fmg=True, boundary=g)
    rt = tmg.solve_diffusion3d(4, coefficient=coefficient, config=ct,
                               num_cycles=2, use_fmg=True, boundary=g,
                               device="cpu")
    np.testing.assert_allclose(_np(rt.res_history), _np(rj.res_history),
                               rtol=1e-4)
    _close(rt.u, rj.u, 1e-5)


def test_var3_hierarchy_from_numpy():
    cj, ct = _configs(5, "f32", smoother="chebyshev", nu1=3, nu2=2)
    pj = jdiff3.Diffusion3DProblem(cj, coefficient=coefficient,
                                   shift=reaction)
    levels = [dict(tz=np.asarray(op.tz), ty=np.asarray(op.ty),
                   tx=np.asarray(op.tx), inv_diag=np.asarray(op.inv_diag),
                   c2=np.asarray(op.c2), n=op.n, S=op.S, Sx=op.Sx,
                   coef_stack=np.asarray(op.coef_stack))
              for op in pj.hierarchy.levels]
    hier = interop.var3_hierarchy_from_numpy(
        levels, np.asarray(pj.hierarchy.coarse_inv), device="cpu")
    pt = tmg.Diffusion3DProblem(ct, coefficient=coefficient, shift=reaction,
                                device="cpu")
    b = pt.rhs()
    np.testing.assert_allclose(
        _np(tmg.solve_fixed(hier, ct, b, 2).res_history),
        _np(tmg.solve_fixed(pt.hierarchy, ct, b, 2).res_history), rtol=1e-6)
    cw = tconv3.convection_diffusion_op3(8, 16, 16, 0.01, **WINDS)
    hw = interop.var3_hierarchy_from_numpy(
        [dict(diag=cw.diag, inv_diag=cw.inv_diag, coef_stack=cw.coef_stack,
              n=8, S=16, Sx=16)], device="cpu")
    assert isinstance(hw.levels[0], tconv3.Directional7Op)
    assert torch.equal(hw.levels[0].cp[0], torch.from_numpy(cw.cp[0]))


@pytest.mark.parametrize("entry", ["solve_diffusion3d",
                                   "solve_convection_diffusion3d"])
def test_front_doors_default_to_the_card(monkeypatch, entry):
    """device=None means the card: without one it raises; on the CPU the
    default config keeps the kernels off.  mesh= raises (not ported)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        getattr(tmg, entry)(3)
    with pytest.raises(NotImplementedError):
        getattr(tmg, entry)(3, mesh=object(), device="cpu")
    seen = {}

    def fake_run(problem, config, *a, **k):
        seen["config"] = config
    from tpu_multigrid_torch import api
    monkeypatch.setattr(api, "_run", fake_run)
    getattr(tmg, entry)(3, device="cpu")
    cfg = seen["config"]
    want = (("chebyshev", 3, 2) if entry == "solve_diffusion3d"
            else ("rbgs", 2, 2))
    assert (cfg.smoother, cfg.nu1, cfg.nu2, cfg.use_kernels) == want + (False,)


# ---------------------------------------------------------------------------
# Dispatch: which wrapper each step of the path calls
# ---------------------------------------------------------------------------

ENTRIES = ["var_smooth_restrict3", "var_prolong_smooth3",
           "var_prolong_smooth_resnorm3"]


@pytest.fixture
def calls(monkeypatch):
    """Counts of calls per K1v_3 / K2v_3 wrapper, with the planes each call
    streamed, through spies."""
    counts = dict.fromkeys(ENTRIES, 0)
    counts["planes"] = set()
    for name in ENTRIES:
        def spy(u, b, *a, _fn=getattr(TV3, name), _name=name, **kw):
            counts[_name] += 1
            coef = a[0] if _name == "var_smooth_restrict3" else a[1]
            counts["planes"].add(coef.shape[0])
            return _fn(u, b, *a, **kw)
        monkeypatch.setattr(TV3, name, spy)
    return counts


@pytest.fixture
def jax_calls(monkeypatch):
    """Counts of calls per K1v_3 / K2v_3 entry of the JAX package; the spies
    return zeros of the kernels' output shapes."""
    counts = dict.fromkeys(ENTRIES, 0)

    def make(name):
        def spy(u, b, *a, **kw):
            counts[name] += 1
            z = jnp.zeros_like(u)
            if name == "var_smooth_restrict3":
                return z, jnp.zeros(a[2], u.dtype)
            if name == "var_prolong_smooth_resnorm3":
                return z, jnp.float32(1.0)
            return z
        return spy
    for name in ENTRIES:
        monkeypatch.setattr(JV3, name, make(name))
    return counts


@pytest.mark.parametrize("kind", ["flux", "shift", "wind"])
def test_level7_dispatch_counts(calls, jax_calls, kind):
    """Level 7's pair 7 -> 6 is the one K1v_3 / K2v_3 take (Sx = 256; level
    6 has Sx = 128).  Per cycle: one K1v_3 and one K2v_3; per
    cycle_with_norm: one K1v_3 and one K2v_3-resnorm (chip_smoke.py checks
    the formula at level 9: K1v_3 on each of 3 pairs, K2v_3 on the 2 below
    the finest), in both packages, with 3, 4 or 6 planes."""
    # Two levels, 7 and a smoothed 6: the dispatch of the pair is all that
    # is counted.
    kw = dict(coarsest_level=6, coarse_solver="smooth")
    cj, ct = _configs(7, "f32", smoother="chebyshev", nu1=3, nu2=2, **kw)
    pad = dict(align=16, min_pad_level=0, lane_align=128)
    if kind == "wind":
        cj, ct = _configs(7, "f32", smoother="rbgs", nu1=2, nu2=2, **kw)
        pj = jconv3.ConvectionDiffusion3DProblem(
            dataclasses.replace(cj, use_pallas=True), eps=0.01, **WINDS,
            **pad)
        pt = tconv3.ConvectionDiffusion3DProblem(ct, eps=0.01, **WINDS,
                                                 device="cpu", **pad)
    else:
        shift = reaction if kind == "shift" else 0.0
        pj = jdiff3.Diffusion3DProblem(dataclasses.replace(
            cj, use_pallas=True), coefficient=coefficient, shift=shift)
        pt = tmg.Diffusion3DProblem(ct, coefficient=coefficient, shift=shift,
                                    device="cpu")
    jcfg = dataclasses.replace(cj, use_pallas=True)
    b = pj.rhs()
    jcycle(pj.hierarchy, jcfg, jnp.zeros_like(b), b)
    jcycle_with_norm(pj.hierarchy, jcfg, jnp.zeros_like(b), b)
    bt = pt.rhs()
    u = tmg.cycle(pt.hierarchy, ct, torch.zeros_like(bt), bt)
    from tpu_multigrid_torch.cycles import cycle_with_norm
    _, rn = cycle_with_norm(pt.hierarchy, ct, u, bt)
    want = dict(var_smooth_restrict3=2, var_prolong_smooth3=1,
                var_prolong_smooth_resnorm3=1)
    assert jax_calls == want
    planes = calls.pop("planes")
    assert calls == want
    assert planes == {dict(flux=3, shift=4, wind=6)[kind]}
    assert float(rn) > 0


def test_level6_and_deep_smoothing_stay_off_the_var_kernels(calls):
    """Level 6 (Sx = 128) and a depth past the gate (RB-GS (8, 8): 16 + 2
    > 16 layers) run the plain operators only."""
    _, ct = _configs(6, "f32", smoother="chebyshev", nu1=3, nu2=2)
    tmg.solve_diffusion3d(6, coefficient=coefficient, config=ct,
                          num_cycles=1, device="cpu")
    _, deep = _configs(7, "f32", smoother="rbgs", nu1=8, nu2=8)
    p = tmg.Diffusion3DProblem(deep, coefficient=coefficient, device="cpu")
    from tpu_multigrid_torch.cycles import _use_var_super_kernels3
    assert not _use_var_super_kernels3(*p.hierarchy.levels[:2], deep,
                                       torch.float32)
    assert _use_var_super_kernels3(*p.hierarchy.levels[:2], dataclasses.replace(
        deep, nu1=7, nu2=7), torch.float32)
    calls.pop("planes")
    assert set(calls.values()) == {0}
