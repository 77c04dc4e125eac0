"""The port's 2D anisotropic path against the JAX package, on the CPU, from
the same numpy inputs: the operator and its Galerkin hierarchy, parallel
cyclic reduction and the zebra sweeps of ``core.lines``, the zebra kernels'
plain versions against the Pallas kernels in interpret mode, the
``solve_anisotropic`` front door, and the kernel dispatch of the path,
counted with spies on the wrappers.

Tolerances.  The host set-up is the same numpy arithmetic in the same
order: bitwise.  ``core.lines`` evaluates the JAX package's operations in
its order; in float64 the two agree to rtol 1e-12.  The kernels' plain
versions follow the Pallas kernels' order; in float32 they agree to
1e-5 * max|ref| (XLA:CPU may contract multiply-adds into FMAs, torch does
not), the resnorm to rtol 1e-5.  Solve histories agree in float32 to rtol
1e-3 while the residual is above the float32 floor (the right-hand side
scales with h^2), in float64 to rtol 1e-10, and iteration counts exactly.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import tpu_multigrid as jmg
from tpu_multigrid.core import lines as jlines
from tpu_multigrid.core import operators as jopr
from tpu_multigrid.kernels import lines as JZ
from tpu_multigrid.kernels import varstencil as JV
from tpu_multigrid.problems import anisotropic as janiso

import tpu_multigrid_torch as tmg
from tpu_multigrid_torch import interop, kernels
from tpu_multigrid_torch.core import lines, operators
from tpu_multigrid_torch.kernels import lines as TZ
from tpu_multigrid_torch.kernels import transfer as TT
from tpu_multigrid_torch.problems import anisotropic

# One torch thread per test worker (see tests/test_torch_ops.py).
torch.set_num_threads(1)

ANGLE = math.radians(45)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _interior(S, n, seed, dtype=np.float32):
    a = np.zeros((S, S), dtype)
    a[1:n, 1:n] = np.random.default_rng(seed).standard_normal((n - 1, n - 1))
    return a


def _same_op(t, j):
    for name in ("coef", "inv_diag"):
        np.testing.assert_array_equal(_np(getattr(t, name)),
                                      _np(getattr(j, name)))
    assert (t.n, t.S) == (j.n, j.S)


def _close(got, want, rel):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-300))


# ---------------------------------------------------------------------------
# Host set-up
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("angle", [0.0, ANGLE])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_anisotropic_op_matches_jax_bitwise(angle, dtype):
    for n, S in ((64, 65), (64, 256)):
        _same_op(anisotropic.anisotropic_poisson_op(n, S, 1.0, 0.05, angle,
                                                    dtype),
                 janiso.anisotropic_poisson_op(n, S, 1.0, 0.05, angle, dtype))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_anisotropic_hierarchy_matches_jax_bitwise(dtype):
    """Level 6 padded to 256, Galerkin levels down to 3, and the coarse
    dense inverse (stored in float32 by both)."""
    kw = dict(finest_level=6, coarsest_level=3, smoother="zebra_x")
    hj = janiso.build_anisotropic_hierarchy(
        jmg.MultigridConfig(dtype=getattr(jnp, dtype), **kw), 1.0, 0.05,
        ANGLE, align=256, min_pad_level=0)
    ht = anisotropic.build_anisotropic_hierarchy(
        tmg.MultigridConfig(dtype=getattr(torch, dtype), **kw), 1.0, 0.05,
        ANGLE, align=256, min_pad_level=0)
    assert [(op.n, op.S) for op in ht.levels] == [
        (64, 256), (32, 256), (16, 256), (8, 256)]
    for t, j in zip(ht.levels, hj.levels):
        _same_op(t, j)
    np.testing.assert_array_equal(_np(ht.coarse_inv), _np(hj.coarse_inv))


# ---------------------------------------------------------------------------
# core.lines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [17, 256, 300])
def test_tridiag_pcr_matches_jax_and_dense(S):
    """Diagonally dominant batched systems with identity rows embedded (the
    padding a grid line carries), S not a power of two included."""
    rng = np.random.default_rng(S)
    B = 3
    dl = 0.3 * rng.standard_normal((B, S))
    du = 0.3 * rng.standard_normal((B, S))
    d = 2.0 + rng.random((B, S))
    b = rng.standard_normal((B, S))
    ident = np.zeros(S, bool)
    ident[[0, S // 2, S - 1]] = True
    d[:, ident], dl[:, ident], du[:, ident], b[:, ident] = 1.0, 0.0, 0.0, 0.0
    got = lines.tridiag_pcr(*map(torch.from_numpy, (dl, d, du, b))).numpy()
    want = np.asarray(jlines.tridiag_pcr(*map(jnp.asarray, (dl, d, du, b))))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    for k in range(B):
        T = np.diag(d[k]) + np.diag(dl[k, 1:], -1) + np.diag(du[k, :-1], 1)
        np.testing.assert_allclose(got[k], np.linalg.solve(T, b[k]),
                                   rtol=1e-10, atol=1e-12)
    assert not got[:, ident].any()
    assert lines.pcr_steps(S) == max(1, math.ceil(math.log2(S)))


def _op_pair(kind):
    """(port operator on the CPU, JAX operator), float64: the rotated fine
    operator, or the Galerkin level below it."""
    n, S = 64, 96
    t = anisotropic.anisotropic_poisson_op(n, S, 1.0, 0.05, ANGLE, np.float64)
    j = janiso.anisotropic_poisson_op(n, S, 1.0, 0.05, ANGLE, np.float64)
    if kind == "galerkin":
        t = operators.galerkin_coarsen_host(t, 48)
        j = jopr.galerkin_coarsen_host(j, 48)
    return t.to("cpu"), j


@pytest.mark.parametrize("kind", ["fine", "galerkin"])
def test_zebra_sweeps_match_jax_f64(kind):
    t, j = _op_pair(kind)
    n, S = t.n, t.S
    u = _interior(S, n, 1, np.float64)
    b = _interior(S, n, 2, np.float64)
    tu, tb, ju, jb = torch.from_numpy(u), torch.from_numpy(b), \
        jnp.asarray(u), jnp.asarray(b)
    for axis, name in ((1, "zebra_x"), (0, "zebra_y")):
        want = jlines.zebra_sweeps(j, ju, jb, 2, axis=axis)
        _close(lines.zebra_sweeps(t, tu, tb, 2, axis=axis), want, 1e-12)
        _close(t.smooth(tu, tb, smoother=name, omega=1.0, sweeps=2),
               j.smooth(ju, jb, smoother=name, omega=1.0, sweeps=2), 1e-12)
    assert t.smooth(tu, tb, smoother="zebra_x", omega=1.0, sweeps=0) is tu


# ---------------------------------------------------------------------------
# The zebra kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

def _kernel_case(angle, n=32, S=256, Sc=256, seed=3):
    op = janiso.anisotropic_poisson_op(n, S, 1.0, 0.05, angle)
    coef = np.asarray(op.coef).reshape(9, S, S)
    u, b = _interior(S, n, seed), _interior(S, n, seed + 1)
    ec = _interior(Sc, n // 2, seed + 2)
    return (tuple(map(torch.from_numpy, (u, b, ec, coef))),
            tuple(map(jnp.asarray, (u, b, ec, coef))))


@pytest.mark.parametrize("sweeps", [1, 2])
@pytest.mark.parametrize("angle", [0.0, ANGLE])
def test_zebra_kernels_plain_match_pallas(angle, sweeps):
    n, Sc = 32, 256
    (tu, tb, te, tc), (ju, jb, je, jc) = _kernel_case(angle)
    with pltpu.force_tpu_interpret_mode():
        jz = JZ.zebra_sweeps_pallas(ju, jb, jc, n, sweeps)
        j1 = JZ.zebra_smooth_restrict(ju, jb, jc, n, Sc, sweeps)
        j2 = JZ.prolong_zebra_smooth_resnorm(ju, jb, je, jc, n, sweeps)
    _close(TZ.zebra_sweeps(tu, tb, tc, n, sweeps), jz, 1e-5)
    t1 = TZ.zebra_smooth_restrict(tu, tb, tc, n, Sc, sweeps)
    _close(t1[0], j1[0], 1e-5)
    _close(t1[1], j1[1], 1e-5)
    t2 = TZ.prolong_zebra_smooth(tu, tb, te, tc, n, sweeps)
    _close(t2, j2[0], 1e-5)
    t3, tnorm = TZ.prolong_zebra_smooth_resnorm(tu, tb, te, tc, n, sweeps)
    assert torch.equal(t3, t2)
    assert tnorm.dtype == torch.float32 and tnorm.shape == ()
    np.testing.assert_allclose(float(tnorm), float(j2[1]), rtol=1e-5)


def test_zebra_plain_matches_pallas_row_strips():
    """A small window budget makes the Pallas smoother stream several row
    strips with clamped edge windows (the JAX package's
    test_zebra_kernel_multi_tile); the plain version holds to the same
    tolerance."""
    n, S = 200, 256
    (tu, tb, _, tc), (ju, jb, _, jc) = _kernel_case(ANGLE, n=n, seed=5)
    small = JZ._NSLAB * S * 4 * 48
    assert 0 < JZ._rows_for(S, 1, jnp.float32, small)[0] < S
    with pltpu.force_tpu_interpret_mode():
        jz = JZ.zebra_sweeps_pallas(ju, jb, jc, n, 1, budget=small)
    _close(TZ.zebra_sweeps(tu, tb, tc, n, 1), jz, 1e-5)


def test_zebra_plain_pieces_follow_the_kernel_order():
    """K1z's restriction and K2z's prolongation in the Pallas order differ
    from the operators' ops.restrict_fw / ops.prolong only at roundoff;
    the rc tail past S/2 is zero; the smoother's plain version is
    core.lines' zebra_x."""
    n, S, Sc = 64, 256, 256
    (tu, tb, te, tc), _ = _kernel_case(ANGLE, n=n)
    from tpu_multigrid_torch.core import ops
    _close(TZ.restrict_fw_plain(tu, n, Sc), ops.restrict_fw(tu, n, Sc), 1e-6)
    _close(TZ.prolong_plain(te, S), ops.prolong(te, n // 2, S), 1e-6)
    _, rc = TZ.zebra_smooth_restrict(tu, tb, tc, n, Sc, 1)
    assert not rc[S // 2:].any() and not rc[:, n // 2:].any()
    op = operators.VarStencilOp(tc.reshape(3, 3, S, S), None, n, S)
    assert torch.equal(TZ.zebra_sweeps(tu, tb, tc, n, 2),
                       op.smooth(tu, tb, smoother="zebra_x", omega=1.0,
                                 sweeps=2))
    _close(TZ.residual9_plain(tu, tb, tc, n), op.residual(tu, tb), 1e-6)


@pytest.mark.parametrize("S", [128, 256, 384, 1280, 2304, 4352, 8448,
                               16640])
def test_zebra_gates_admit_what_jax_admits(S):
    """Every (S, sweeps) and (S, Sc, sweeps) the JAX kernels take, the port
    takes; beyond them the port's rule is the shape rule and one line in
    shared memory (S <= 14528), so it fuses the level-13 pair (8448 / 4352),
    which the JAX package leaves unfused, and refuses S = 16640 as it does."""
    shape_ok = S % 128 == 0 and S <= 14528
    for sweeps in (1, 2, 4, 8):
        j = JZ.supported_zebra(S, sweeps, jnp.float32)
        t = TZ.supported_zebra(S, sweeps, torch.float32)
        assert (not j or t) and t == shape_ok, (S, sweeps)
        assert not TZ.supported_zebra(S, sweeps, torch.float64)
        for Sc in (S // 2, S // 2 + 128, S):
            j = JZ.supported_zebra_fused(S, Sc, sweeps, jnp.float32)
            t = TZ.supported_zebra_fused(S, Sc, sweeps, torch.float32)
            fused_ok = (S % 256 == 0 and Sc % 128 == 0
                        and Sc >= S // 2 + 128 and shape_ok)
            assert (not j or t) and t == fused_ok, (S, Sc, sweeps)
    assert TZ.supported_zebra_fused(8448, 4352, 1, torch.float32)
    assert not JZ.supported_zebra_fused(8448, 4352, 1, jnp.float32)


def test_zebra_kernel_options_raise_and_cpu_runs_plain():
    (tu, tb, te, tc), _ = _kernel_case(0.0)
    with pytest.raises(NotImplementedError):
        TZ.zebra_sweeps(tu.double(), tb.double(), tc.double(), 32, 1)
    with pytest.raises(ValueError):
        TZ.zebra_smooth_restrict(tu, tb, tc[:5], 32, 256, 1)
    kernels.reset_launch_counts()
    assert TZ.zebra_sweeps(tu, tb, tc, 32, 0) is tu
    assert torch.equal(TZ.zebra_sweeps(tu, tb, tc, 32, 1),
                       TZ.zebra_sweeps_plain(tu, tb, tc, 32, 1))
    assert set(kernels.launch_counts().values()) == {0}
    assert set(TZ.LAUNCHES) <= set(kernels.launch_counts())
    assert [TZ.launches(e, 2) for e in TZ.LAUNCHES] == [4, 5, 5, 7]
    assert TZ.launches("zebra_sweeps", 0) == 0


# ---------------------------------------------------------------------------
# The slice: solve_anisotropic
# ---------------------------------------------------------------------------

def _configs(**kw):
    jkw, tkw = dict(kw), dict(kw)
    dtype = kw.get("dtype", "float32")
    jkw["dtype"] = getattr(jnp, dtype)
    tkw["dtype"] = getattr(torch, dtype)
    tkw.setdefault("use_kernels", True)
    jkw.pop("use_kernels", None)
    return jmg.MultigridConfig(**jkw), tmg.MultigridConfig(**tkw)


ZEBRA = dict(smoother="zebra_x", nu1=1, nu2=1)


def _forcing(x, y):
    return 4.0 + 3.0 * x - y * y


def test_f32_kernel_path_matches_jax():
    """Level 7, rotated 45 degrees, eps 1 / 0.05, zebra (1, 1), full
    coarsening: the port's kernel path (plain versions here, levels padded
    to 256) against the JAX jnp route, to tol 1e-3 (8 cycles, above the
    float32 floor of this h^2-scaled right-hand side); the histories to
    rtol 1e-3 over the first 3 cycles, before the padded and unpadded
    hierarchies' roundoff shows near the floor."""
    cj, ct = _configs(finest_level=7, coarsest_level=4, **ZEBRA)
    kw = dict(eps_x=1.0, eps_y=0.05, angle=ANGLE, coarsening="full", tol=1e-3)
    rj = jmg.solve_anisotropic(7, config=cj, **kw)
    rt = tmg.solve_anisotropic(7, config=ct, device="cpu", **kw)
    assert rt.u.shape == (256, 256)
    assert rt.iterations == int(rj.iterations) and rt.converged
    np.testing.assert_allclose(_np(rt.res_history)[:4],
                               _np(rj.res_history)[:4], rtol=1e-3)
    uj = np.asarray(jmg.extract_solution(rj.u, 128))
    np.testing.assert_allclose(tmg.extract_solution(rt.u, 128).numpy(), uj,
                               rtol=0, atol=1e-4 * np.abs(uj).max())


def test_zebra_y_transposed_route_matches_jax():
    """With the kernels on, zebra_y solves the transposed problem on the
    zebra_x kernels and transposes back; against the JAX direct zebra_y
    solve, with a forcing and a boundary that are not symmetric in (x,
    y)."""
    cj, ct = _configs(finest_level=5, coarsest_level=3,
                      **dict(ZEBRA, smoother="zebra_y"))
    kw = dict(eps_x=0.05, eps_y=1.0, angle=math.radians(30),
              coarsening="full", forcing=_forcing, num_cycles=3, tol=None)
    g = lambda x, y: x - 2.0 * y * y  # noqa: E731
    rj = jmg.solve_anisotropic(5, config=cj, boundary=g, **kw)
    rt = tmg.solve_anisotropic(5, config=ct, boundary=g, device="cpu", **kw)
    np.testing.assert_allclose(_np(rt.res_history), _np(rj.res_history),
                               rtol=1e-3)
    uj = np.asarray(jmg.extract_solution(rj.u, 32))
    ut = tmg.extract_solution(rt.u, 32).numpy()
    assert rt.u.is_contiguous()
    np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-4 * np.abs(uj).max())


def test_f32_fmg_matches_jax():
    cj, ct = _configs(finest_level=5, coarsest_level=3, **ZEBRA)
    kw = dict(eps_x=1.0, eps_y=0.05, angle=ANGLE, coarsening="full",
              use_fmg=True, num_cycles=2, tol=None)
    rj = jmg.solve_anisotropic(5, config=cj, **kw)
    rt = tmg.solve_anisotropic(5, config=ct, device="cpu", **kw)
    np.testing.assert_allclose(_np(rt.res_history)[:2],
                               _np(rj.res_history)[:2], rtol=1e-2)


def test_f64_smoothed_coarsest_matches_jax():
    """Level 6 in float64 with a smoothed coarsest level, 4 zebra sweeps
    (the JAX coarse inverse is stored in float32, which would floor a
    float64 solve)."""
    cj, ct = _configs(finest_level=6, coarsest_level=3, dtype="float64",
                      coarse_solver="smooth", coarse_smooth_sweeps=4,
                      use_kernels=False, **ZEBRA)
    kw = dict(eps_x=1.0, eps_y=0.05, angle=ANGLE, coarsening="full",
              tol=1e-8)
    rj = jmg.solve_anisotropic(6, config=cj, **kw)
    rt = tmg.solve_anisotropic(6, config=ct, device="cpu", **kw)
    assert rt.iterations == int(rj.iterations) and rt.converged
    np.testing.assert_allclose(_np(rt.res_history), _np(rj.res_history),
                               rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(_np(rt.u), _np(rj.u), rtol=0, atol=1e-12)


def test_aniso_interop_round_trip():
    """A JAX anisotropic hierarchy (rotated, Galerkin) carried across with
    var_hierarchy_from_numpy, with its kernel planes: the same levels and
    coarse inverse as the port builds, so the port's solve on it is its
    own bitwise (and that one follows the JAX solve,
    test_f64_smoothed_coarsest_matches_jax)."""
    cj, ct = _configs(finest_level=5, coarsest_level=3, dtype="float64",
                      use_kernels=False, **ZEBRA)
    pj = jmg.AnisotropicPoissonProblem(cj, eps_x=1.0, eps_y=0.05,
                                       angle=ANGLE)
    levels = [dict(coef=np.asarray(op.coef),
                   inv_diag=np.asarray(op.inv_diag), n=op.n, S=op.S,
                   is_symmetric=op.is_symmetric,
                   coef_sym=np.asarray(JV._flat_coef(op)))
              for op in pj.hierarchy.levels]
    hier = interop.var_hierarchy_from_numpy(
        levels, np.asarray(pj.hierarchy.coarse_inv))
    pt = tmg.AnisotropicPoissonProblem(ct, eps_x=1.0, eps_y=0.05,
                                       angle=ANGLE, device="cpu")
    for t, j in zip(pt.hierarchy.levels, hier.levels):
        _same_op(t, j)
    assert hier.levels[0].coef_sym.shape == (5, 33, 33)
    b = interop.tensor_from_numpy(np.asarray(pj.rhs()))
    assert torch.equal(b, pt.rhs())
    rt = tmg.solve_fixed(hier, ct, b, 4)
    assert torch.equal(rt.u, tmg.solve_fixed(pt.hierarchy, ct, b, 4).u)
    assert torch.equal(hier.coarse_inv, pt.hierarchy.coarse_inv)
    hist = _np(rt.res_history)
    assert hist[-1] < 0.1 * hist[0]


@pytest.mark.parametrize("case", ["semi", "auto-semi", "semi-rotated",
                                  "mesh", "smooth_dtype", "box"])
def test_unported_anisotropic_options_raise(case):
    cfg = tmg.MultigridConfig(finest_level=5, coarsest_level=3)
    kw = dict(eps_x=1.0, eps_y=0.05, device="cpu", config=cfg)
    if case == "box":
        op = anisotropic.anisotropic_poisson_op(32, 33, 1.0, 0.05)
        with pytest.raises(NotImplementedError):
            operators.VarStencilOp(op.coef, op.inv_diag, 32, 33,
                                   box=(0, 31, 1, 31))
        op.box = (0, 31, 1, 31)
        with pytest.raises(NotImplementedError):
            lines.zebra_sweeps(op, None, None, 1)
        return
    err = NotImplementedError
    if case == "semi":
        kw["coarsening"] = "semi"
    elif case == "semi-rotated":
        kw.update(coarsening="semi", angle=0.3)
        err = ValueError
    elif case == "mesh":
        kw["mesh"] = object()
    elif case == "smooth_dtype":
        kw["config"] = dataclasses.replace(cfg, smooth_dtype=torch.bfloat16)
    with pytest.raises(err):
        tmg.solve_anisotropic(5, **kw)
    if case == "auto-semi":
        # A 20:1 axis-aligned anisotropy with a point smoother resolves to
        # semi-coarsening; a zebra smoother or a rotation keeps it full.
        res = tmg.solve_anisotropic(5, eps_x=1.0, eps_y=0.05, device="cpu",
                                    config=dataclasses.replace(
                                        cfg, smoother="zebra_x"),
                                    num_cycles=1, tol=None)
        assert res.iterations == 1


def test_front_door_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is that card")
    cfg = tmg.MultigridConfig(finest_level=5, coarsest_level=3,
                              smoother="zebra_x")
    for call in (lambda: tmg.solve_anisotropic(5, config=cfg),
                 lambda: tmg.AnisotropicPoissonProblem(cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# ---------------------------------------------------------------------------
# Dispatch: which wrapper each step of the path calls
# ---------------------------------------------------------------------------

ZEBRA_ENTRIES = list(TZ.LAUNCHES)


@pytest.fixture
def launched(monkeypatch):
    """Launches per wrapper as the card would count them: each call of a
    zebra wrapper adds ``kernels.lines.launches(entry, sweeps)`` (its sweeps
    is its last positional argument), the prolong-add wrapper 1."""
    counts = dict.fromkeys(ZEBRA_ENTRIES + ["prolong_add"], 0)
    for name in ZEBRA_ENTRIES:
        def spy(*a, _fn=getattr(TZ, name), _name=name, **kw):
            counts[_name] += TZ.launches(_name, a[-1])
            return _fn(*a, **kw)
        monkeypatch.setattr(TZ, name, spy)

    def spy_add(*a, _fn=TT.prolong_add, **kw):
        counts["prolong_add"] += 1
        return _fn(*a, **kw)
    monkeypatch.setattr(TT, "prolong_add", spy_add)
    return counts


def zebra_launches(cycles, pairs, sweeps=1):
    """Launches of ``cycles`` cycles of the fused zebra path over ``pairs``
    level pairs: K1z on each pair, K2z on each but the finest, whose K2z
    fuses the residual norm (chip_smoke.py checks the same formula)."""
    return {"zebra_sweeps": 0,
            "zebra_smooth_restrict": cycles * pairs * TZ.launches(
                "zebra_smooth_restrict", sweeps),
            "prolong_zebra_smooth": cycles * (pairs - 1) * TZ.launches(
                "prolong_zebra_smooth", sweeps),
            "prolong_zebra_smooth_resnorm": cycles * TZ.launches(
                "prolong_zebra_smooth_resnorm", sweeps),
            "prolong_add": 0}


def _solve(cycles, **kw):
    cfg = tmg.MultigridConfig(finest_level=7, coarsest_level=3,
                              use_kernels=True, **dict(ZEBRA, **kw))
    return tmg.solve_anisotropic(7, eps_x=1.0, eps_y=0.05, angle=ANGLE,
                                 coarsening="full", config=cfg,
                                 num_cycles=cycles, tol=None, device="cpu")


def test_fused_dispatch_counts(launched):
    """Level 7 padded to 256: 4 pairs, each K1z + K2z; per cycle 4 K1z
    (3 launches each), 3 K2z (3), 1 K2z-resnorm (5)."""
    _solve(2)
    assert launched == zebra_launches(2, pairs=4)
    assert zebra_launches(1, pairs=4) == {
        "zebra_sweeps": 0, "zebra_smooth_restrict": 12,
        "prolong_zebra_smooth": 9, "prolong_zebra_smooth_resnorm": 5,
        "prolong_add": 0}


def test_unfused_dispatch_counts(launched):
    """restriction="injection" runs every pair unfused: the zebra smoother
    before and after, the plain injection, the prolong-add kernel."""
    _solve(2, restriction="injection")
    want = dict.fromkeys(launched, 0)
    want.update(zebra_sweeps=2 * 4 * 2 * TZ.launches("zebra_sweeps", 1),
                prolong_add=2 * 4)
    assert launched == want


def test_smoothed_coarsest_dispatch_counts(launched):
    """A smoothed coarsest level runs its 6 sweeps on the zebra smoother,
    once per cycle, beside the fused pairs."""
    _solve(2, coarse_solver="smooth", coarse_smooth_sweeps=6)
    want = zebra_launches(2, pairs=4)
    want["zebra_sweeps"] = 2 * TZ.launches("zebra_sweeps", 6)
    assert launched == want
