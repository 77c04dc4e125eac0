"""The port's distributed fused FAS tier against the JAX package, on the
CPU, from the same numpy inputs: K1f-local and K2f-local (both families)
against the Pallas kernels in interpret mode, the replicated tail, the
(1, 1) slice against the JAX fused FAS tier, a gloo (2, 2) mesh against the
JAX plain shard FAS tier and the port's own (1, 1) run, an until-tol solve,
the three front doors' mesh route and their refusals, and the kernels'
dispatch counts.

The (2, 2) mesh comes from ``dist.run_on_mesh`` (gloo, spawned ranks
running ``torch_dist_ranks``, which imports no JAX): one spawn.

Tolerances, as tests/test_torch_fas.py holds the single-device FAS
kernels: the plain versions take the Pallas kernels' order of operations,
so on the owned region the iterate and the FAS right-hand side agree to
1e-5 of the largest value (XLA:CPU may contract multiply-adds into FMAs,
torch does not), the owned residual's sum of squares to rtol 1e-5, and the
injected solution bitwise wherever the smoothed iterate agrees bitwise.
Slices: histories rtol 1e-4 and iterates 1e-6 of max|u| against the JAX
fused tier; across meshes the JAX package's own bounds
(tests/test_dist_fas_pallas.py: histories rtol 3e-3, atol 2e-4 r0 against
the jnp tier; rtol 1e-4 between meshes, iterates rtol 1e-5, atol 1e-6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpu_multigrid import MultigridConfig as JConfig
from tpu_multigrid.dist import fas as JDF
from tpu_multigrid.dist import pallas_cycle as JPC
from tpu_multigrid.dist.fas import fas_sharded_solve
from tpu_multigrid.dist.fas_pallas import fas_sharded_solve_pallas
from tpu_multigrid.dist.mesh import make_grid_mesh as jax_mesh
from tpu_multigrid.kernels import localfas as JLF

import torch_dist_ranks as ranks
import tpu_multigrid_torch as tmg
from tpu_multigrid_torch import dist, interop
from tpu_multigrid_torch.core import ops
from tpu_multigrid_torch.core.operators import poisson_op
from tpu_multigrid_torch.dist import fas as DF
from tpu_multigrid_torch.dist import fas_pallas as FP
from tpu_multigrid_torch.dist import pallas_cycle as PC
from tpu_multigrid_torch.kernels import local as KL
from tpu_multigrid_torch.kernels import localfas as KLF

# One torch thread per test worker (see tests/test_torch_ops.py).
torch.set_num_threads(1)

GR, GC = KL.GR, KL.GC
LAM, GAMMA = 4.0, 2.0


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want, rel):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _jphi(u):
    return -LAM * jnp.exp(u)


def _ja(u):
    return 1.0 + GAMMA * u * u


# ---------------------------------------------------------------------------
# The kernels' plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

# tests/test_torch_dist.py's block: a 2 x 2 shard of a 512^2 grid at its
# four origins, n = 500 putting the far boundary inside the far shards.
R, C = 288, 768
LR, LC = R - 2 * GR, C - 2 * GC
ORIGINS = [(-GR, -GC), (LR - GR, -GC), (-GR, LC - GC), (LR - GR, LC - GC)]
N = 500
H2 = (1.0 / N) ** 2
OWN = (slice(GR, R - GR), slice(GC, C - GC))
COWN = (slice(GR, GR + LR // 2), slice(GC, GC + LC // 2))


def _inputs(seed):
    """u (scale 0.1), b and ec (scale 0.05) with random ghosts."""
    rng = np.random.default_rng(seed)
    u = (0.1 * rng.standard_normal((R, C))).astype(np.float32)
    b = rng.standard_normal((R, C)).astype(np.float32)
    ec = (0.05 * rng.standard_normal(KL.coarse_shape(R, C))).astype(
        np.float32)
    return u, b, ec


def _entries(family, sweeps):
    """(K1f, K2f) of a family on both sides: (jax call, port call) pairs
    taking (u, b, ec, origin); K2f with the resnorm."""
    om = 2.0 / 3.0
    if family == "bratu":
        tphi = tmg.BratuNonlinearity(LAM)
        return ((lambda u, b, o: JLF.fas_smooth_restrict_ext(
                     u, b, o, N, sweeps, om, _jphi, _jphi, H2),
                 lambda u, b, o: KLF.fas_smooth_restrict_ext(
                     u, b, o, N, sweeps, om, tphi, tphi, H2)),
                (lambda u, b, e, o: JLF.fas_prolong_smooth_ext(
                     u, b, e, o, N, sweeps, om, _jphi, _jphi, H2,
                     want_resnorm=True),
                 lambda u, b, e, o: KLF.fas_prolong_smooth_ext(
                     u, b, e, o, N, sweeps, om, tphi, tphi, H2,
                     want_resnorm=True)))
    ta = tmg.QuadraticCoefficient(GAMMA)
    return ((lambda u, b, o: JLF.qfas_smooth_restrict_ext(
                 u, b, o, N, sweeps, om, _ja),
             lambda u, b, o: KLF.qfas_smooth_restrict_ext(
                 u, b, o, N, sweeps, om, ta)),
            (lambda u, b, e, o: JLF.qfas_prolong_smooth_ext(
                 u, b, e, o, N, sweeps, om, _ja, want_resnorm=True),
             lambda u, b, e, o: KLF.qfas_prolong_smooth_ext(
                 u, b, e, o, N, sweeps, om, ta, want_resnorm=True)))


@pytest.mark.parametrize("family,sweeps", [("bratu", 2), ("quadratic", 3)])
@pytest.mark.parametrize("origin", ORIGINS)
def test_fas_ext_kernels_match_pallas(origin, family, sweeps):
    """K1f-local's (u', uc0, bc) and K2f-local's u' and owned sum of
    squares on the owned regions; uc0 bitwise wherever u' is; the
    non-resnorm K2f-local the resnorm one's u', bitwise."""
    u, b, ec = _inputs(7)
    (jk1, tk1), (jk2, tk2) = _entries(family, sweeps)
    org = jnp.asarray([origin], jnp.int32)
    with pltpu.force_tpu_interpret_mode():
        ju, juc, jbc = (np.asarray(x) for x in jk1(jnp.asarray(u),
                                                    jnp.asarray(b), org))
        jv, jss = jk2(jnp.asarray(u), jnp.asarray(b), jnp.asarray(ec), org)
    T = torch.tensor
    tu, tuc, tbc = tk1(T(u), T(b), origin)
    tv, tss = tk2(T(u), T(b), T(ec), origin)
    assert tuc.shape == tbc.shape == KL.coarse_shape(R, C)
    _close(_np(tu)[OWN], ju[OWN], 1e-5)
    _close(_np(tuc)[COWN], juc[COWN], 1e-5)
    _close(_np(tbc)[COWN], jbc[COWN], 1e-5)
    even = (slice(GR, R - GR, 2), slice(GC, C - GC, 2))
    same = _np(tu)[even] == ju[even]
    assert same.mean() > 0.5
    np.testing.assert_array_equal(_np(tuc)[COWN][same], juc[COWN][same])
    _close(_np(tv)[OWN], np.asarray(jv)[OWN], 1e-5)
    np.testing.assert_allclose(float(tss), float(jss), rtol=1e-5)
    if family == "bratu":
        plain = KLF.fas_prolong_smooth_ext(T(u), T(b), T(ec), origin, N,
                                           sweeps, 2.0 / 3.0,
                                           tmg.BratuNonlinearity(LAM),
                                           tmg.BratuNonlinearity(LAM), H2)
    else:
        plain = KLF.qfas_prolong_smooth_ext(T(u), T(b), T(ec), origin, N,
                                            sweeps, 2.0 / 3.0,
                                            tmg.QuadraticCoefficient(GAMMA))
    assert torch.equal(plain, tv)


def test_fas_ext_plain_defines_the_whole_array():
    """Outside the coarse interior and in the coarse frame uc0 and bc are
    0; u' is 0 on the block's dead cells; a caller's own callables run the
    plain versions."""
    u, b, ec = _inputs(8)
    origin = ORIGINS[3]
    T = torch.tensor
    cubic = lambda x: x * x * x        # noqa: E731
    v, uc0, bc = KLF.fas_smooth_restrict_ext(T(u), T(b), origin, N, 2,
                                             2.0 / 3.0, cubic, cubic, H2)
    live = KL._masks(R, C, origin, N, "cpu")[0]
    assert not v[~live].any()
    cm = KL.into_coarse(KL.coarse_mask(R, C, origin, N, "cpu"))
    assert not uc0[~cm].any() and not bc[~cm].any() and cm.sum() > 0
    np.testing.assert_array_equal(_np(uc0)[cm.numpy()],
                                  _np(v)[0::2, 0::2][
                                      KL.coarse_mask(R, C, origin, N,
                                                     "cpu").numpy()])
    w = KLF.qfas_prolong_smooth_ext(T(u), T(b), T(ec), origin, N, 1, 0.5,
                                    lambda x: 1.0 + x * x)
    assert not w[~live].any()


@pytest.mark.parametrize("case", ["f64", "shape", "depth"])
def test_fas_ext_entries_refuse_what_they_do_not_take(case):
    phi = tmg.BratuNonlinearity(LAM)
    u = torch.zeros((R, C))
    if case == "f64":
        with pytest.raises(NotImplementedError):
            KLF.fas_smooth_restrict_ext(u.double(), u.double(), (0, 0), N, 1,
                                        0.5, phi, phi, H2)
    elif case == "shape":
        with pytest.raises(ValueError, match="fas_supported_local"):
            KLF.qfas_prolong_smooth_ext(u[:R - 8], u[:R - 8], u, (0, 0), N,
                                        1, 0.5, tmg.QuadraticCoefficient(1))
    else:
        with pytest.raises(ValueError, match="fas_supported_local"):
            KLF.fas_prolong_smooth_ext(u, u, u, (0, 0), N, GR - 1, 0.5, phi,
                                       phi, H2)
    for steps in (1, GR - 2, GR - 1):
        assert KLF.fas_supported_local(R, C, steps, torch.float32) == \
            JLF.fas_supported_local(R, C, steps, jnp.float32)


# ---------------------------------------------------------------------------
# The replicated tail and the slice
# ---------------------------------------------------------------------------

def _one_rank():
    return dist.make_grid_mesh((1, 1), device="cpu")


def test_replicated_tail_matches_jax():
    """The same levels as JAX's ``build_replicated_tail``, the coarsest
    dense matrix bitwise; the nonlinear operators agree on a random
    iterate."""
    jcfg = JConfig(finest_level=8, coarsest_level=4, dtype=jnp.float32)
    jlv = JPC.pallas_level_sizes(jcfg, (1, 1), replicate_below=64)
    jt = JDF.build_replicated_tail(jlv, jcfg, _jphi, _jphi)
    cfg = tmg.MultigridConfig(finest_level=8, coarsest_level=4)
    lv = PC.pallas_level_sizes(cfg, (1, 1), replicate_below=64)
    assert lv == interop.sharded_levels_from_jax(jlv)
    phi = tmg.BratuNonlinearity(LAM)
    tail = DF.build_replicated_tail(lv, cfg, phi, phi, device="cpu")
    assert [(o.n, o.S) for o in tail.levels] == \
        [(o.n, o.S) for o in jt.levels]
    assert all(o.a_dense is None for o in tail.levels[:-1])
    np.testing.assert_array_equal(_np(tail.levels[-1].a_dense),
                                  np.asarray(jt.levels[-1].a_dense))
    assert tail.levels[-1].a_dense.dtype == torch.float32
    n, S = lv.sizes[-1]
    u = np.random.default_rng(3).standard_normal((S, S)).astype(np.float32)
    _close(tail.levels[-1].apply(torch.tensor(u)),
           np.asarray(jt.levels[-1].apply(jnp.asarray(u))), 1e-6)
    smooth = dataclasses.replace(cfg, coarse_solver="smooth")
    assert DF.build_replicated_tail(lv, smooth, phi, phi).levels[-1] \
        .a_dense is None


def test_local_nonlinear_operator_matches_the_pointwise_op():
    """``dist.fas``'s rank-local N(u) and b - N(u) on a one-rank mesh
    against ``PointwiseNonlinearOp`` on the same (S, S) grid, Bratu; the
    wrapped one-ring halo lands only on masked boundary cells."""
    n, S = 256, 264
    rng = np.random.default_rng(4)
    u, b = (torch.tensor(rng.standard_normal((S, S)).astype(np.float32))
            for _ in range(2))
    phi = tmg.BratuNonlinearity(LAM)
    op = tmg.PointwiseNonlinearOp(poisson_op(n, S), phi, phi)
    h2 = (1.0 / n) ** 2
    want = op.apply(u)
    inter = ops.interior_mask(S, n, "cpu")
    _close(DF._n_apply_local(_one_rank(), u, phi, n, h2), want, 1e-6)
    _close(DF._n_residual_local(_one_rank(), u, b, phi, n, h2),
           torch.where(inter, b - want, 0.0), 1e-6)


def _jax_slice(family, cycles):
    jcfg = JConfig(finest_level=8, coarsest_level=4, dtype=jnp.float32)
    nl = dict(a=_ja) if family == "quadratic" else dict(phi=_jphi,
                                                         dphi=_jphi)
    with pltpu.force_tpu_interpret_mode():
        return fas_sharded_solve_pallas(
            jcfg, jax_mesh(shape=(1, 1), devices=jax.devices()[:1]),
            num_cycles=cycles, tol=None, replicate_below=64, **nl)


def _port_nl(family):
    if family == "quadratic":
        return dict(a=tmg.QuadraticCoefficient(GAMMA))
    phi = tmg.BratuNonlinearity(LAM)
    return dict(phi=phi, dphi=phi)


@pytest.mark.parametrize("family", ["bratu", "quadratic"])
def test_slice_matches_jax_fused_fas_tier(family):
    """(1, 1) at level 8, coarsest level 4, replicate_below 64 (two sharded
    levels), 1 and 2 fixed cycles: the port's plain kernels against the
    Pallas kernels in interpret mode (a few seconds each).  The iterates
    agree to 1e-6 of max|u| after one cycle.  After two the float32
    roundings of the two packages have grown to ~2e-5 of max|u| for Bratu,
    as far as the JAX package's own two tiers part (its jnp shard tier and
    this fused tier differ by 1e-5 of max|u| there), and are held to 3e-5."""
    cfg = tmg.MultigridConfig(finest_level=8, coarsest_level=4)
    for cycles, rel in ((1, 1e-6), (2, 3e-5)):
        jres, jlv = _jax_slice(family, cycles)
        res, lv = dist.fas_sharded_solve_pallas(
            cfg, _one_rank(), num_cycles=cycles, tol=None,
            replicate_below=64, **_port_nl(family))
        assert lv == interop.sharded_levels_from_jax(jlv)
        assert lv.num_sharded == 2
        np.testing.assert_allclose(_np(res.res_history),
                                   np.asarray(jres.res_history), rtol=1e-4)
        _close(res.u, np.asarray(jres.u), rel)
        assert res.iterations == cycles and res.u.shape == (512, 512)
        assert res.res_history.dtype == torch.float32


def test_slice_across_ranks():
    """A gloo (2, 2) mesh at level 9 (two sharded levels), Bratu, 1 and 3
    fixed cycles: against the JAX plain shard FAS tier on (2, 2), and
    against the port's own (1, 1) run, which has one sharded level (S0 768
    against 1024: another layout and tail, the same iterates on the
    physical nodes).  After one cycle the two meshes agree to the JAX
    package's 1-vs-2 bounds (histories rtol 1e-4, iterates rtol 1e-5, atol
    1e-6).  Three cycles reach this size's float32 floor (~6e-3 of r0),
    where routes part by up to 1e-3 in the history (the JAX package's jnp
    tier, its fused tier and its single-device solve do, too): held to the
    cross-route bounds (rtol 3e-3, atol 2e-4 r0), the iterates to 3e-5 of
    max|u| as in :func:`test_slice_matches_jax_fused_fas_tier`."""
    n = 2 ** ranks.FAS_LEVEL
    phys = (slice(0, n + 1), slice(0, n + 1))
    out = dist.run_on_mesh(ranks.fas_program, (2, 2), backend="gloo",
                           device="cpu")
    runs, sizes, num_sharded = out[0]
    assert num_sharded == 2 and sizes[:3] == ((512, 1024), (256, 512),
                                              (128, 256))
    for o in out[1:]:
        for cycles, (h, u) in runs.items():
            assert torch.equal(o[0][cycles][0], h)
            assert torch.equal(o[0][cycles][1], u)
    hist, u = runs[ranks.FAS_CYCLES]

    jcfg = JConfig(finest_level=ranks.FAS_LEVEL, coarsest_level=4,
                   dtype=jnp.float32)
    jres, _ = fas_sharded_solve(
        jcfg, jax_mesh(shape=(2, 2), devices=jax.devices()[:4]),
        phi=_jphi, dphi=_jphi, num_cycles=ranks.FAS_CYCLES, tol=None,
        replicate_below=8)
    jh = np.asarray(jres.res_history)
    np.testing.assert_allclose(_np(hist), jh, rtol=3e-3,
                               atol=2e-4 * float(jh[0]))

    one, _, one_sharded = ranks.fas_program(_one_rank())
    assert one_sharded == 1
    h1, u1 = runs[1]
    np.testing.assert_allclose(_np(h1), _np(one[1][0]), rtol=1e-4)
    np.testing.assert_allclose(_np(u1)[phys], _np(one[1][1])[phys],
                               rtol=1e-5, atol=1e-6)
    h3 = _np(one[ranks.FAS_CYCLES][0])
    np.testing.assert_allclose(_np(hist), h3, rtol=3e-3,
                               atol=2e-4 * float(h3[0]))
    _close(_np(u)[phys], _np(one[ranks.FAS_CYCLES][1])[phys], 3e-5)


def test_quasilinear_until_tol():
    """tests/test_dist_fas_pallas.py's until-tol case on (1, 1): coarsest
    level 3 with 40 Picard sweeps, tol 1e-3 (above this size's f32 floor,
    ~4e-4 of r0), in at most 10 cycles."""
    cfg = tmg.MultigridConfig(finest_level=8, coarsest_level=3,
                              coarse_smooth_sweeps=40)
    res, _ = dist.fas_sharded_solve_pallas(
        cfg, _one_rank(), a=tmg.QuadraticCoefficient(GAMMA), tol=1e-3,
        max_cycles=10, replicate_below=64)
    h = _np(res.res_history)
    it = res.iterations
    assert res.converged and it <= 10 and h[it] / h[0] <= 1e-3
    assert np.isnan(h[it + 1:]).all() and not res.stalled


# ---------------------------------------------------------------------------
# The front doors and the refusals
# ---------------------------------------------------------------------------

def _cubic(u):
    return u * u * u


def _dcubic(u):
    return 3.0 * u * u


@pytest.mark.parametrize("door", ["bratu", "nonlinear", "quasilinear"])
def test_doors_route_to_the_fused_fas_tier(door):
    """Each door's mesh route on a one-rank CPU mesh gives
    ``dist.fas_sharded_solve_pallas``'s result, bitwise; the quasilinear
    door keeps its 40-sweep coarsest level."""
    mesh = _one_rank()
    kw = dict(mesh=mesh, dist_path="pallas", num_cycles=2)
    cfg = tmg.MultigridConfig(finest_level=8, coarsest_level=4)
    drv = dict(num_cycles=2, tol=1e-8)
    if door == "bratu":
        res = tmg.solve_bratu(8, lam=LAM, config=cfg, **kw)
        phi = tmg.BratuNonlinearity(LAM)
        want, _ = dist.fas_sharded_solve_pallas(cfg, mesh, phi=phi, dphi=phi,
                                                forcing=0.0, **drv)
    elif door == "nonlinear":
        res = tmg.solve_nonlinear_poisson(8, phi=_cubic, dphi=_dcubic,
                                          config=cfg, device="cpu", **kw)
        want, _ = dist.fas_sharded_solve_pallas(cfg, mesh, phi=_cubic,
                                                dphi=_dcubic, **drv)
    else:
        res = tmg.solve_quasilinear_diffusion(8, gamma=GAMMA, **kw)
        cfg = tmg.MultigridConfig(finest_level=8, coarse_solver="smooth",
                                  coarse_smooth_sweeps=40)
        want, _ = dist.fas_sharded_solve_pallas(
            cfg, mesh, a=tmg.QuadraticCoefficient(GAMMA), **drv)
    assert torch.equal(res.res_history, want.res_history)
    assert torch.equal(res.u, want.u) and res.iterations == 2


@pytest.mark.parametrize("case", ["fmg", "jnp", "default_path", "ndim3",
                                  "path", "device", "smoother",
                                  "exactly_one", "both", "no_stop",
                                  "no_shard", "u0"])
def test_mesh_route_refusals(case):
    mesh = _one_rank()
    cfg = tmg.MultigridConfig(finest_level=8, coarsest_level=4)
    kw = dict(config=cfg, mesh=mesh, dist_path="pallas", num_cycles=1)
    phi = tmg.BratuNonlinearity(LAM)
    if case == "fmg":
        with pytest.raises(ValueError, match="FMG"):
            tmg.solve_bratu(8, use_fmg=True, **kw)
    elif case == "jnp":
        with pytest.raises(NotImplementedError, match="queue 1 item 16"):
            tmg.solve_quasilinear_diffusion(8, **{**kw, "dist_path": "jnp"})
    elif case == "default_path":
        with pytest.raises(NotImplementedError):
            tmg.solve_nonlinear_poisson(8, phi=_cubic, dphi=_dcubic,
                                        config=cfg, mesh=mesh)
    elif case == "ndim3":
        with pytest.raises(NotImplementedError, match="GSPMD"):
            tmg.solve_bratu(5, ndim=3, mesh=mesh, dist_path="pallas")
    elif case == "path":
        with pytest.raises(ValueError):
            tmg.solve_bratu(8, **{**kw, "dist_path": "nccl"})
    elif case == "device":
        with pytest.raises(ValueError, match="mesh's device"):
            tmg.solve_bratu(8, device="cuda", **kw)
    elif case == "smoother":
        with pytest.raises(ValueError, match="smoother"):
            tmg.solve_bratu(8, **{**kw, "config": dataclasses.replace(
                cfg, smoother="rbgs")})
    elif case == "exactly_one":
        with pytest.raises(ValueError, match="exactly one"):
            dist.fas_sharded_solve_pallas(cfg, mesh)
    elif case == "both":
        with pytest.raises(ValueError, match="exactly one"):
            dist.fas_sharded_solve_pallas(cfg, mesh, phi=phi, dphi=phi,
                                          a=tmg.QuadraticCoefficient(1.0))
    elif case == "no_stop":
        with pytest.raises(ValueError, match="tol or num_cycles"):
            dist.fas_sharded_solve_pallas(cfg, mesh, phi=phi, dphi=phi,
                                          tol=None)
    elif case == "no_shard":
        one = tmg.MultigridConfig(finest_level=3, coarsest_level=3)
        with pytest.raises(ValueError, match="jnp FAS shard tier"):
            dist.fas_sharded_solve_pallas(one, mesh, phi=phi, dphi=phi,
                                          num_cycles=1)
    else:
        with pytest.raises(ValueError, match="global"):
            dist.fas_sharded_solve_pallas(cfg, mesh, phi=phi, dphi=phi,
                                          num_cycles=1,
                                          u0=torch.zeros((8, 8)))


def test_u0_starts_where_a_run_stopped():
    """A run from the iterate after two cycles starts at that residual."""
    mesh = _one_rank()
    cfg = tmg.MultigridConfig(finest_level=8, coarsest_level=4)
    phi = tmg.BratuNonlinearity(LAM)
    two, _ = dist.fas_sharded_solve_pallas(cfg, mesh, phi=phi, dphi=phi,
                                           num_cycles=2, tol=None)
    again, _ = dist.fas_sharded_solve_pallas(cfg, mesh, phi=phi, dphi=phi,
                                             num_cycles=1, tol=None,
                                             u0=two.u.clone())
    torch.testing.assert_close(again.res_history[0], two.res_history[2],
                               rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# Dispatch counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family,cycle", [("bratu", "V"), ("quadratic", "V"),
                                          ("bratu", "W"), ("bratu", "F")])
def test_dispatch_counts(monkeypatch, family, cycle):
    """One K1f-local per sharded level visit, one K2f-local per visit but
    the finest, whose K2f-local carries the resnorm, once per cycle.  Two
    sharded levels: a V-cycle visits the second once, W and F twice."""
    prefix = "qfas_" if family == "quadratic" else "fas_"
    names = [prefix + "smooth_restrict_ext", prefix + "prolong_smooth_ext"]
    calls = {"k1": 0, "k2": 0, "k2_resnorm": 0}

    def spy(name):
        real = getattr(KLF, name)

        def wrapped(*a, **kw):
            if "smooth_restrict" in name:
                calls["k1"] += 1
            elif kw.get("want_resnorm"):
                calls["k2_resnorm"] += 1
            else:
                calls["k2"] += 1
            return real(*a, **kw)
        return wrapped
    for name in names:
        monkeypatch.setattr(KLF, name, spy(name))
    cfg = tmg.MultigridConfig(finest_level=8, coarsest_level=4, cycle=cycle)
    cycles = 3
    res, lv = FP.fas_sharded_solve_pallas(
        cfg, _one_rank(), num_cycles=cycles, tol=None, replicate_below=64,
        **_port_nl(family))
    assert lv.num_sharded == 2 and res.iterations == cycles
    visits = 1 if cycle == "V" else 2
    assert calls == {"k1": cycles * (1 + visits),
                     "k2": cycles * visits, "k2_resnorm": cycles}
    assert KLF.LAUNCHES == dict.fromkeys(KLF.LAUNCHES, 0)   # CPU: plain
