"""The port's distributed fused tier against the JAX package, on the CPU,
from the same numpy inputs: the four kernels of ``dist.refine_pallas``
(K0-local, the compensated residuals, the exact-pair prolongation, the
compensated add) against the Pallas kernels in interpret mode, the ghost
refresh and the gather / scatter on gloo (2, 2) and (2, 1) meshes against
``refresh_ghosts`` under ``shard_map``, the level layout, the refined solve
against the JAX fused tier on (1, 1) and against the JAX plain shard tier
on (2, 2), the fused V-cycle driver through the front door, and the front
door's refusals.

Multi-rank meshes come from ``dist.run_on_mesh`` (gloo, spawned ranks
running ``torch_dist_ranks``, which imports no JAX): three spawns in all.
Each runs inside one test, so a parallel test run spawns each once.

Tolerances.  The kernels' plain versions take the Pallas kernels' order of
operations on the owned region: the smoothing steps and the residual agree
to 1e-5 of the largest value (XLA:CPU may contract multiply-adds into FMAs,
torch does not), the compensated residuals and the prolonged pair's sum to
1e-6 of the inputs' scale, the compensated add (elementwise, the same f32
steps) bitwise.  The ghost refresh copies values: bitwise.  Refined
histories agree with the JAX fused tier to rtol 1e-4 and the iterates to
1e-6 of max|u|; across ranks and tiers as tests/test_refine_pallas.py
holds the JAX tiers (history ratios rtol 2e-2, iterates rtol 1e-4, atol
1e-8), and V-cycle histories as tests/test_dist_pallas.py does (rtol 3e-3,
atol 2e-4 r0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import PartitionSpec as P

from tpu_multigrid import MultigridConfig as JConfig
from tpu_multigrid.dist import pallas_cycle as JPC
from tpu_multigrid.dist.mesh import make_grid_mesh as jax_mesh
from tpu_multigrid.dist.refine import refined_sharded_solve
from tpu_multigrid.dist.refine_pallas import refined_sharded_solve_pallas
from tpu_multigrid.dist.shard_cycle import sharded_solve
from tpu_multigrid.kernels import local as JL
from tpu_multigrid.kernels import localref as JR

import torch_dist_ranks as ranks
import tpu_multigrid_torch as tmg
from tpu_multigrid_torch import dist, interop, precision
from tpu_multigrid_torch.core import ops
from tpu_multigrid_torch.dist import pallas_cycle as PC
from tpu_multigrid_torch.kernels import local as KL
from tpu_multigrid_torch.kernels import localref as KR

# One torch thread per test worker (see tests/test_torch_ops.py).
torch.set_num_threads(1)

GR, GC = KL.GR, KL.GC


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want, rel):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-300))


# ---------------------------------------------------------------------------
# The kernels' plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

# A (288, 768) block: a 2 x 2 shard of a 512^2 grid (lr = lc = 256).  Its
# origins: the top-left shard (ghosts outside the grid) and the three
# others; n = 500 puts the grid's far boundary inside the far shards.
R, C = 288, 768
LR, LC = R - 2 * GR, C - 2 * GC
ORIGINS = [(-GR, -GC), (LR - GR, -GC), (-GR, LC - GC), (LR - GR, LC - GC)]
N = 500
OWN = (slice(GR, R - GR), slice(GC, C - GC))


def _blocks(seed, count, shape=(R, C)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for _ in range(count)]


def _org(origin):
    return jnp.asarray([origin], jnp.int32)


@pytest.mark.parametrize("origin", ORIGINS)
def test_smooth_and_residual_ext_match_pallas(origin):
    """K0-local: Jacobi 2, Chebyshev 3, RB-GS 1 (colours from negative
    global coordinates at the top-left shard) and the residual."""
    u, b = _blocks(1, 2)
    cases = [("jacobi", 2.0 / 3.0, 2), ("jacobi", ops.chebyshev_omegas(3, 0.4),
                                         3), ("rbgs", 2.0 / 3.0, 1)]
    with pltpu.force_tpu_interpret_mode():
        want = [JL.smooth_ext(jnp.asarray(u), jnp.asarray(b), _org(origin),
                              N, sw, sm, om) for sm, om, sw in cases]
        want_r = JL.residual_ext(jnp.asarray(u), jnp.asarray(b),
                                 _org(origin), N)
    tu, tb = torch.tensor(u), torch.tensor(b)
    for (sm, om, sw), w in zip(cases, want):
        got = KL.smooth_ext(tu, tb, origin, N, sw, sm, om)
        _close(_np(got)[OWN], np.asarray(w)[OWN], 1e-5)
    _close(_np(KL.residual_ext(tu, tb, origin, N))[OWN],
           np.asarray(want_r)[OWN], 1e-5)
    assert KL.smooth_ext(tu, tb, origin, N, 0) is tu


@pytest.mark.parametrize("origin", ORIGINS)
def test_comp_residuals_ext_match_pallas(origin):
    b, uh, um, ul = _blocks(2, 4)
    um *= 1e-8
    ul *= 1e-15
    with pltpu.force_tpu_interpret_mode():
        jd = JR.ds_residual_ext(*map(jnp.asarray, (b, uh, um)),
                                _org(origin), N)
        jt = JR.ts_residual_ext(*map(jnp.asarray, (b, uh, um, ul)),
                                _org(origin), N)
    T = torch.tensor
    td = KR.ds_residual_ext(T(b), T(uh), T(um), origin, N)
    tt = KR.ts_residual_ext(T(b), T(uh), T(um), T(ul), origin, N)
    scale = float(np.abs(b).max())
    np.testing.assert_allclose(_np(td)[OWN], np.asarray(jd)[OWN], rtol=0,
                               atol=1e-6 * scale)
    np.testing.assert_allclose(_np(tt)[OWN], np.asarray(jt)[OWN], rtol=0,
                               atol=1e-6 * scale)
    # The residual is zero outside the live cells.
    live = KL._masks(R, C, origin, N, "cpu")[0]
    assert not td[~live].any() and not tt[~live].any()


@pytest.mark.parametrize("origin", ORIGINS)
def test_prolong_pair_ext_matches_pallas(origin):
    """Compared by the component sums, in float64."""
    ec_hi, ec_lo = _blocks(3, 2, KL.coarse_shape(R, C))
    ec_lo *= 1e-8
    with pltpu.force_tpu_interpret_mode():
        jh, jl = JR.prolong_pair_ext(jnp.asarray(ec_hi), jnp.asarray(ec_lo),
                                     _org(origin), N)
    th, tl = KR.prolong_pair_ext(torch.tensor(ec_hi), torch.tensor(ec_lo),
                                 origin, N)
    got = _np(th)[OWN].astype(np.float64) + _np(tl)[OWN]
    want = np.asarray(jh)[OWN].astype(np.float64) + np.asarray(jl)[OWN]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * float(np.abs(ec_hi).max()))
    # p_hi + p_lo is the float64 prolongation of the coarse pair to ~eps^2.
    e64 = ec_hi.astype(np.float64) + ec_lo
    p64 = KL._prolonged(torch.tensor(e64), R, C)
    p64 = torch.where(KL._masks(R, C, origin, N, "cpu")[0], p64, 0.0)
    np.testing.assert_allclose(got, _np(p64)[OWN], rtol=0, atol=2e-13 * 4)


@pytest.mark.parametrize("k,m", [(2, 1), (2, 2), (3, 1), (3, 2)])
def test_comp_add_ext_matches_pallas(k, m):
    """Bitwise: the same elementwise f32 TwoSum steps."""
    rng = np.random.default_rng(4 + k + m)
    shape = (64 + 2 * GR, 256 + 2 * GC)
    comps = [(rng.standard_normal(shape) * 10.0 ** (-7 * i)).astype(
        np.float32) for i in range(k)]
    ys = [rng.standard_normal(shape).astype(np.float32) for _ in range(m)]
    with pltpu.force_tpu_interpret_mode():
        want = JR.comp_add_ext(tuple(map(jnp.asarray, comps)),
                               tuple(map(jnp.asarray, ys)))
    tc = [torch.tensor(c) for c in comps]
    got = KR.comp_add_ext(tc, [torch.tensor(y) for y in ys])
    for g, t, w in zip(got, tc, want):
        assert g is t
        np.testing.assert_array_equal(_np(g), np.asarray(w))


@pytest.mark.parametrize("k", [2, 3])
def test_comp_add_ext_plain_updates_in_place(k):
    """The plain version writes into its components and equals the chained
    ``precision.ds_add`` / ``ts_add``, bitwise."""
    g = torch.Generator().manual_seed(k)
    comps = [torch.randn((48, 768), generator=g) * 10.0 ** (-7 * i)
             for i in range(k)]
    ys = [torch.randn((48, 768), generator=g) for _ in range(2)]
    add = precision.ds_add if k == 2 else precision.ts_add
    want = tuple(c.clone() for c in comps)
    for y in ys:
        want = add(*want, y)
    ptrs = [c.data_ptr() for c in comps]
    got = KR.comp_add_ext_plain(comps, ys)
    assert [c.data_ptr() for c in got] == ptrs
    for c, w in zip(comps, want):
        assert torch.equal(c, w)


def test_entries_refuse_what_they_do_not_take():
    u = torch.zeros((R, C))
    with pytest.raises(NotImplementedError):
        KL.smooth_ext(u.double(), u.double(), (0, 0), N, 1)
    with pytest.raises(NotImplementedError):
        KR.ds_residual_ext(u.double(), u.double(), u.double(), (0, 0), N)
    with pytest.raises(ValueError):
        KR.prolong_pair_ext(u[:GR], u[:GR], (0, 0), N)
    with pytest.raises(ValueError):
        KR.comp_add_ext((u,), (u,))
    assert KR.supported_local_ref(R, C, torch.float32)
    assert not KR.supported_local_ref(R + 8, C, torch.float32)
    assert JR.supported_local_ref(R, C, jnp.float32)


# ---------------------------------------------------------------------------
# The ghost refresh across ranks
# ---------------------------------------------------------------------------

def _jax_refresh(mesh_shape, glob, n, lr, lc):
    my, mx = mesh_shape
    mesh = jax_mesh(shape=mesh_shape, devices=jax.devices()[:my * mx])
    spec = P("gy", "gx")
    out = {}
    for dr, dc in ranks.DEPTHS:
        f = jax.jit(shard_map(lambda x, dr=dr, dc=dc: JPC.refresh_ghosts(
            x, n, lr, lc, dr, dc), mesh=mesh, in_specs=spec, out_specs=spec,
            check_vma=False))
        out[(dr, dc)] = np.asarray(f(jnp.asarray(glob)))
    gather = jax.jit(shard_map(JPC.gather_owned, mesh=mesh, in_specs=spec,
                               out_specs=P(), check_vma=False))
    out["gather"] = np.asarray(gather(jnp.asarray(out[ranks.DEPTHS[0]])))
    scatter = jax.jit(shard_map(lambda f: JPC.scatter_owned(f, lr, lc),
                                mesh=mesh, in_specs=P(), out_specs=spec,
                                check_vma=False))
    out["scatter"] = np.asarray(scatter(jnp.asarray(
        glob[:my * lr, :mx * lc])))
    return out


@pytest.mark.parametrize("mesh_shape", [(2, 2), (2, 1)])
def test_refresh_gather_scatter_match_jax(mesh_shape):
    """Seeded random extended blocks, ghosts included: the refresh at full
    and lean depths, the gather of the owned regions and the scatter, on
    every rank bitwise equal to the JAX package's under ``shard_map``."""
    my, mx = mesh_shape
    lr, lc = 256, 512 // mx
    Rb, Cb = lr + 2 * GR, lc + 2 * GC
    glob = ranks.seeded_blocks(mesh_shape, 5, lr, lc)
    n = 500
    want = _jax_refresh(mesh_shape, glob, n, lr, lc)
    got = dist.run_on_mesh(ranks.refresh_program, mesh_shape, backend="gloo",
                           device="cpu", args=(5, n, lr, lc))
    for out in got:
        cy, cx = out["coords"]
        blk = (slice(cy * Rb, (cy + 1) * Rb), slice(cx * Cb, (cx + 1) * Cb))
        for depth in ranks.DEPTHS:
            np.testing.assert_array_equal(_np(out[depth]), want[depth][blk])
        np.testing.assert_array_equal(_np(out["gather"]), want["gather"])
        np.testing.assert_array_equal(_np(out["scatter"]),
                                      want["scatter"][blk])
        # interop carries the same block across.
        ext = interop.ext_block_from_numpy(glob[:my * lr, :mx * lc],
                                           mesh_shape, (cy, cx))
        assert torch.equal(ext, out["scatter"])


# ---------------------------------------------------------------------------
# The level layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_shape", [(1, 1), (1, 2), (2, 1), (2, 2),
                                        (2, 4)])
@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev", "rbgs"])
def test_level_sizes_match_jax(mesh_shape, smoother):
    for level in range(8, 15):
        for below in (128, 256):
            jcfg = JConfig(finest_level=level, coarsest_level=3,
                           smoother=smoother)
            tcfg = tmg.MultigridConfig(finest_level=level, coarsest_level=3,
                                       smoother=smoother)
            want = JPC.pallas_level_sizes(jcfg, mesh_shape,
                                          replicate_below=below)
            got = PC.pallas_level_sizes(tcfg, mesh_shape,
                                        replicate_below=below)
            assert got == interop.sharded_levels_from_jax(want)
    # Level 14 on one rank: (17440, 17920) extended blocks, 3 sharded.
    lv = PC.pallas_level_sizes(tmg.MultigridConfig(finest_level=14,
                                                   coarsest_level=5), (1, 1))
    assert lv.sizes[:4] == ((16384, 17408), (8192, 8704), (4096, 4352),
                            (2048, 2176)) and lv.num_sharded == 3


# ---------------------------------------------------------------------------
# The slice
# ---------------------------------------------------------------------------

def _one_rank():
    return dist.make_grid_mesh((1, 1), device="cpu")


def test_refined_fused_tier_matches_jax_fused_tier():
    """(1, 1) at level 8, ts with ds_levels 2, 2 iterations: the port's
    plain kernels against the Pallas kernels in interpret mode."""
    jcfg = JConfig(finest_level=8, coarsest_level=3, dtype=jnp.float32,
                   use_pallas=True)
    jmesh = jax_mesh(shape=(1, 1), devices=jax.devices()[:1])
    with pltpu.force_tpu_interpret_mode():
        jres, jlv = refined_sharded_solve_pallas(
            jcfg, jmesh, num_cycles=2, ts=True, ds_levels=2,
            replicate_below=128)
    cfg = tmg.MultigridConfig(finest_level=8, coarsest_level=3)
    res, lv = dist.refined_sharded_solve_pallas(
        cfg, _one_rank(), num_cycles=2, ts=True, ds_levels=2,
        replicate_below=128)
    assert lv == interop.sharded_levels_from_jax(jlv) and lv.num_sharded == 2
    np.testing.assert_allclose(_np(res.res_history),
                               np.asarray(jres.res_history), rtol=1e-4)
    _close(res.u, np.asarray(jres.u), 1e-6)
    assert res.iterations == 2 and res.converged
    assert len(res.components) == 3


def test_refined_prebuilt_must_match_the_layout():
    """``prebuilt=(levels, hier)`` of another layout (a level-9 build under
    a level-8 config, another coarsest level, levels and hierarchy of two
    builds) raises ``ValueError`` naming both layouts; a matching build
    gives the same solve as none."""
    mesh = _one_rank()
    cfg = tmg.MultigridConfig(finest_level=8, coarsest_level=3)
    kw = dict(num_cycles=1, ts=True, ds_levels=1, replicate_below=128)
    build = lambda c: PC.build_pallas_poisson(      # noqa: E731
        c, (1, 1), replicate_below=128, device="cpu")
    pre9 = build(tmg.MultigridConfig(finest_level=9, coarsest_level=3))
    pre5 = build(tmg.MultigridConfig(finest_level=8, coarsest_level=5))
    pre8 = build(cfg)
    for bad in (pre9, pre5, (pre8[0], pre5[1])):
        with pytest.raises(ValueError,
                           match=r"prebuilt.*against \(\(256, 512\)"):
            dist.refined_sharded_solve_pallas(cfg, mesh, prebuilt=bad, **kw)
    got, _ = dist.refined_sharded_solve_pallas(cfg, mesh, prebuilt=pre8,
                                               **kw)
    want, _ = dist.refined_sharded_solve_pallas(cfg, mesh, **kw)
    assert torch.equal(got.res_history, want.res_history)
    assert torch.equal(got.u, want.u)


def _ratios(h):
    h = _np(h)
    return h[1:] / h[0]


def test_slice_across_ranks():
    """A gloo (2, 2) mesh at level 9 (two sharded levels): the refined ts
    solve against the JAX plain shard tier and against the port's own
    (1, 1) run; 4 fused V-cycles through the front door against the JAX
    plain shard tier; until tol and FMG in the same cycles as on (1, 1);
    the lean ghost schedule bitwise equal to the full one."""
    level, n = 9, 512
    phys = (slice(0, n + 1), slice(0, n + 1))
    out = dist.run_on_mesh(ranks.solve_program, (2, 2), backend="gloo",
                           device="cpu", args=(level,))
    hist, u, sizes, num_sharded = out[0]["refined"]
    assert num_sharded == 2 and sizes[:3] == ((512, 1024), (256, 512),
                                              (128, 256))
    for o in out[1:]:
        assert torch.equal(o["refined"][0], hist)
        assert torch.equal(o["refined"][1], u)

    jcfg = JConfig(finest_level=level, coarsest_level=3, dtype=jnp.float32)
    jmesh = jax_mesh(shape=(2, 2), devices=jax.devices()[:4])
    jres, _ = refined_sharded_solve(jcfg, jmesh, num_cycles=2, ts=True,
                                    ds_levels=2, replicate_below=8)
    np.testing.assert_allclose(_ratios(hist), _ratios(jres.res_history),
                               rtol=2e-2)
    np.testing.assert_allclose(_np(u)[phys], np.asarray(jres.u)[phys],
                               rtol=1e-4, atol=1e-8)

    cfg = tmg.MultigridConfig(finest_level=level, coarsest_level=3)
    mesh = _one_rank()
    one, _ = dist.refined_sharded_solve_pallas(
        cfg, mesh, num_cycles=2, ts=True, ds_levels=2, replicate_below=128)
    np.testing.assert_allclose(_ratios(hist), _ratios(one.res_history),
                               rtol=2e-2)
    np.testing.assert_allclose(_np(u)[phys], _np(one.u)[phys], rtol=1e-4,
                               atol=1e-8)

    fixed_hist, fixed_u = out[0]["fixed"]
    jfix, _ = sharded_solve(jcfg, jmesh, num_cycles=4, tol=0.0,
                            replicate_below=8)
    jh = np.asarray(jfix.res_history)
    np.testing.assert_allclose(_np(fixed_hist), jh, rtol=3e-3,
                               atol=2e-4 * float(jh[0]))
    assert fixed_u.shape == (1024, 1024)

    door = dict(config=cfg, mesh=mesh, dist_path="pallas", refined=False)
    for key, kw in ranks.FMG_CASES:
        it, conv, _ = out[0][key]
        res = tmg.solve_poisson(level, max_cycles=30, **door, **kw)
        assert conv and res.converged and it == res.iterations, (key, it,
                                                                 res)

    (lean_h, lean_u), (full_h, full_u) = out[0]["halo"]
    assert torch.equal(lean_h, full_h) and torch.equal(lean_u, full_u)


def test_front_door_routes_and_refusals():
    cfg = tmg.MultigridConfig(finest_level=8, coarsest_level=3)
    mesh = _one_rank()
    kw = dict(config=cfg, mesh=mesh, dist_path="pallas")
    # tol < 1e-5 in float32 selects the refinement, as on one device.
    res = tmg.solve_poisson(8, num_cycles=2, tol=1e-8, **kw)
    assert len(res.components) == 2 and res.u.shape == (512, 512)
    res = tmg.solve_poisson(8, num_cycles=2, tol=1e-3, **kw)
    assert not hasattr(res, "components")
    # u0: a starting iterate on the global grid.
    again = tmg.solve_poisson(8, num_cycles=1, refined=False,
                              u0=res.u.clone(), **kw)
    torch.testing.assert_close(again.res_history[0], res.res_history[2],
                               rtol=1e-5, atol=0)
    for bad in (dict(dist_path="jnp"), dict(bc="periodic"),
                dict(neumann=("left",)), dict(order=4)):
        with pytest.raises(NotImplementedError):
            tmg.solve_poisson(8, **{**kw, **bad})
    with pytest.raises(NotImplementedError):
        tmg.solve_poisson(8, config=cfg, mesh=mesh)     # dist_path="jnp"
    for bad in (dict(boundary=1.0), dict(refined=True, u0=res.u),
                dict(refined=True, use_fmg=True), dict(dist_path="nccl"),
                dict(device="cuda"), dict(tol=None)):
        with pytest.raises(ValueError):
            tmg.solve_poisson(8, **{**kw, **bad})
    with pytest.raises(ValueError):
        tmg.solve_poisson(8, u0=res.u, device="cpu")
    with pytest.raises(ValueError):     # one level: none runs sharded
        tmg.solve_poisson(3, **{**kw, "config": tmg.MultigridConfig(
            finest_level=3, coarsest_level=3)})
    for door in (tmg.solve_diffusion, tmg.solve_poisson3d,
                 tmg.solve_bratu):
        with pytest.raises(NotImplementedError):
            door(5, mesh=mesh, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            dist.make_grid_mesh((1, 1))
    with pytest.raises(ValueError):
        dist.make_grid_mesh((2, 2), device="cpu")
