"""The port's distributed fused 3D tier against the JAX package, on the CPU,
from the same numpy inputs: the four kernel entries of a level visit
(K1_3-ext, K2_3-local and their variable-coefficient forms) against the
Pallas kernels in interpret mode at four shard origins, the level layouts,
the ghost refresh and the gather / scatter on gloo (2, 2) and (2, 1) meshes
against ``refresh_ghosts3`` under ``shard_map``, the per-rank coefficient
blocks against the JAX package's global layout, the three solvers against
the JAX fused 3D tier on (1, 1), the (2, 2) solves against the JAX
single-device solve and the port's own (1, 1) run, and the refusals and the
launch dispatch.

Multi-rank meshes come from ``dist.run_on_mesh`` (gloo, spawned ranks
running ``torch_dist_ranks``, which imports no JAX): two spawns in all.
The JAX 3D kernels under ``shard_map`` in interpret mode deadlock at four
virtual devices on this host (tests/test_dist_pallas3.py), so the JAX fused
tier runs on (1, 1) only; its refresh and gather are jnp and run on four.

Tolerances.  The kernels' plain versions take the Pallas kernels' order of
operations: on the owned fine and coarse regions they agree to 1e-5 of the
largest value (XLA:CPU may contract multiply-adds into FMAs, torch does
not), the owned sums of squares to rtol 1e-5.  The ghost refresh and the
coefficient blocks copy values: bitwise.  Against the JAX fused tier the
histories agree to rtol 1e-4 and the iterates after two cycles to 2e-6 of
max|u| (measured: 1.1e-6 for Poisson, 6e-7 for the variable coefficient;
the coarsest level's dense product and the norms sum in other orders), and
to 1e-5 for the nonsymmetric upwind operator with RB-GS (measured 7.5e-6).
Across meshes and against the single-device solve: the JAX package's own
bound, 1e-4 of max|u| (tests/test_dist_pallas3.py).
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
from tpu_multigrid.cycles import solve_fixed as jax_solve_fixed
from tpu_multigrid.dist import pallas_cycle3 as JP3
from tpu_multigrid.dist.shard_cycle3 import make_grid_mesh3 as jax_mesh3
from tpu_multigrid.kernels import transfer3d as JT3
from tpu_multigrid.kernels import vartransfer3d as JV3
from tpu_multigrid.problems import Poisson3DProblem
from tpu_multigrid.problems.diffusion3d import Diffusion3DProblem

import torch_dist_ranks as ranks
import tpu_multigrid_torch as tmg
from tpu_multigrid_torch import dist, interop, kernels
from tpu_multigrid_torch.core import ops
from tpu_multigrid_torch.dist import pallas_cycle3 as P3
from tpu_multigrid_torch.kernels import transfer3d as KT3
from tpu_multigrid_torch.kernels import vartransfer3d as KV3

# One torch thread per test worker (see tests/test_torch_ops.py).
torch.set_num_threads(1)

GZ, GY = P3.GZ3, P3.GY3


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

# An (80, 80, 128) block: a 2 x 2 shard of a 64^3 grid (lz = ly = 48), its
# (56, 56, 128) coarse block, and the four shard origins.
SHAPE, SHAPE_C, N = (80, 80, 128), (56, 56, 128), 64
ORIGINS = [(-GZ, -GY), (48 - GZ, -GY), (-GZ, 48 - GY), (48 - GZ, 48 - GY)]
OWN = (slice(GZ, SHAPE[0] - GZ), slice(GY, SHAPE[1] - GY))
OWN_C = (slice(GZ, SHAPE_C[0] - GZ), slice(GY, SHAPE_C[1] - GY))
# (smoother, omega, sweeps) of the K1 and K2 visits, and the planes of the
# var forms run with them.
CASES = [(("jacobi", ops.chebyshev_omegas(3, 0.4), 3),
          ("jacobi", ops.chebyshev_omegas(2, 0.4), 2), (3, 6)),
         (("rbgs", 1.0, 1), ("rbgs", 1.0, 1), (4,))]


def _inputs(seed):
    rng = np.random.default_rng(seed)
    u, b = (rng.standard_normal(SHAPE).astype(np.float32) for _ in range(2))
    ec = rng.standard_normal(SHAPE_C).astype(np.float32)
    coefs = {c: (0.5 + rng.random((c,) + SHAPE)).astype(np.float32)
             for c in (3, 4, 6)}
    return u, b, ec, coefs


def _org(origin):
    return jnp.asarray([origin], jnp.int32)


@pytest.mark.parametrize("origin", ORIGINS)
def test_ext_kernels_match_pallas(origin):
    """K1_3-ext and K2_3-local(-resnorm) with Chebyshev (3, 2) and RB-GS
    (1, 1) (colours from negative global coordinates at the corner shard),
    and K1v_3-ext / K2v_3-local(-resnorm) on 3 and 6 planes with Chebyshev
    and on 4 planes with RB-GS, on the owned fine and coarse regions; the
    resnorm form's u' is bitwise the plain form's, and the coarse block's
    frame is zero."""
    u, b, ec, coefs = _inputs(1)
    ju, jb, jec = map(jnp.asarray, (u, b, ec))
    tu, tb, tec = map(torch.tensor, (u, b, ec))
    for (sm1, om1, s1), (sm2, om2, s2), planes in CASES:
        # Each interpret-mode call is waited for before the next one is
        # dispatched: two in flight share the interpreter's global state.
        with pltpu.force_tpu_interpret_mode():
            want = [jax.block_until_ready(f()) for f in (
                lambda: JT3.smooth_restrict_ext3(ju, jb, _org(origin), N,
                                                 SHAPE_C, s1, sm1, om1),
                lambda: JT3.prolong_smooth_ext3(ju, jb, jec, _org(origin), N,
                                                s2, sm2, om2,
                                                want_resnorm=True))]
            for c in planes:
                jc = jnp.asarray(coefs[c])
                want += [jax.block_until_ready(f()) for f in (
                    lambda: JV3.var_smooth_restrict_ext3(
                        ju, jb, jc, _org(origin), N, SHAPE_C, s1, sm1, om1),
                    lambda: JV3.var_prolong_smooth_ext3(
                        ju, jb, jec, jc, _org(origin), N, s2, sm2, om2,
                        want_resnorm=True))]
        got = [KT3.smooth_restrict_ext3(tu, tb, origin, N, SHAPE_C, s1, sm1,
                                        om1),
               KT3.prolong_smooth_ext3(tu, tb, tec, origin, N, s2, sm2, om2,
                                       want_resnorm=True)]
        assert torch.equal(KT3.prolong_smooth_ext3(tu, tb, tec, origin, N,
                                                   s2, sm2, om2), got[1][0])
        for c in planes:
            tc = torch.tensor(coefs[c])
            got += [KV3.var_smooth_restrict_ext3(tu, tb, tc, origin, N,
                                                 SHAPE_C, s1, sm1, om1),
                    KV3.var_prolong_smooth_ext3(tu, tb, tec, tc, origin, N,
                                                s2, sm2, om2,
                                                want_resnorm=True)]
        for i, ((gu, g2), (wu, w2)) in enumerate(zip(got, want)):
            _close(_np(gu)[OWN], np.asarray(wu)[OWN], 1e-5)
            if i % 2 == 0:      # K1: the coarse block
                _close(_np(g2)[OWN_C], np.asarray(w2)[OWN_C], 1e-5)
                frame = torch.ones(SHAPE_C, dtype=torch.bool)
                frame[GZ // 2:GZ // 2 + SHAPE[0] // 2,
                      GY // 2:GY // 2 + SHAPE[1] // 2, :SHAPE[2] // 2] = False
                assert not g2[frame].any()
            else:               # K2: the owned sum of squares
                np.testing.assert_allclose(float(g2), float(w2), rtol=1e-5)


def test_ext_entries_refuse_what_they_do_not_take():
    u = torch.zeros(SHAPE)
    ec = torch.zeros(SHAPE_C)
    coef = torch.ones((3,) + SHAPE)
    with pytest.raises(NotImplementedError):
        KT3.smooth_restrict_ext3(u.double(), u.double(), (0, 0), N, SHAPE_C,
                                 1)
    with pytest.raises(ValueError, match="even"):
        KT3.prolong_smooth_ext3(u, u, ec, (-15, -16), N, 1)
    with pytest.raises(ValueError, match="extended-block"):   # steps + 2 > 16
        KT3.smooth_restrict_ext3(u, u, (-16, -16), N, SHAPE_C, 8, "rbgs")
    with pytest.raises(ValueError, match="extended-block"):
        KV3.var_prolong_smooth_ext3(u, u, ec[:, :48], coef, (-16, -16), N, 1)
    with pytest.raises(ValueError, match="coefficient"):
        KV3.var_smooth_restrict_ext3(u, u, coef[:, :64], (-16, -16), N,
                                     SHAPE_C, 1)
    assert KT3.supported_local3(SHAPE, SHAPE_C, 3, torch.float32)
    assert JT3.supported_local3(SHAPE, SHAPE_C, 3, jnp.float32)
    assert not KT3.supported_local3((80, 72, 128), (56, 52, 128), 3,
                                    torch.float32)
    assert not KV3.supported_local_var3(SHAPE, SHAPE_C, 3, torch.float32,
                                        nplanes=5)


# ---------------------------------------------------------------------------
# The level layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 1), (2, 2), (3, 1)])
def test_level_sizes3_match_jax(mesh_shape):
    """The Poisson and var layouts (3, 4 and 6 planes) at levels 6, 8, 9
    and 10, Chebyshev (3, 2) and RB-GS (1, 1) and (5, 5), two replication
    thresholds: the same sharded and replicated levels as JAX's, the
    level-10 six-plane (1, 1) case, which shards nothing, included."""
    for level in (6, 8, 9, 10):
        for sm, nu in (("chebyshev", (3, 2)), ("rbgs", (1, 1)),
                       ("rbgs", (5, 5))):
            jcfg = JConfig(finest_level=level, coarsest_level=3,
                           smoother=sm, nu1=nu[0], nu2=nu[1])
            tcfg = tmg.MultigridConfig(finest_level=level, coarsest_level=3,
                                       smoother=sm, nu1=nu[0], nu2=nu[1])
            for below in (16, 32):
                want = JP3.pallas_level_sizes3(jcfg, mesh_shape,
                                               replicate_below=below)
                got = P3.pallas_level_sizes3(tcfg, mesh_shape,
                                             replicate_below=below)
                assert got == interop.pallas_levels3_from_jax(want)
                for c in (3, 4, 6):
                    want = JP3.pallas_var_level_sizes3(
                        jcfg, mesh_shape, nplanes=c, replicate_below=below)
                    got = P3.pallas_var_level_sizes3(
                        tcfg, mesh_shape, nplanes=c, replicate_below=below)
                    assert got == interop.pallas_levels3_from_jax(want), (
                        level, sm, nu, below, c)
    lv = P3.pallas_var_level_sizes3(
        tmg.MultigridConfig(finest_level=10, coarsest_level=3,
                            smoother="chebyshev", nu1=3, nu2=2), (1, 1),
        nplanes=6)
    if mesh_shape == (1, 1):
        assert lv.num_sharded == 0
    # The 513^3 cell on one rank: two sharded levels, (576, 576, 640)
    # extended blocks.
    lv = P3.pallas_level_sizes3(tmg.MultigridConfig(
        finest_level=9, coarsest_level=3, smoother="chebyshev", nu1=3,
        nu2=2), (1, 1))
    assert lv.sizes[:3] == ((512, 544, 640), (256, 272, 384),
                            (128, 136, 256)) and lv.num_sharded == 2


# ---------------------------------------------------------------------------
# Ghost plumbing and coefficient blocks across ranks
# ---------------------------------------------------------------------------

def _jax_refresh3(mesh_shape, glob, n, lz, ly):
    mz, my = mesh_shape
    mesh = jax_mesh3(shape=mesh_shape, devices=jax.devices()[:mz * my])
    spec = P("gz", "gy", None)
    out = {}
    for dz, dy in ranks.DEPTHS3:
        f = jax.jit(shard_map(lambda x, dz=dz, dy=dy: JP3.refresh_ghosts3(
            x, n, lz, ly, dz, dy), mesh=mesh, in_specs=spec, out_specs=spec,
            check_vma=False))
        out[(dz, dy)] = np.asarray(f(jnp.asarray(glob)))
    gather = jax.jit(shard_map(JP3.gather_owned3, mesh=mesh, in_specs=spec,
                               out_specs=P(), check_vma=False))
    out["gather"] = np.asarray(gather(jnp.asarray(out[ranks.DEPTHS3[0]])))
    scatter = jax.jit(shard_map(lambda f: JP3.scatter_owned3(f, lz, ly),
                                mesh=mesh, in_specs=P(), out_specs=spec,
                                check_vma=False))
    out["scatter"] = np.asarray(scatter(jnp.asarray(
        glob[:mz * lz, :my * ly])))
    return out


def _check_refresh3(out, want, lz, ly):
    Rz, Ry = lz + 2 * GZ, ly + 2 * GY
    for o in out:
        cz, cy = o["coords"]
        blk = (slice(cz * Rz, (cz + 1) * Rz), slice(cy * Ry, (cy + 1) * Ry))
        for depth in ranks.DEPTHS3:
            np.testing.assert_array_equal(_np(o[depth]), want[depth][blk])
        np.testing.assert_array_equal(_np(o["gather"]), want["gather"])
        np.testing.assert_array_equal(_np(o["scatter"]), want["scatter"][blk])


def test_refresh_gather_scatter3_on_2x1_match_jax():
    """Seeded random extended blocks, ghosts included, on a gloo (2, 1)
    mesh: the refresh at full, lean and uneven depths, the gather and the
    scatter, on every rank bitwise equal to the JAX package's."""
    lz, ly, Sx, n = 48, 96, 128, 90
    glob = ranks.seeded_blocks3((2, 1), 7, lz, ly, Sx)
    want = _jax_refresh3((2, 1), glob, n, lz, ly)
    out = dist.run_on_mesh(ranks.refresh3_program, (2, 1), backend="gloo",
                           device="cpu", args=(7, n, lz, ly, Sx))
    _check_refresh3(out, want, lz, ly)


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 1), (2, 2), (3, 1)])
@pytest.mark.parametrize("nplanes", [3, 4, 6])
def test_ext_coef_blocks_match_jax_layout(mesh_shape, nplanes):
    """Each rank's ghost-inclusive coefficient block, cut from the stack,
    bitwise equal to its block of the JAX package's global layout."""
    mz, my = mesh_shape
    S = 96
    rng = np.random.default_rng(nplanes)
    stack = rng.random((nplanes, S, S, 128)).astype(np.float32)

    class Op:
        coef_stack = stack

    glob = JP3._ext_coef_layout3(Op(), mz, my)
    ez, ey = S // mz + 2 * GZ, S // my + 2 * GY
    for cz in range(mz):
        for cy in range(my):
            got = P3.ext_coef_block3(Op(), mesh_shape, (cz, cy))
            np.testing.assert_array_equal(
                got, glob[:, cz * ez:(cz + 1) * ez, cy * ey:(cy + 1) * ey])


# ---------------------------------------------------------------------------
# The solvers
# ---------------------------------------------------------------------------

def _one_rank():
    return dist.make_grid_mesh3((1, 1), device="cpu")


def _jax_cfg(**kw):
    return JConfig(finest_level=ranks.DIST3_LEVEL, coarsest_level=3,
                   dtype=jnp.float32, **{**dict(smoother="chebyshev",
                                                 nu1=3, nu2=2), **kw})


def _jax_fused(solver, **kw):
    jmesh = jax_mesh3(shape=(1, 1), devices=jax.devices()[:1])
    with pltpu.force_tpu_interpret_mode():
        res, lv = solver(num_cycles=ranks.DIST3_CYCLES, tol=0.0,
                         replicate_below=16, mesh=jmesh, **kw)
        jax.block_until_ready(res.u)
    return res, lv


def _against_jax(res, lv, jres, jlv, rel=2e-6):
    assert lv == interop.pallas_levels3_from_jax(jlv) and lv.num_sharded == 2
    np.testing.assert_allclose(_np(res.res_history),
                               np.asarray(jres.res_history), rtol=1e-4)
    _close(res.u, np.asarray(jres.u), rel)
    assert res.iterations == jres.iterations == ranks.DIST3_CYCLES
    assert res.converged == bool(jres.converged)


def test_poisson3_solve_matches_jax_fused_tier():
    jres, jlv = _jax_fused(JP3.sharded_solve_pallas3, config=_jax_cfg())
    res, lv = dist.sharded_solve_pallas3(
        ranks.dist3_config(), _one_rank(), num_cycles=ranks.DIST3_CYCLES,
        tol=0.0, replicate_below=16)
    _against_jax(res, lv, jres, jlv)
    assert tuple(res.u.shape) == (96, 96, 128)


def test_var3_solve_matches_jax_fused_tier():
    jres, jlv = _jax_fused(JP3.sharded_solve_pallas_var3, config=_jax_cfg(),
                           coefficient=ranks.dist3_coefficient)
    res, lv = dist.sharded_solve_pallas_var3(
        ranks.dist3_config(), _one_rank(), coefficient=ranks.dist3_coefficient,
        num_cycles=ranks.DIST3_CYCLES, tol=0.0, replicate_below=16)
    _against_jax(res, lv, jres, jlv)


# Polynomial winds: the same expressions on numpy (JAX) and torch (port).
WINDS = dict(bx=lambda x, y, z: x * (0.5 + z) - 0.25,
             by=lambda x, y, z: y * y - 0.3, bz=lambda x, y, z: x - y)


def test_conv3_solve_matches_jax_fused_tier():
    """Six directional planes, RB-GS (2, 1), eps = 0.1."""
    kw = dict(eps=0.1, **WINDS)
    jres, jlv = _jax_fused(JP3.sharded_solve_pallas_conv3,
                           config=_jax_cfg(smoother="rbgs", nu1=2, nu2=1),
                           **kw)
    cfg = tmg.MultigridConfig(finest_level=ranks.DIST3_LEVEL,
                              coarsest_level=3, smoother="rbgs", nu1=2, nu2=1)
    res, lv = dist.sharded_solve_pallas_conv3(
        cfg, _one_rank(), num_cycles=ranks.DIST3_CYCLES, tol=0.0,
        replicate_below=16, **kw)
    _against_jax(res, lv, jres, jlv, 1e-5)


def test_until_tol_and_stop_rule():
    """The until-tol driver stops at the tolerance (JAX's rule: r <= tol r0,
    while each cycle cuts the norm below 0.9 of the last), the history
    NaN-padded past the last cycle."""
    res, _ = dist.sharded_solve_pallas3(ranks.dist3_config(), _one_rank(),
                                        tol=1e-3, replicate_below=16)
    h = _np(res.res_history)
    it = res.iterations
    assert res.converged and 1 <= it < 100 and np.isnan(h[it + 1:]).all()
    assert h[it] <= 1e-3 * h[0] < h[it - 1]


def test_across_meshes():
    """A gloo (2, 2) mesh at level 6: the 3D refresh / gather / scatter
    against JAX's under ``shard_map`` on four devices; the Poisson and var
    solves (Chebyshev (3, 2), two cycles) against the JAX single-device
    solve (1e-4 of max|u|, the JAX package's own 1-vs-N bound) and against
    the port's (1, 1) run (histories rtol 1e-4, iterates 1e-4 of max|u|);
    the lean halo bitwise equal to the full one."""
    lz, ly, Sx, n = 32, 48, 128, 60
    glob = ranks.seeded_blocks3((2, 2), 9, lz, ly, Sx)
    want = _jax_refresh3((2, 2), glob, n, lz, ly)
    out = dist.run_on_mesh(ranks.dist3_program, (2, 2), backend="gloo",
                           device="cpu", args=((9, n, lz, ly, Sx),))
    _check_refresh3([o["refresh"] for o in out], want, lz, ly)

    cfg = ranks.dist3_config()
    kw = dict(num_cycles=ranks.DIST3_CYCLES, tol=0.0, replicate_below=16)
    n0 = 2 ** ranks.DIST3_LEVEL
    phys = (slice(1, n0), slice(1, n0), slice(1, n0))
    jcfg = _jax_cfg()
    for name, solver, extra, jprob in (
            ("poisson", dist.sharded_solve_pallas3, {},
             Poisson3DProblem(jcfg, align=16, min_pad_level=0,
                              lane_align=128)),
            ("var", dist.sharded_solve_pallas_var3,
             dict(coefficient=ranks.dist3_coefficient),
             Diffusion3DProblem(jcfg, coefficient=ranks.dist3_coefficient,
                                align=16, min_pad_level=0, lane_align=128))):
        hist, u, lv = out[0][(name, "lean")]
        assert lv.num_sharded >= 2 and tuple(u.shape[1:]) == (
            lv.sizes[0][1], lv.sizes[0][2])
        for o in out:
            for halo in ("lean", "full"):
                assert torch.equal(o[(name, halo)][0], hist)
                assert torch.equal(o[(name, halo)][1], u)
        jref = jax_solve_fixed(jprob.hierarchy, jcfg, jprob.rhs(),
                               num_cycles=ranks.DIST3_CYCLES)
        w = np.asarray(jref.u)[phys]
        _close(_np(u)[phys], w, 1e-4)
        one, _ = solver(cfg, _one_rank(), **kw, **extra)
        np.testing.assert_allclose(_np(hist), _np(one.res_history),
                                   rtol=1e-4)
        _close(_np(u)[phys], _np(one.u)[phys], 1e-4)


# ---------------------------------------------------------------------------
# Refusals and dispatch
# ---------------------------------------------------------------------------

def test_no_sharded_level_raises():
    cfg = ranks.dist3_config()
    for solver, extra in ((dist.sharded_solve_pallas3, {}),
                          (dist.sharded_solve_pallas_var3,
                           dict(coefficient=1.0))):
        with pytest.raises(ValueError, match="no level satisfies"):
            solver(cfg, _one_rank(), num_cycles=1, replicate_below=512,
                   **extra)
    with pytest.raises(NotImplementedError):
        tmg.solve_poisson3d(5, mesh=_one_rank(), device="cpu")


@pytest.mark.parametrize("cycle", ["V", "W"])
def test_dispatch_counts(monkeypatch, cycle):
    """Each level visit of a sharded level calls K1_3-ext once and
    K2_3-local once, the finest K2 with the resnorm, and the var solver
    their var forms (counted with spies on the CPU, where the wrappers run
    their plain versions)."""
    calls = {}

    def spy(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **kw):
            key = name + ("_resnorm" if kw.get("want_resnorm") else "")
            calls[key] = calls.get(key, 0) + 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapped)

    for mod, names in ((KT3, ("smooth_restrict_ext3", "prolong_smooth_ext3")),
                       (KV3, ("var_smooth_restrict_ext3",
                              "var_prolong_smooth_ext3"))):
        for name in names:
            spy(mod, name)
    import dataclasses
    cfg = dataclasses.replace(ranks.dist3_config(), cycle=cycle)
    # V: one visit of each of the two sharded levels a cycle; W: the
    # coarser sharded level twice.
    visits = 2 if cycle == "V" else 3
    for pre, solver, extra in (("", dist.sharded_solve_pallas3, {}),
                               ("var_", dist.sharded_solve_pallas_var3,
                                dict(coefficient=2.0))):
        calls.clear()
        solver(cfg, _one_rank(), num_cycles=2, tol=0.0, replicate_below=16,
               **extra)
        assert calls == {pre + "smooth_restrict_ext3": 2 * visits,
                         pre + "prolong_smooth_ext3": 2 * (visits - 1),
                         pre + "prolong_smooth_ext3_resnorm": 2}
    assert not any(kernels.launch_counts().values())
