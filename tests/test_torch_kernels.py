"""The port's kernel modules on the CPU: each wrapper's plain torch version
against the JAX Pallas kernel it replaces, run in interpret mode as
tests/test_kernels.py runs it.

Tolerances: K1/K2, the streaming smoother, the standalone restriction and
prolong-add rtol/atol 1e-5 and resnorm rtol 1e-4, as the JAX package holds
its own Pallas kernels against its jnp ops (the Pallas kernels evaluate the
prolongation and restriction in another order).  The compensated residuals
and the exact-pair prolongation are exact IEEE arithmetic in the same order
on both sides, so they must agree bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpu_multigrid import precision as jprecision
from tpu_multigrid.core import ops as jops
from tpu_multigrid.kernels import compres as JC
from tpu_multigrid.kernels import stencil as JS
from tpu_multigrid.kernels import transfer as JT

from tpu_multigrid_torch import kernels, precision
from tpu_multigrid_torch.core import ops
from tpu_multigrid_torch.kernels import _build
from tpu_multigrid_torch.kernels import compres as TC
from tpu_multigrid_torch.kernels import stencil as TS
from tpu_multigrid_torch.kernels import transfer as TT

# One torch thread per test worker (see tests/test_torch_ops.py).
torch.set_num_threads(1)


def _grids(S, n, Sc, seed=0):
    rng = np.random.default_rng(seed)
    u = np.zeros((S, S), np.float32)
    b = np.zeros((S, S), np.float32)
    u[1:n, 1:n] = rng.standard_normal((n - 1, n - 1))
    b[1:n, 1:n] = rng.standard_normal((n - 1, n - 1))
    nc = n // 2
    e = np.zeros((Sc, Sc), np.float32)
    e[1:nc, 1:nc] = rng.standard_normal((nc - 1, nc - 1))
    return u, b, e


# (S, Sc, n): a mid hierarchy pair, and the bottom pair (S = Sc = 256).
PAIRS = [(768, 512, 512), (256, 256, 64)]
# The main path's smoothers: Chebyshev (3, 2) and RB-GS with 2 sweeps.
SMOOTHERS = [("chebyshev", 3, 2), ("rbgs", 2, 2)]


def _smoother(name, sweeps):
    if name == "chebyshev":
        return "jacobi", ops.chebyshev_omegas(sweeps, 0.4)
    return "rbgs", 2.0 / 3.0


@pytest.mark.parametrize("S,Sc,n", PAIRS)
@pytest.mark.parametrize("name,nu1,nu2", SMOOTHERS)
def test_k1_plain_matches_pallas(S, Sc, n, name, nu1, nu2):
    u, b, _ = _grids(S, n, Sc)
    sm, om = _smoother(name, nu1)
    with pltpu.force_tpu_interpret_mode():
        ju, jrc = JT.smooth_restrict(jnp.asarray(u), jnp.asarray(b), n, Sc,
                                     nu1, smoother=sm, omega=om)
    tu, trc = TT.smooth_restrict(torch.tensor(u), torch.tensor(b), n, Sc,
                                 nu1, sm, om)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(trc.numpy(), np.asarray(jrc), rtol=1e-5,
                               atol=1e-5)
    assert not trc.numpy()[S // 2:].any() and not trc.numpy()[:, S // 2:].any()


@pytest.mark.parametrize("S,Sc,n", PAIRS)
@pytest.mark.parametrize("name,nu1,nu2", SMOOTHERS)
def test_k2_plain_matches_pallas(S, Sc, n, name, nu1, nu2):
    u, b, e = _grids(S, n, Sc, seed=1)
    sm, om = _smoother(name, nu2)
    with pltpu.force_tpu_interpret_mode():
        ju, jnorm = JT.prolong_smooth_resnorm(
            jnp.asarray(u), jnp.asarray(b), jnp.asarray(e), n, nu2,
            smoother=sm, omega=om)
    args = (torch.tensor(u), torch.tensor(b), torch.tensor(e), n, nu2, sm, om)
    tu = TT.prolong_smooth(*args)
    tu2, tnorm = TT.prolong_smooth_resnorm(*args)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(tu2.numpy(), tu.numpy())
    assert tnorm.dtype == torch.float32 and tnorm.shape == ()
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-4)


def _components(S, n, k, seed):
    """b and a k-component iterate with realistic magnitudes: u_hi O(1),
    each further component ~eps times the one before."""
    rng = np.random.default_rng(seed)
    out = []
    for scale in [1.0 / n ** 2, 1.0, 1e-7, 1e-14][:k + 1]:
        a = np.zeros((S, S), np.float32)
        a[1:n, 1:n] = scale * rng.standard_normal((n - 1, n - 1))
        out.append(a)
    return out


@pytest.mark.parametrize("kind", ["ds", "ts"])
@pytest.mark.parametrize("S,n", [(256, 250), (640, 512)])
def test_comp_residual_plain_matches_jax_bitwise(kind, S, n):
    arrays = _components(S, n, 2 if kind == "ds" else 3, seed=2)
    if kind == "ds":
        want = jprecision.ds_residual(*map(jnp.asarray, arrays), n)
        got = precision.ds_residual(*map(torch.tensor, arrays), n)
    else:
        want = jprecision.ts_residual(*map(jnp.asarray, arrays), n)
        got = precision.ts_residual(*map(torch.tensor, arrays), n)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["ds", "ts"])
def test_comp_residual_plain_matches_pallas_bitwise(kind):
    S, n = 256, 250
    arrays = _components(S, n, 2 if kind == "ds" else 3, seed=3)
    with pltpu.force_tpu_interpret_mode():
        if kind == "ds":
            want = JC.ds_residual_pallas(*map(jnp.asarray, arrays), n)
        else:
            want = JC.ts_residual_pallas(*map(jnp.asarray, arrays), n)
    wrapper = TC.ds_residual if kind == "ds" else TC.ts_residual
    got = wrapper(*map(torch.tensor, arrays), n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cpu_wrappers_run_plain_and_launch_nothing():
    kernels.reset_launch_counts()
    S, Sc, n = 256, 256, 128
    u, b, e = map(torch.tensor, _grids(S, n, Sc, seed=4))
    om = ops.chebyshev_omegas(3, 0.4)
    got = TT.smooth_restrict(u, b, n, Sc, 3, "jacobi", om)
    want = TT.smooth_restrict_plain(u, b, n, Sc, 3, "jacobi", om)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(TT.prolong_smooth(u, b, e, n, 2, "rbgs"),
                       TT.prolong_smooth_plain(u, b, e, n, 2, "rbgs"))
    ds = _components(S, n, 2, seed=5)
    assert torch.equal(TC.ds_residual(*map(torch.tensor, ds), n),
                       precision.ds_residual(*map(torch.tensor, ds), n))
    ts = [torch.tensor(a) for a in _components(S, n, 3, seed=6)]
    assert torch.equal(precision._ts_residual_d(*ts, n, True),
                       precision.ts_residual(*ts, n))
    assert set(kernels.launch_counts().values()) == {0}


@pytest.mark.parametrize("Sf,Sc", [(256, 256), (512, 256), (512, 384),
                                   (768, 512), (640, 512), (768, 256),
                                   (128, 128), (8448, 4352), (16640, 8448)])
@pytest.mark.parametrize("steps", [0, 4, 14, 15, 31])
def test_transfer_gate_matches_jax(Sf, Sc, steps):
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16),
                     (jnp.float64, torch.float64)):
        assert TT.supported(Sf, Sc, steps, tdt) == JT.supported(
            Sf, Sc, steps, jdt), (Sf, Sc, steps, tdt)


@pytest.mark.parametrize("S", [128, 256, 384, 640, 8448])
def test_compres_gate_matches_jax(S):
    assert TC.supported(S, torch.float32) == JC.supported(S, jnp.float32)
    assert TC.supported(S, torch.float64) == JC.supported(S, jnp.float64)


@pytest.mark.parametrize("option", ["smooth_dtype", "stencil", "float64"])
def test_unported_kernel_options_raise(option):
    u, b, e = map(torch.tensor, _grids(256, 128, 256))
    kw = {}
    if option == "smooth_dtype":
        kw["smooth_dtype"] = torch.bfloat16
    elif option == "stencil":
        kw["stencil"] = ((0.0, -1.0, 0.0), (-1.0, 4.0, -1.0), (0.0, -1.0, 0.0))
    else:
        u, b, e = u.double(), b.double(), e.double()
    with pytest.raises(NotImplementedError):
        TT.smooth_restrict(u, b, 128, 256, 2, **kw)
    with pytest.raises(NotImplementedError):
        TT.prolong_smooth_resnorm(u, b, e, 128, 2, **kw)


def test_build_is_keyed_by_the_sources():
    names = [p.name for p in _build.sources()]
    assert names == ["compres.cu", "stencil.cu", "stencil3d.cu",
                     "transfer.cu", "transfer3d.cu", "varstencil.cu",
                     "vartransfer.cu", "vartransfer3d.cu", "levelvisit.cuh",
                     "levelvisit3.cuh", "twosum.cuh", "varwindow.cuh",
                     "window.cuh", "window3.cuh"]
    d = _build.build_dir()
    assert d.parent.name == "build" and d.name.startswith("kernels-")
    assert _build.build_dir() == d
    assert "-fmad=false" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert not any("fast_math" in f for f in _build.NVCC_FLAGS)


# ---------------------------------------------------------------------------
# The streaming smoother
# ---------------------------------------------------------------------------

# (label, smoother, omega, sweeps): plain Jacobi, the main path's Chebyshev
# pre-smoothing, RB-GS.
STENCIL_SMOOTHERS = [("jacobi", "jacobi", 2.0 / 3.0, 2),
                     ("chebyshev", "jacobi", ops.chebyshev_omegas(3, 0.4), 3),
                     ("rbgs", "rbgs", None, 2)]


def _stencil_pair(sm, om, sweeps, fused, u, b, n):
    """(JAX Pallas result in interpret mode, the port's CPU wrapper result),
    each u' or (u', r)."""
    ju, jb = jnp.asarray(u), jnp.asarray(b)
    tu, tb = torch.tensor(u), torch.tensor(b)
    with pltpu.force_tpu_interpret_mode():
        if sm == "rbgs":
            fn = JS.rbgs_sweeps_residual if fused else JS.rbgs_sweeps
            want = fn(ju, jb, n, sweeps)
        else:
            fn = JS.jacobi_sweeps_residual if fused else JS.jacobi_sweeps
            want = fn(ju, jb, n, om, sweeps)
    if sm == "rbgs":
        fn = TS.rbgs_sweeps_residual if fused else TS.rbgs_sweeps
        got = fn(tu, tb, n, sweeps)
    else:
        fn = TS.jacobi_sweeps_residual if fused else TS.jacobi_sweeps
        got = fn(tu, tb, n, om, sweeps)
    return want, got


@pytest.mark.parametrize("S,n", [(256, 250), (1280, 1024)])
@pytest.mark.parametrize("label,sm,om,sweeps", STENCIL_SMOOTHERS)
@pytest.mark.parametrize("fused", [False, True])
def test_stencil_plain_matches_pallas(S, n, label, sm, om, sweeps, fused):
    u, b, _ = _grids(S, n, S, seed=8)
    want, got = _stencil_pair(sm, om, sweeps, fused, u, b, n)
    if not fused:
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (S, S)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("S,n", [(256, 250), (1280, 1024)])
def test_stencil_residual_plain_matches_pallas(S, n):
    u, b, _ = _grids(S, n, S, seed=9)
    with pltpu.force_tpu_interpret_mode():
        want = JS.residual(jnp.asarray(u), jnp.asarray(b), n)
    got = TS.residual(torch.tensor(u), torch.tensor(b), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("S", [128, 256, 384, 1280, 8448, 16640])
@pytest.mark.parametrize("steps", [0, 1, 4, 21, 120, 128, 129])
def test_stencil_gate_matches_jax(S, steps):
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16),
                     (jnp.float64, torch.float64)):
        assert TS.supported(S, tdt, steps) == JS.supported(S, jdt, steps), \
            (S, steps, tdt)


@pytest.mark.parametrize("ws,steps", [
    ((2.0 / 3.0,), 20), (ops.chebyshev_omegas(10, 0.4), 10),
    (ops.chebyshev_omegas(20, 0.4), 20), (ops.chebyshev_omegas(3, 0.4), 37),
    ((1.0,), 0)])
def test_launch_plan_composes_the_sweeps(ws, steps):
    """Deep smoothing split into launches of at most 16 steps, each with its
    weights rotated to its first step, composes to the unsplit sweeps
    bitwise (RB-GS: the split keeps its half-steps' colours, since each
    launch passes the global index of its first step)."""
    plan = TS.launch_plan(steps, 16, ws)
    assert [k for _, k, _ in plan] == ([16] * (steps // 16)
                                        + ([steps % 16] if steps % 16 else [])
                                        or [0])
    assert [f for f, _, _ in plan] == list(range(0, max(steps, 1), 16))
    assert all(1 <= len(w) <= 16 for _, _, w in plan)
    S, n = 256, 120
    u, b = (torch.tensor(a) for a in _grids(S, n, S, seed=10)[:2])
    v = u
    for _, k, launch_ws in plan:
        v = ops.jacobi_sweeps(v, b, n, launch_ws, k)
    assert torch.equal(v, ops.jacobi_sweeps(u, b, n, ws, steps))
    # RB-GS: whole sweeps per launch of an even step count.
    half = [k for _, k, _ in TS.launch_plan(2 * 10, 16, (1.0,))]
    v = u
    for k in half:
        assert k % 2 == 0
        v = ops.redblack_gs_sweeps(v, b, n, k // 2)
    assert torch.equal(v, ops.redblack_gs_sweeps(u, b, n, 10))


# ---------------------------------------------------------------------------
# The standalone transfers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,Sc,n", PAIRS)
def test_restrict_plain_matches_pallas(S, Sc, n):
    _, r, _ = _grids(S, n, Sc, seed=11)
    with pltpu.force_tpu_interpret_mode():
        want = JT.restrict_fw_pallas(jnp.asarray(r), n, Sc)
    got = TT.restrict_fw(torch.tensor(r), n, Sc)
    assert got.shape == (Sc, Sc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert not got.numpy()[S // 2:].any() and not got.numpy()[:, S // 2:].any()
    assert torch.equal(got, ops.restrict_fw(torch.tensor(r), n, Sc))


@pytest.mark.parametrize("S,Sc,n", PAIRS)
def test_prolong_add_plain_matches_pallas(S, Sc, n):
    u, _, e = _grids(S, n, Sc, seed=12)
    with pltpu.force_tpu_interpret_mode():
        want = JT.prolong_add_pallas(jnp.asarray(u), jnp.asarray(e), n)
    got = TT.prolong_add(torch.tensor(u), torch.tensor(e), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _coarse(Sc, nc, seed):
    rng = np.random.default_rng(seed)
    e = np.zeros((Sc, Sc), np.float32)
    e[1:nc, 1:nc] = rng.standard_normal((nc - 1, nc - 1))
    return e


@pytest.mark.parametrize("S,Sc,n", [(512, 384, 500), (768, 384, 512)])
def test_prolong_comp_plain_matches_pallas_bitwise(S, Sc, n):
    """The kernel's plain version sums in the Pallas kernel's order: hi and
    err equal the Pallas output bitwise, and hi + err is exact in f64."""
    e = _coarse(Sc, n // 2, seed=7)
    with pltpu.force_tpu_interpret_mode():
        jhi, jerr = JT.prolong_comp_pallas(jnp.asarray(e), n, S)
    hi, err = TT.prolong_comp(torch.tensor(e), n, S)
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(err.numpy(), np.asarray(jerr))
    want = np.asarray(jops.prolong(jnp.asarray(e, jnp.float64), n // 2, S))
    got = hi.numpy().astype(np.float64) + err.numpy().astype(np.float64)
    assert np.abs(got - want).max() == 0.0


@pytest.mark.parametrize("nc,Sc,Sf", [(32, 33, 65), (250, 384, 512)])
def test_prolong_comp_jnp_order_matches_jax_bitwise(nc, Sc, Sf):
    """precision.prolong_comp keeps the JAX jnp route's order: bitwise equal
    to it, exact in f64, and a different split from the kernel's order."""
    e = _coarse(Sc, nc, seed=13)
    jhi, jerr = jprecision.prolong_comp(jnp.asarray(e), nc, Sf)
    hi, err = precision.prolong_comp(torch.tensor(e), nc, Sf)
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(err.numpy(), np.asarray(jerr))
    want = np.asarray(jops.prolong(jnp.asarray(e, jnp.float64), nc, Sf))
    got = hi.numpy().astype(np.float64) + err.numpy().astype(np.float64)
    assert np.abs(got - want).max() == 0.0
    khi, kerr = TT.prolong_comp_plain(torch.tensor(e), 2 * nc, Sf)
    kgot = khi.numpy().astype(np.float64) + kerr.numpy().astype(np.float64)
    assert np.abs(kgot - want).max() == 0.0


def test_new_cpu_wrappers_run_plain_and_launch_nothing():
    kernels.reset_launch_counts()
    S, Sc, n = 256, 256, 128
    u, b, e = map(torch.tensor, _grids(S, n, Sc, seed=14))
    om = ops.chebyshev_omegas(3, 0.4)
    assert torch.equal(TS.jacobi_sweeps(u, b, n, om, 3),
                       ops.jacobi_sweeps(u, b, n, om, 3))
    for g, w in zip(TS.rbgs_sweeps_residual(u, b, n, 2),
                    TS.rbgs_sweeps_residual_plain(u, b, n, 2)):
        assert torch.equal(g, w)
    assert torch.equal(TS.residual(u, b, n), ops.residual(u, b, n))
    assert TS.jacobi_sweeps(u, b, n, om, 0) is u
    assert torch.equal(TT.restrict_fw(b, n, Sc), ops.restrict_fw(b, n, Sc))
    assert torch.equal(TT.prolong_add(u, e, n),
                       ops.mask_interior(u + ops.prolong(e, n // 2, S), n))
    for g, w in zip(TT.prolong_comp(e, n, S), TT.prolong_comp_plain(e, n, S)):
        assert torch.equal(g, w)
    assert set(kernels.launch_counts().values()) == {0}
    assert {"jacobi_sweeps", "jacobi_sweeps_residual", "rbgs_sweeps",
            "rbgs_sweeps_residual", "residual", "restrict_fw", "prolong_add",
            "prolong_comp"} <= set(kernels.launch_counts())


def test_new_kernel_options_raise():
    u, b, e = map(torch.tensor, _grids(256, 128, 256))
    with pytest.raises(NotImplementedError):
        TT.restrict_fw(b, 128, 256, cbox=(1, 63, 1, 63))
    with pytest.raises(NotImplementedError):
        TT.prolong_add(u, e, 128, box=(0, 127, 1, 127))
    for fn, args in ((TS.jacobi_sweeps, (2.0 / 3.0, 2)),
                     (TS.rbgs_sweeps_residual, (2,)), (TS.residual, ())):
        with pytest.raises(NotImplementedError):
            fn(u.double(), b.double(), 128, *args)
    with pytest.raises(NotImplementedError):
        TT.prolong_comp(e.to(torch.bfloat16), 128, 256)
