"""The port's kernel modules on the CPU: each wrapper's plain torch version
against the JAX Pallas kernel it replaces, run in interpret mode as
tests/test_kernels.py runs it.

Tolerances: K1/K2 rtol/atol 1e-5 and resnorm rtol 1e-4, as the JAX package
holds its own Pallas kernels against its jnp ops (the Pallas kernels
evaluate the prolongation and restriction in another order).  The
compensated residuals are exact IEEE arithmetic in the same order on both
sides, so they must agree bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpu_multigrid import precision as jprecision
from tpu_multigrid.kernels import compres as JC
from tpu_multigrid.kernels import transfer as JT

from tpu_multigrid_torch import kernels, precision
from tpu_multigrid_torch.core import ops
from tpu_multigrid_torch.kernels import _build
from tpu_multigrid_torch.kernels import compres as TC
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
    assert names == ["compres.cu", "transfer.cu"]
    d = _build.build_dir()
    assert d.parent.name == "build" and d.name.startswith("kernels-")
    assert _build.build_dir() == d
    assert "-fmad=false" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert not any("fast_math" in f for f in _build.NVCC_FLAGS)
