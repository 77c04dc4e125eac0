"""tpu_multigrid_torch core against tpu_multigrid.core, on the CPU.

Same numpy inputs through the JAX function and its torch counterpart:
float64 ops agree to rtol 1e-12 (both evaluate the same terms in the same
order; the bound leaves room for a different summation order in norm2).
"""

import ast
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_multigrid as jmg
from tpu_multigrid.core import grids as jgrids
from tpu_multigrid.core import ops as jops
from tpu_multigrid.problems import poisson as jpoisson

import tpu_multigrid_torch as tmg
from tpu_multigrid_torch.core import grids, ops
from tpu_multigrid_torch.problems import poisson

# The suite runs in several worker processes beside JAX's own thread pools;
# one torch thread each keeps them from contending for the cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-12


def _interior_random(S, n, seed):
    rng = np.random.default_rng(seed)
    a = np.zeros((S, S))
    a[1:n, 1:n] = rng.standard_normal((n - 1, n - 1))
    return a


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=0.0)


# (S, n): unpadded, padded, and 256-aligned kernel-path layouts.
CASES = [(33, 32), (40, 32), (256, 128)]


@pytest.mark.parametrize("S,n", CASES)
def test_interior_mask_matches(S, n):
    np.testing.assert_array_equal(ops.interior_mask(S, n).numpy(),
                                  np.asarray(jops.interior_mask(S, n)))


@pytest.mark.parametrize("name", ["neighbor_sum", "apply_poisson",
                                  "residual", "mask_interior"])
@pytest.mark.parametrize("S,n", CASES)
def test_stencil_ops_f64(name, S, n):
    u = _interior_random(S, n, 0)
    b = _interior_random(S, n, 1)
    tu, tb = torch.tensor(u), torch.tensor(b)
    ju, jb = jnp.asarray(u), jnp.asarray(b)
    if name == "neighbor_sum":
        got, want = ops.neighbor_sum(tu), jops.neighbor_sum(ju)
    elif name == "apply_poisson":
        got, want = ops.apply_poisson(tu, n), jops.apply_poisson(ju, n)
    elif name == "residual":
        got, want = ops.residual(tu, tb, n), jops.residual(ju, jb, n)
    else:
        got, want = (ops.mask_interior(tu + 1.0, n),
                     jops.mask_interior(ju + 1.0, n))
    _close(got, want)


@pytest.mark.parametrize("omega", [2.0 / 3.0, "chebyshev"])
@pytest.mark.parametrize("sweeps", [1, 3])
def test_jacobi_sweeps_f64(omega, sweeps):
    S, n = 40, 32
    if omega == "chebyshev":
        omega = ops.chebyshev_omegas(sweeps, 0.4)
    u, b = _interior_random(S, n, 2), _interior_random(S, n, 3)
    got = ops.jacobi_sweeps(torch.tensor(u), torch.tensor(b), n, omega,
                            sweeps)
    want = jops.jacobi_sweeps(jnp.asarray(u), jnp.asarray(b), n, omega,
                              sweeps)
    _close(got, want)


@pytest.mark.parametrize("sweeps", [1, 2])
def test_redblack_gs_sweeps_f64(sweeps):
    S, n = 40, 32
    u, b = _interior_random(S, n, 4), _interior_random(S, n, 5)
    got = ops.redblack_gs_sweeps(torch.tensor(u), torch.tensor(b), n, sweeps)
    want = jops.redblack_gs_sweeps(jnp.asarray(u), jnp.asarray(b), n, sweeps)
    _close(got, want)


# (Sf, nf, Sc): unpadded pairs, a padded fine grid, 256-aligned pairs.
TRANSFER_CASES = [(33, 32, 17), (40, 32, 17), (256, 128, 256),
                  (768, 512, 512)]


@pytest.mark.parametrize("Sf,nf,Sc", TRANSFER_CASES)
def test_restrict_fw_f64(Sf, nf, Sc):
    r = _interior_random(Sf, nf, 6)
    _close(ops.restrict_fw(torch.tensor(r), nf, Sc),
           jops.restrict_fw(jnp.asarray(r), nf, Sc))


@pytest.mark.parametrize("Sf,nf,Sc", TRANSFER_CASES)
def test_prolong_f64(Sf, nf, Sc):
    e = _interior_random(Sc, nf // 2, 7)
    _close(ops.prolong(torch.tensor(e), nf // 2, Sf),
           jops.prolong(jnp.asarray(e), nf // 2, Sf))


@pytest.mark.parametrize("Sf,nf,Sc", TRANSFER_CASES)
def test_restriction_is_prolongation_adjoint(Sf, nf, Sc):
    """<R r, e> == <r, P e>: R = P^T in FEM scaling."""
    r = torch.tensor(_interior_random(Sf, nf, 8))
    e = torch.tensor(_interior_random(Sc, nf // 2, 9))
    lhs = float(torch.sum(ops.restrict_fw(r, nf, Sc) * e))
    rhs = float(torch.sum(r * ops.prolong(e, nf // 2, Sf)))
    assert lhs == pytest.approx(rhs, rel=RTOL)


def test_norm2_f64_and_f32():
    r = _interior_random(40, 32, 10)
    _close(ops.norm2(torch.tensor(r)), jops.norm2(jnp.asarray(r)))
    r32 = r.astype(np.float32)
    got = ops.norm2(torch.tensor(r32))
    assert got.dtype == torch.float32
    _close(got, jops.norm2(jnp.asarray(r32)), rtol=1e-6)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_chebyshev_omegas_exact(k):
    assert ops.chebyshev_omegas(k, 0.4) == jops.chebyshev_omegas(k, 0.4)


@pytest.mark.parametrize("kw", [{}, {"align": 256, "min_pad_level": 0},
                                {"align": 256, "min_pad_level": 8}])
def test_level_sizes_equal(kw):
    cfg_j = jmg.MultigridConfig(finest_level=10, coarsest_level=3)
    cfg_t = tmg.MultigridConfig(finest_level=10, coarsest_level=3)
    assert grids.level_sizes(cfg_t, **kw) == jgrids.level_sizes(cfg_j, **kw)


@pytest.mark.parametrize("n", [4, 8, 16])
def test_coarse_dense_inverse_f64(n):
    got = grids.coarse_dense_inverse(grids.poisson_op(n, n + 1),
                                     dtype=torch.float64)
    from tpu_multigrid.core.operators import poisson_op as jpoisson_op
    want = jgrids.coarse_dense_inverse(jpoisson_op(n, n + 1),
                                       dtype=jnp.float64)
    _close(got, want)
    # Default storage dtype is float32, as in the JAX package.
    assert grids.coarse_dense_inverse(grids.poisson_op(n, n + 1)).dtype \
        == torch.float32


def test_coarse_solve_f64():
    from tpu_multigrid.core.operators import poisson_op as jpoisson_op
    n, S = 8, 16
    b = _interior_random(S, n, 11)
    inv = np.linalg.inv(grids.dense_poisson_matrix(n))
    got = grids.coarse_solve(grids.poisson_op(n, S), torch.tensor(inv),
                             torch.tensor(b))
    want = jgrids.coarse_solve(jpoisson_op(n, S), jnp.asarray(inv),
                               jnp.asarray(b))
    _close(got, want)


@pytest.mark.parametrize("forcing", [4.0, "callable"])
def test_poisson_rhs_and_boundary_grid_f64(forcing):
    n, S = 32, 40
    tf = (lambda x, y: 1.0 + x * y) if forcing == "callable" else forcing
    got = poisson.poisson_rhs(n, S, tf, torch.float64)
    want = jpoisson.poisson_rhs(n, S, tf, jnp.float64)
    _close(got, want)
    _close(poisson.boundary_grid(n, S, tf, torch.float64),
           jpoisson.boundary_grid(n, S, tf, jnp.float64))


@pytest.mark.parametrize("field,value", [
    ("coarsest_level", 0), ("finest_level", 1), ("smoother", "sor"),
    ("cheb_lo", 2.0), ("cycle", "X"), ("coarse_solver", "lu"),
    ("fmg_rhs", "x"), ("restriction", "x"), ("prolongation", "x")])
def test_config_validation_matches(field, value):
    kw = {"finest_level": 4, "coarsest_level": 2, field: value}
    with pytest.raises(ValueError) as jerr:
        jmg.MultigridConfig(**kw)
    with pytest.raises(ValueError) as terr:
        tmg.MultigridConfig(**kw)
    assert str(terr.value) == str(jerr.value)


def test_reference_config_fields_match():
    import dataclasses
    j = dataclasses.asdict(jmg.REFERENCE_CONFIG)
    t = dataclasses.asdict(tmg.REFERENCE_CONFIG)
    for key in ("dtype", "smooth_dtype", "use_pallas", "use_kernels"):
        j.pop(key, None)
        t.pop(key, None)
    assert t == j


def _python(code, cwd=REPO):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_import_leaves_jax_out():
    proc = _python("import sys, tpu_multigrid_torch, "
                   "tpu_multigrid_torch.kernels, tpu_multigrid_torch.interop, "
                   "tpu_multigrid_torch.precision; "
                   "bad = sorted(m for m in sys.modules if m.split('.')[0] "
                   "in ('jax', 'jaxlib', 'tpu_multigrid')); "
                   "print(bad); sys.exit(1 if bad else 0)")
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_roots(path):
    tree = ast.parse(path.read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_sources_import_no_jax():
    files = sorted((REPO / "tpu_multigrid_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "profile_vcycle.py"]
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib", "tpu_multigrid"}
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_chip_smoke_fails_without_a_card_and_imports_no_jax():
    """Here there is no card: the script must exit non-zero and print no
    result, without importing JAX on the way."""
    proc = _python("import sys, runpy; "
                   "sys.modules['jax'] = None; "
                   "sys.modules['tpu_multigrid'] = None; "
                   "sys.argv = ['chip_smoke.py']; "
                   "runpy.run_path('chip_smoke.py', run_name='__main__')")
    assert proc.returncode != 0
    assert "ImportError" not in proc.stderr, proc.stderr
    assert '"ok"' not in proc.stdout


def test_profile_vcycle_helpers_and_no_card():
    """The V-cycle profiler's interval union and kernel-name shortening;
    without a card it exits non-zero and prints nothing."""
    spec = importlib.util.spec_from_file_location(
        "profile_vcycle", REPO / "profile_vcycle.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.busy_us([(5.0, 6.0), (0.0, 2.0), (1.0, 3.0), (1.5, 2.5)]) \
        == 4.0
    assert mod.busy_us([]) == 0.0
    assert mod.short_name(
        "void (anonymous namespace)::smooth_restrict_kernel(float const*, "
        "int)") == "smooth_restrict_kernel"
    if not torch.cuda.is_available():
        assert mod.main([]) == 2


def test_chip_smoke_fails_alone(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
