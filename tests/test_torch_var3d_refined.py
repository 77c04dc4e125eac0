"""Double-single refinement of the 3D flux stencil (``VarStencilOp3D``) on
the CPU, held against the benchmark's plain reference
(``h100bench/references/diffusion3d.py``, plain torch written from the
configuration alone), and the refinement drivers' refusals.

* The reference's transmissibility planes equal the port's bitwise on every
  level, for HPGMG-FV's beta and for a seeded lognormal cell field.
* ``precision.ds_residual_var3`` equals the reference's float64 residual of
  u_hi + u_lo rounded to float32, bitwise: both evaluate the same float64
  expression in the same order (the flux form, faces x+, x-, y+, y-, z+,
  z-), and the one rounding is the last, to float32.
* ``solve_diffusion3d(5, refined=True, tol=1e-8)`` reaches 1e-8 under the
  reference's float64 operator, in the reference's float64 iterations
  within one (the program's cycle smooths with the float32 diagonal and
  the float32 probed coarse inverse, the reference's in float64; the stop
  is decided on float32 norms there and float64 ones here).  The float32
  control stalls above 1e-6; so does the route the port took before,
  the constant residual on the var hierarchy.
* Each refinement entry refuses an operator it has no compensated residual
  for, and the Poisson refined paths keep their bits and iterations.
* The small 3D interior masks are shared, which keeps the var cycle's
  coarse levels from issuing them anew at every visit.
"""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import tpu_multigrid_torch as tmg
from tpu_multigrid_torch import precision
from tpu_multigrid_torch.kernels import compres

# One torch thread per test worker (see tests/test_torch_ops.py).
torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parents[1] / "h100bench"
HPGMG = {"form": "hpgmg_tanh", "b_min": 1, "b_max": 10, "c3": 10,
         "centre": [0.5, 0.5, 0.5], "radius": 0.25}


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF = _load("h100bench_reference_diffusion3d_under_test",
            BENCH / "references" / "diffusion3d.py")
COEF = REF.coefficients
BETA = COEF.callable_of(HPGMG)


def _config(level):
    """The var3d-513 configuration's file at ``level`` (levels 3 down)."""
    return {"ndim": 3, "stencil": "flux7", "coefficient": HPGMG,
            "multigrid": {"finest_level": level, "coarsest_level": 3,
                          "nu1": 3, "nu2": 2, "smoother": "chebyshev",
                          "cheb_lo": 0.4}}


def _cfg(level, use_kernels=True):
    return tmg.MultigridConfig(finest_level=level, smoother="chebyshev",
                               nu1=3, nu2=2, use_kernels=use_kernels)


def _problem(level, coefficient=BETA, **kw):
    return tmg.Diffusion3DProblem(_cfg(level), coefficient=coefficient,
                                  device="cpu", **kw)


def _nodes(x, n):
    return x[:n + 1, :n + 1, :n + 1]


def _lognormal(n):
    g = np.random.default_rng(20261017)
    return np.exp(g.standard_normal((n, n, n)))


@pytest.mark.parametrize("level", [4, 5, 6])
@pytest.mark.parametrize("field", ["hpgmg", "lognormal"])
def test_reference_planes_equal_the_ports_bitwise(field, level):
    n = 2 ** level
    if field == "hpgmg":
        cells, coefficient = COEF.cell_values(BETA, n).numpy(), BETA
    else:
        cells = _lognormal(n)
        coefficient = lambda x, y, z: torch.from_numpy(cells)  # noqa: E731
    prob = _problem(level, coefficient)
    ns = [op.n for op in prob.hierarchy.levels]
    planes = REF.transmissibilities(cells, ns)
    assert len(planes) == prob.hierarchy.num_levels == level - 2
    for op, want in zip(prob.hierarchy.levels, planes):
        for got, t in zip((op.tz, op.ty, op.tx), want):
            assert got.dtype == t.dtype == torch.float32
            assert torch.equal(_nodes(got, op.n), t)


def _pair(shape, seed):
    """Seeded u_hi, and u_lo within half an ulp of it."""
    g = torch.Generator().manual_seed(seed)
    u_hi = torch.randn(shape, generator=g)
    ulp = torch.nextafter(u_hi.abs(), torch.tensor(np.inf)) - u_hi.abs()
    u_lo = ((torch.rand(shape, generator=g) - 0.5) * ulp).float()
    return u_hi, u_lo, 1e-3 * torch.randn(shape, generator=g)


def _ref_residual(op, b, u_hi, u_lo, level):
    ref = REF.Reference(_config(level), torch.float64, "cpu")
    n = op.n
    u = _nodes(u_hi, n).double() + _nodes(u_lo, n).double()
    want = torch.zeros_like(b)
    want[:n + 1, :n + 1, :n + 1] = ref.residual(u, _nodes(b, n).double())
    return precision.ops3d.mask_interior3(want, n)


@pytest.mark.parametrize("level, slab_planes", [(4, None), (5, None),
                                                (5, 1), (5, 7)])
def test_var_residual_equals_the_reference_bitwise(level, slab_planes,
                                                   monkeypatch):
    """Whole-array and z-slab evaluations (one plane, and a slab that does
    not divide the interior) give the same bits."""
    op = _problem(level).hierarchy.levels[0]
    if slab_planes is not None:
        monkeypatch.setattr(precision, "VAR3_SLAB_NODES",
                            slab_planes * (op.n + 1) ** 2)
    u_hi, u_lo, b = _pair(op.grid_shape, level)
    got = precision.ds_residual_var3(op, b, u_hi, u_lo)
    assert got.dtype == torch.float32
    assert torch.equal(got, _ref_residual(op, b, u_hi, u_lo, level))


def test_var_residual_takes_the_reaction_plane():
    """With ``shift``: c h^2 u_i joins the float64 flux sum."""
    op = _problem(4, shift=lambda x, y, z: 50.0 * (1 + x * y * z)) \
        .hierarchy.levels[0]
    assert op.c2 is not None
    u_hi, u_lo, b = _pair(op.grid_shape, 7)
    got = precision.ds_residual_var3(op, b, u_hi, u_lo)
    plain = _ref_residual(op, b, u_hi, u_lo, 4)
    n, c = op.n, slice(1, op.n)
    u = u_hi.double() + u_lo.double()
    want = plain.double() - op.c2.double() * u
    want = precision.ops3d.mask_interior3(want.float(), n)
    assert not torch.equal(got, plain)
    torch.testing.assert_close(got[c, c, c], want[c, c, c], rtol=0,
                               atol=2e-7 * float(want.abs().max()))


@pytest.mark.parametrize("shift", [None, lambda x, y, z: 50.0 * (1 + x * y)])
def test_var_residual_on_the_cpu_takes_the_plain_body(shift, monkeypatch):
    """On CPU tensors the dispatch and the kernel's wrapper both return the
    plain z-slab body, and neither reaches a launch."""
    kw = {} if shift is None else {"shift": shift}
    op = _problem(4, **kw).hierarchy.levels[0]
    assert (op.c2 is not None) == (shift is not None)
    u_hi, u_lo, b = _pair(op.grid_shape, 4)
    want = precision.ds_residual_var3_plain(op, b, u_hi, u_lo)
    plain = precision.ds_residual_var3_plain
    calls = []
    monkeypatch.setattr(precision, "ds_residual_var3_plain",
                        lambda *a: calls.append(1) or plain(*a))
    monkeypatch.setattr(compres, "_launch",
                        lambda *a: pytest.fail("launched on the CPU"))
    assert torch.equal(precision.ds_residual_var3(op, b, u_hi, u_lo), want)
    assert torch.equal(compres.ds_residual_var3(op, b, u_hi, u_lo), want)
    assert len(calls) == 2
    assert compres.LAUNCHES["ds_residual_var3"] == 0


@pytest.mark.parametrize("dtype, planes, want", [
    (torch.float32, torch.float32, True),
    (torch.float64, torch.float32, False),
    (torch.float32, torch.float64, False),
    (torch.float64, torch.float64, False)])
def test_var_residual_kernel_gate(dtype, planes, want):
    op = _problem(4).hierarchy.levels[0]
    op.tz = op.tz.to(planes)
    assert compres.supported_var3(op, dtype) is want


def _rel_res(ref64, b, parts, n):
    u = sum(_nodes(p, n).double() for p in parts)
    b64 = _nodes(b, n).double()
    r = ref64.residual(u, b64)
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b64))


def test_refined_solve_reaches_1e8_under_the_reference():
    level, n = 5, 32
    res = tmg.solve_diffusion3d(level, coefficient=BETA, refined=True,
                                tol=1e-8, device="cpu")
    assert res.converged
    prob = tmg.Diffusion3DProblem(_cfg(level, False), coefficient=BETA,
                                  device="cpu")
    b = prob.rhs()
    u_hi, u_lo, hist, iters, ok = precision.solve_refined_ds(
        prob.hierarchy, _cfg(level, False), b, tol=1e-8)
    assert ok and iters == res.iterations
    assert torch.equal(u_hi, res.u)
    ref64 = REF.Reference(_config(level), torch.float64, "cpu")
    assert _rel_res(ref64, b, (u_hi, u_lo), n) <= 1e-8
    # The reference's own float64 refinement, counted the same way.
    b64 = _nodes(b, n).double()
    u, it = torch.zeros_like(b64), 0
    r0 = float(torch.linalg.vector_norm(b64))
    while it < 60:
        u = u + ref64.vcycle(torch.zeros_like(b64), ref64.residual(u, b64))
        it += 1
        if float(torch.linalg.vector_norm(ref64.residual(u, b64))) <= (
                1e-8 * r0):
            break
    assert abs(iters - it) <= 1, (iters, it)


def test_kernel_route_and_ds_levels_reach_1e8():
    """``use_kernels=True`` (the plain versions of K1v_3 / K2v_3 here) and
    ``cycle_ds`` with two double-single levels, whose post-smoothing takes
    the var residual on two levels."""
    level, n = 5, 32
    prob = _problem(level)
    b = prob.rhs()
    ref64 = REF.Reference(_config(level), torch.float64, "cpu")
    for ds_levels in (0, 2):
        u_hi, u_lo, _, iters, ok = precision.solve_refined_ds(
            prob.hierarchy, _cfg(level), b, tol=1e-8, ds_levels=ds_levels)
        assert ok and iters <= 15
        assert _rel_res(ref64, b, (u_hi, u_lo), n) <= 1e-8


def test_float32_control_stalls_above_1e6():
    level, n = 5, 32
    b = _problem(level).rhs()
    ref32 = REF.Reference(_config(level), torch.float32, "cpu")
    u = ref32.refine(_nodes(b, n), 1e-8, 60)
    ref64 = REF.Reference(_config(level), torch.float64, "cpu")
    assert _rel_res(ref64, b, (u,), n) > 1e-6


def test_the_constant_residual_route_fails(monkeypatch):
    """The port's route before: the constant Laplacian's compensated
    residual on the var hierarchy corrects toward the Poisson solution."""
    level, n = 5, 32
    prob = _problem(level)
    b = prob.rhs()
    monkeypatch.setattr(precision, "ds_residual_var3",
                        lambda op, b, hi, lo: precision.ds_residual(
                            b, hi, lo, op.n))
    u_hi, u_lo, *_ = precision.solve_refined_ds(prob.hierarchy, _cfg(level),
                                                b, tol=1e-8)
    ref64 = REF.Reference(_config(level), torch.float64, "cpu")
    assert _rel_res(ref64, b, (u_hi, u_lo), n) > 1e-6


# -- refusals ----------------------------------------------------------------

def _refused_problems():
    cfg2 = tmg.MultigridConfig(finest_level=4, coarsest_level=3)
    return {
        "VarStencilOp": tmg.DiffusionProblem(
            cfg2, coefficient=lambda x, y: 1 + x * y, device="cpu"),
        "Const19Op": tmg.Poisson4_3DProblem(_cfg(4, False), device="cpu"),
    }


ENTRIES = {
    "solve_refined_ds": lambda h, c, b: precision.solve_refined_ds(
        h, c, b, tol=1e-8),
    "solve_refined_ts": lambda h, c, b: precision.solve_refined_ts(
        h, c, b, tol=1e-8),
    "solve_refined": lambda h, c, b: precision.solve_refined(
        h, c, b, tol=1e-8),
    "cycle_ds": lambda h, c, b: precision.cycle_ds(h, c, b, ds_levels=1),
    "u0": lambda h, c, b: precision.solve_refined_ds(
        h, c, b, tol=1e-8, u0=torch.zeros_like(b)),
}


@pytest.mark.parametrize("entry", list(ENTRIES))
@pytest.mark.parametrize("kind", ["VarStencilOp", "Const19Op"])
def test_entries_refuse_what_they_cannot_compensate(entry, kind,
                                                    monkeypatch):
    calls = []
    monkeypatch.setattr(precision, "cycle", lambda *a, **k: calls.append(1))
    prob = _refused_problems()[kind]
    cfg = (tmg.MultigridConfig(finest_level=4, coarsest_level=3)
           if kind == "VarStencilOp" else _cfg(4, False))
    assert not precision.compensable(prob.hierarchy.levels[0])
    with pytest.raises(NotImplementedError, match=kind):
        ENTRIES[entry](prob.hierarchy, cfg, prob.rhs())
    assert not calls, "refused only after a cycle"


def test_the_u0_residual_refuses_directly():
    prob = _refused_problems()["VarStencilOp"]
    b = prob.rhs()
    with pytest.raises(NotImplementedError, match="VarStencilOp"):
        precision._comp_residual(b, (b, b), prob.hierarchy.levels[0], False)


def test_ts_refuses_the_var_operator():
    prob = _problem(4)
    assert precision.compensable(prob.hierarchy.levels[0])
    assert not precision.compensable(prob.hierarchy.levels[0], "ts")
    with pytest.raises(NotImplementedError, match="VarStencilOp3D"):
        precision.solve_refined_ts(prob.hierarchy, _cfg(4), prob.rhs())


# -- the Poisson refined paths as before ---------------------------------------

def _ds_residual_before(b, u_hi, u_lo, n, use_kernels):
    """The dispatch as it was before it took the operator (keyed on n)."""
    if use_kernels and b.ndim == 2 and compres.supported(b.shape[-1],
                                                         b.dtype):
        return compres.ds_residual(b, u_hi, u_lo, n)
    if use_kernels and b.ndim == 3 and compres.supported3(b.shape, b.dtype):
        return compres.ds_residual3(b, u_hi, u_lo, n)
    return precision.ds_residual(b, u_hi, u_lo, n)


def _ts_residual_before(b, u_hi, u_mid, u_lo, n, use_kernels):
    if use_kernels and b.ndim == 2 and compres.supported(b.shape[-1],
                                                         b.dtype):
        return compres.ts_residual(b, u_hi, u_mid, u_lo, n)
    if use_kernels and b.ndim == 3 and compres.supported3(b.shape, b.dtype):
        return compres.ts_residual3(b, u_hi, u_mid, u_lo, n)
    return precision.ts_residual(b, u_hi, u_mid, u_lo, n)


# Iterations at level 5 on the tree before the dispatch took the operator
# (Chebyshev (3, 2); ds to 1e-10, ts to 1e-11 with two ds levels).
BEFORE = {(2, "ds"): 10, (2, "ds2"): 10, (2, "ts"): 11,
          (3, "ds"): 12, (3, "ds2"): 12, (3, "ts"): 13}


def _poisson(ndim, use_kernels):
    cfg = tmg.MultigridConfig(finest_level=5, coarsest_level=3, nu1=3,
                              nu2=2, smoother="chebyshev",
                              use_kernels=use_kernels)
    if ndim == 2:
        pad = dict(align=256, min_pad_level=0) if use_kernels else {}
        return tmg.PoissonProblem(cfg, device="cpu", **pad), cfg
    pad = (dict(align=16, min_pad_level=0, lane_align=128) if use_kernels
           else {})
    return tmg.Poisson3DProblem(cfg, device="cpu", **pad), cfg


def _run(path, hier, cfg, b):
    if path == "ts":
        return precision.solve_refined_ts(hier, cfg, b, tol=1e-11,
                                          ds_levels=2)
    return precision.solve_refined_ds(hier, cfg, b, tol=1e-10,
                                      ds_levels=2 if path == "ds2" else 0)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("ndim, path", list(BEFORE))
def test_poisson_refined_paths_keep_their_bits(ndim, path, use_kernels,
                                               monkeypatch):
    prob, cfg = _poisson(ndim, use_kernels)
    b = prob.rhs()
    now = _run(path, prob.hierarchy, cfg, b)
    assert now[-2] == BEFORE[(ndim, path)] and now[-1] is True
    monkeypatch.setattr(precision, "_comp_residual",
                        lambda b, parts, op, uk: (
                            _ds_residual_before if len(parts) == 2
                            else _ts_residual_before)(b, *parts, op.n, uk))
    before = _run(path, prob.hierarchy, cfg, b)
    assert now[-2] == before[-2]
    for x, y in zip(now[:-3], before[:-3]):
        assert torch.equal(x, y)


def test_small_interior_masks_are_shared():
    """The coarse levels' masks are made once (the plain cycle asks for
    them at every visit); a large one is made afresh, so that no fine-level
    mask stays allocated."""
    from tpu_multigrid_torch.core import ops3d
    cpu = torch.device("cpu")
    small = ops3d.interior_mask3((48, 48, 128), 32, cpu)
    assert small is ops3d.interior_mask3((48, 48, 128), 32, "cpu")
    assert torch.equal(small, ops3d._make_mask3((48, 48, 128), 32, cpu))
    assert small.sum() == 31 ** 3
    assert ops3d.interior_mask3((48, 48, 128), 16, cpu) is not small
    big = (272, 272, 384)
    assert math.prod(big) > ops3d.MASK_CACHE_NODES
    assert ops3d.interior_mask3(big, 256) is not ops3d.interior_mask3(big,
                                                                      256)
