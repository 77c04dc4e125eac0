"""The 3D Bratu problem through the port's FAS tier on the CPU, held
against the benchmark's plain reference (``h100bench/references/
bratu3d.py``, plain torch written from the configuration alone), and the
FAS and FMG drivers' spans.

* The port's nonlinear residual A u - h^2 lam e^u in float64 equals the
  reference's to 1e-13 relative, and its FAS V-cycles from zero (both
  routes: the kernels' plain versions and the operators' methods) equal
  the reference's after each of 1 to 6 cycles to 1e-11, at levels 4 and 5
  with the ``bratu3d-513`` configuration's schedule, lam = 6 and the
  benchmark's seeded forcings.
* The float32 port stays within the cell's ``u_gap`` limit of the float64
  reference; a port with phi = 0, or with the exponential dropped, does
  not.
* The FAS drivers record a ``solve`` root with ``iterations`` and
  ``syncs``, a ``cycle`` per finest-level cycle and a ``coarse`` span per
  coarsest-level solve (``kind``), FMG-FAS and ``cycles.fmg`` an ``fmg``
  span, only while a profiler records; ``syncs`` counts the drivers'
  blocking reads either way, and the outputs keep their bits.  A front
  door's FMG start and the driver after it are one ``solve``.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tpu_multigrid_torch as tmg
from tpu_multigrid_torch import cycles, tracing
from tpu_multigrid_torch.core import ops3d
from tpu_multigrid_torch.core.nonlinear import BratuNonlinearity
from tpu_multigrid_torch.cycles import fas
from tpu_multigrid_torch.problems.bratu import (Bratu3DProblem,
                                                NonlinearPoisson3DProblem)

# One torch thread per test worker (see tests/test_torch_ops.py).
torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parents[1] / "h100bench"
CELL = "bratu3d-513.fas-vcycles-6"


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF = _load("h100bench_reference_bratu3d_under_test",
            BENCH / "references" / "bratu3d.py")
FORCING = _load("h100bench_forcing_under_test", BENCH / "forcing.py")
CONFIG = json.loads((BENCH / "configs" / "bratu3d-513.json").read_text())
LIMITS = json.loads((BENCH / "limits" / f"{CELL}.json").read_text())
LAM = CONFIG["lambda"]


def _config(level):
    """The configuration's file with its levels cut to ``level`` -> 3."""
    cfg = json.loads(json.dumps(CONFIG))
    cfg["multigrid"]["finest_level"] = level
    return cfg


def _mg(level, dtype, use_kernels=True, **kw):
    fields = dict(CONFIG["multigrid"], finest_level=level,
                  use_kernels=use_kernels, **kw)
    fields["dtype"] = dtype
    return tmg.MultigridConfig(**fields)


def _problem(level, dtype, use_kernels=True, phi=None, **kw):
    cfg = _mg(level, dtype, use_kernels, **kw)
    pad = CONFIG["problem"]["kwargs"]
    if phi is None:
        prob = Bratu3DProblem(cfg, lam=LAM, device="cpu", **pad)
    else:
        prob = NonlinearPoisson3DProblem(cfg, phi=phi, dphi=phi,
                                         device="cpu", **pad)
    return prob.hierarchy, cfg


def _rhs(level, seed, shape, dtype):
    """b = f h^2 on the interior of the padded grid, f one of the
    benchmark's seeded forcings."""
    n = 2 ** level
    (params,) = FORCING.draw(seed, 1, 3, 8, 16)
    f = FORCING.field(params, n, shape, 0.05, "cpu")
    return ops3d.mask_interior3(f * (1.0 / n) ** 2, n).to(dtype)


def _nodes(x, n):
    return x[:n + 1, :n + 1, :n + 1].double()


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("level", [4, 5])
def test_residual_matches_the_reference(level):
    hier, _ = _problem(level, torch.float64)
    op = hier.levels[0]
    n = op.n
    b = _rhs(level, 2 ** 31 + level, op.grid_shape, torch.float64)
    g = torch.Generator().manual_seed(level)
    u = ops3d.mask_interior3(
        0.5 * torch.rand(op.grid_shape, generator=g, dtype=torch.float64), n)
    ref = REF.Reference(_config(level), torch.float64, "cpu")
    want = ref.residual(_nodes(u, n), _nodes(b, n))
    assert _rel(_nodes(op.residual(u, b), n), want) < 1e-13


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("level", [4, 5])
def test_cycles_match_the_reference(level, use_kernels):
    """Each of six FAS V-cycles from zero, float64, to 1e-11."""
    hier, cfg = _problem(level, torch.float64, use_kernels)
    op = hier.levels[0]
    n = op.n
    b = _rhs(level, 2 ** 31 + 10 + level, op.grid_shape, torch.float64)
    ref = REF.Reference(_config(level), torch.float64, "cpu")
    bn = _nodes(b, n)
    u, want = torch.zeros_like(b), torch.zeros_like(bn)
    for _ in range(6):
        u, _ = fas.fas_cycle_with_norm(hier, cfg, u, b)
        want = ref.vcycle(want, bn)
        assert _rel(_nodes(u, n), want) < 1e-11
    # Six cycles reach the neighbourhood of float32's floor.
    assert float(torch.linalg.norm(ref.residual(want, bn))
                 / torch.linalg.norm(bn)) < LIMITS["compare"]["rel_res"][
                     "limit"]


def _u_gap(hier, cfg, level, seed):
    op = hier.levels[0]
    b = _rhs(level, seed, op.grid_shape, cfg.dtype)
    got = fas.fas_solve_fixed(hier, cfg, b, 6).u
    ref = REF.Reference(_config(level), torch.float64, "cpu")
    return _rel(_nodes(got, op.n), ref.cycles(_nodes(b, op.n), 6))


def test_float32_port_is_within_the_cell_limit():
    hier, cfg = _problem(5, torch.float32)
    gap = _u_gap(hier, cfg, 5, 2 ** 31 + 21)
    assert gap < LIMITS["compare"]["u_gap"]["limit"] / 10


def _no_exp(u):
    return torch.full_like(u, -LAM)


@pytest.mark.parametrize("phi", [BratuNonlinearity(0.0), _no_exp],
                         ids=["phi=0", "exp dropped"])
def test_a_planted_fault_fails_the_cell_limit(phi):
    kernels = isinstance(phi, BratuNonlinearity)
    hier, cfg = _problem(5, torch.float32, kernels, phi=phi)
    assert _u_gap(hier, cfg, 5, 2 ** 31 + 21) > \
        LIMITS["compare"]["u_gap"]["limit"]


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    hier, cfg = _problem(4, torch.float32)
    b = _rhs(4, 2 ** 31 + 31, hier.levels[0].grid_shape, torch.float32)
    return hier, cfg, b


def _traced(fn, *args):
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn(*args)
    return out, tracing.spans()


def _fixed(hier, cfg, b):
    return fas.fas_solve_fixed(hier, cfg, b, 3)


def _until(hier, cfg, b):
    return fas.fas_solve_until_tol(hier, cfg, b, tol=1e-2)


def _fmg_fas(hier, cfg, b):
    bs = [b]
    for op, opc in zip(hier.levels, hier.levels[1:]):
        bs.append(ops3d.restrict_fw3(bs[-1], op.n, opc.grid_shape))
    return fas.fmg_fas(hier, cfg, bs)


# driver: (syncs outside the loop, syncs per cycle)
FAS_DRIVERS = {"fixed": (_fixed, 1, 0), "until": (_until, 1, 1)}


@pytest.mark.parametrize("name", list(FAS_DRIVERS))
def test_a_fas_driver_records_its_spans(small, name):
    fn, syn0, syn = FAS_DRIVERS[name]
    before = tracing.syncs
    out, spans = _traced(fn, *small)
    it = out.iterations
    assert tracing.syncs - before == syn0 + syn * it
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["solve"]
    root = roots[0]
    assert root.attrs == {"iterations": it, "syncs": syn0 + syn * it}
    count = {n: sum(1 for s in spans if s.name == n)
             for n in ("cycle", "coarse", "sync", "fmg")}
    # One coarsest-level solve a V-cycle, inside its cycle.
    assert count == {"cycle": it, "coarse": it, "sync": syn0 + syn * it,
                     "fmg": 0}
    for s in spans:
        assert s.request == root.request
        assert s.name in ("solve", "cycle", "coarse", "sync")
        assert s.device_ms is None and s.start_ns <= s.end_ns
        if s.name in ("cycle", "sync"):
            assert spans[s.parent] is root
        if s.name == "coarse":
            assert spans[s.parent].name == "cycle"
            assert s.attrs == {"kind": "newton"}


def test_the_smoothed_coarsest_level_is_a_coarse_span_too(small):
    hier, cfg, b = small
    cfg = dataclasses.replace(cfg, coarse_solver="smooth")
    _, spans = _traced(_fixed, hier, cfg, b)
    assert {s.attrs["kind"] for s in spans if s.name == "coarse"} == \
        {"smooth"}


def test_fmg_fas_alone_is_a_root_with_an_fmg_span(small):
    hier, cfg, _ = small
    _, spans = _traced(_fmg_fas, *small)
    assert [s.name for s in spans if s.parent is None] == ["solve"]
    root = spans[0]
    kc = hier.num_levels - 1
    assert root.attrs == {"iterations": kc * cfg.nu0, "syncs": 0}
    assert spans[1].name == "fmg" and spans[1].parent == 0
    coarse = [s for s in spans if s.name == "coarse"]
    assert len(coarse) == 1 + kc * cfg.nu0
    for s in coarse:
        p = s.parent
        while spans[p].name != "fmg":
            p = spans[p].parent
        assert p == 1


def test_fmg_fas_inside_a_driver_opens_no_root(small):
    hier, cfg, b = small

    def door():
        with tracing.solve():
            u0 = _fmg_fas(hier, cfg, b)
            return fas.fas_solve_fixed(hier, cfg, b, 1, u0=u0)

    _, spans = _traced(door)
    assert [s.name for s in spans].count("solve") == 1
    assert [s.name for s in spans if s.parent == 0][:1] == ["fmg"]


def test_linear_fmg_records_an_fmg_span_and_no_root():
    cfg = tmg.MultigridConfig(finest_level=6, coarsest_level=3, nu1=3,
                              nu2=2, smoother="chebyshev", use_kernels=True)
    prob = tmg.PoissonProblem(cfg, device="cpu", align=256, min_pad_level=0)
    _, spans = _traced(cycles.fmg, prob.hierarchy, cfg, prob.rhs())
    assert [s.name for s in spans] == ["fmg"]
    assert spans[0].parent is None and spans[0].request is None
    # Off the card the pass is issued as it runs: nothing is captured.
    cycles.fmg(prob.hierarchy, cfg, prob.rhs())
    assert prob.hierarchy not in cycles._FMG_GRAPHS


# door: a front door's FMG start and the driver after it, on the CPU
FMG_DOORS = {
    "bratu": lambda: tmg.solve_bratu(4, lam=6.0, ndim=3, use_fmg=True,
                                     num_cycles=2, device="cpu"),
    "poisson": lambda: tmg.solve_poisson(5, use_fmg=True, num_cycles=2,
                                         device="cpu"),
}


@pytest.mark.parametrize("door", list(FMG_DOORS))
def test_a_front_doors_fmg_start_and_driver_are_one_request(door):
    res, spans = _traced(FMG_DOORS[door])
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["solve"]
    assert roots[0].attrs["iterations"] == res.iterations == 2
    assert roots[0].attrs["syncs"] >= 1
    assert "fmg" in [s.name for s in spans if s.parent == 0]
    assert {s.request for s in spans} == {roots[0].request}


@pytest.mark.parametrize("fn", [_fixed, _until, _fmg_fas])
def test_fas_outputs_keep_their_bits_and_nothing_is_recorded_off(small, fn):
    tracing.reset()
    off = fn(*small)
    assert tracing.spans() == []
    on, spans = _traced(fn, *small)
    assert spans
    if isinstance(off, cycles.SolveResult):
        assert off.iterations == on.iterations
        assert torch.equal(off.u, on.u)
        h0, h1 = off.res_history, on.res_history
        assert torch.equal(h0.isnan(), h1.isnan())
        assert torch.equal(h0[~h0.isnan()], h1[~h1.isnan()])
    else:
        assert torch.equal(off, on)


def test_a_singular_coarse_jacobian_gives_non_finite_values():
    """The coarsest Newton step solves without checking the factorisation
    (no host wait on the card): a singular Jacobian gives non-finite
    values, as the JAX package's does, and raises nothing."""
    hier, _ = _problem(4, torch.float32)
    op = hier.levels[-1]

    def zero(u):
        return torch.zeros_like(u)
    singular = type(op)(op.lin, zero, zero, op.diag,
                        torch.zeros_like(op.a_dense))
    b = _rhs(3, 2 ** 31 + 41, op.grid_shape, torch.float32)
    got = singular.coarse_newton(torch.zeros_like(b), b)
    assert not bool(torch.isfinite(got).all())
