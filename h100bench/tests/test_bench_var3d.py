"""The ``var3d-513.refined-1e-8`` cell on the CPU, cut to levels 5 -> 3 and
run through the whole harness: a sound run is correct, each fault comes out
not correct (the constant Laplacian's residual in place of the flux
stencil's among them), the float32 control fails the limits, its files
load by name, the system refuses a program without the compensated
residual, and the var kernels' roofline yardstick is chip_smoke.py's."""

import pytest
import torch

import check
import devtrace
import harness
import roofline
import roofline_var3
from smallcells import ROOT, run_small, small_cell
from tpu_multigrid_torch import precision

CELL = "var3d-513.refined-1e-8"
LEVELS = (5, 3)


@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(trace):
    result, lines = run_small(CELL, trace=trace, levels=LEVELS)
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert result["checks"]["rel_res"]["value"] <= 1e-8


def _constant_residual(monkeypatch):
    """The constant Laplacian's compensated residual on the var hierarchy:
    refinement corrects toward the Poisson solution."""
    monkeypatch.setattr(precision, "ds_residual_var3",
                        lambda op, b, hi, lo: precision.ds_residual(
                            b, hi, lo, op.n))


def _unchanged_step(monkeypatch):
    monkeypatch.setattr(precision, "cycle", lambda hier, cfg, u, b, k=0: u)


def _altered_answer(monkeypatch):
    solve_ds = precision.solve_refined_ds

    def ds(*args, **kw):
        hi, lo, *rest = solve_ds(*args, **kw)
        return (hi * (1 + 1e-3), lo, *rest)
    monkeypatch.setattr(precision, "solve_refined_ds", ds)


@pytest.mark.parametrize("fault", [_constant_residual, _unchanged_step,
                                   _altered_answer])
def test_a_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result, lines = run_small(CELL, levels=LEVELS)
    assert not result["correct"], lines


@pytest.mark.parametrize("seed", [2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3])
def test_control_fails_the_limits(seed):
    c = small_cell(CELL, LEVELS)
    (b,) = harness.make_pool(seed, c.config, dict(c.traffic, pool=1), "cpu")
    got = check.control(c.config, c.traffic, c.limits, b, "cpu")
    assert got["rel_res"] > c.limits["compare"]["rel_res"]["limit"], got


def test_cell_files_load_by_name():
    cell = harness.load_cell(ROOT, CELL)
    assert cell.config["reference"] == cell.config["system"] == "diffusion3d"
    assert cell.traffic["entry"] == "solve_refined_ds"
    names = {m["name"] for m in cell.per_layer}
    assert {"var_residual_ms", "k1v_roofline.3d", "k2v_roofline.3d"} <= names
    for m in cell.end_to_end + cell.per_layer:
        reader = harness.load_module(harness.BENCH / "metrics"
                                     / f"{m['name']}.py")
        assert callable(reader.read)
    system = harness.system(cell.config)
    assert callable(system.build) and callable(system.rhs)


def test_limits_lie_between_the_readings():
    spec = harness.load_cell(ROOT, CELL).limits["compare"]["rel_res"]
    assert spec["lower"] < spec["limit"] < spec["upper"]
    assert spec["upper"] >= 3 * spec["lower"]


def test_the_system_refuses_a_program_without_the_residual(monkeypatch):
    monkeypatch.delattr(precision, "compensable")
    with pytest.raises(RuntimeError, match="compensated residual"):
        harness.build_system(small_cell(CELL, LEVELS).config, "cpu")


# PERF.md section 6, rows 15-16, "bound ms" on 3 planes at (528, 528, 640)
# / (272, 272, 384), Chebyshev 3 / 2.
PAIR3 = ([512, [528, 528, 640]], [256, [272, 272, 384]])


def test_var_counts_match_chip_smoke():
    chip_smoke = pytest.importorskip("chip_smoke")
    (n, shape), (_, shape_c) = PAIR3
    for nplanes in (3, 4, 6):
        for sm in ("jacobi", "rbgs"):
            assert roofline_var3.var3_work(shape, shape_c, n, nplanes, sm,
                                           3, 2) == chip_smoke.var3_work(
                shape, shape_c, n, nplanes, sm, 3, 2)
    work = roofline_var3.var3_work(shape, shape_c, n, 3, "jacobi", 3, 2)
    for name, ms in (("var_smooth_restrict3", 1.051),
                     ("var_prolong_smooth3", 1.036)):
        secs, by = roofline.bound(*work[name])
        assert by == "bytes" and round(secs * 1e3, 3) == ms


def _run(device, launches, cycles):
    config = {"ndim": 3, "multigrid": {"smoother": "chebyshev", "nu1": 3,
                                       "nu2": 2},
              "levels": [list(p) for p in PAIR3] + [[128, [144, 144, 256]]]}
    t = devtrace.Trace(device=device, host=[], window_s=1.0,
                       launches=launches)
    return harness.Run(setup_s=0, window_s=1.0, solve_s=[1.0],
                       solves=[{"cycles": cycles}], peak_bytes=0,
                       held_bytes=0, trace=t, config=config)


def test_var_shares_read_the_var_instances_only():
    """Two cycles over two fused pairs, 4 ms of K1v_3 and 3 of K2v_3; the
    constant instances beside them are not counted."""
    k1 = harness.load_module(harness.BENCH / "metrics" / "k1v_roofline.3d.py")
    k2 = harness.load_module(harness.BENCH / "metrics" / "k2v_roofline.3d.py")
    var_k1 = ("void (anonymous namespace)::zmarch_smooth_restrict3_kernel<"
              "(anonymous namespace)::VarOp3<3>, 3>(float const*)")
    var_k2 = ("void (anonymous namespace)::prolong_smooth3_kernel<"
              "(anonymous namespace)::VarOp3<3> >(float const*)")
    const_k2 = ("void (anonymous namespace)::prolong_smooth3_kernel<"
                "(anonymous namespace)::ConstOp3, false>(float const*)")
    device = ([(var_k1, 0.0, 1000.0)] * 4 + [(var_k2, 0.0, 1000.0)] * 3
              + [(const_k2, 0.0, 5000.0)])
    run = _run(device, {"var_smooth_restrict3": 4, "var_prolong_smooth3": 4},
               2)
    lv = run.config["levels"]

    def need(name):
        return 2 * sum(roofline.bound(*roofline_var3.var3_work(
            lv[i][1], lv[i + 1][1], lv[i][0], 3, "jacobi", 3, 2)[name])[0]
            for i in range(2))
    assert k1.read(run) == pytest.approx(100 * need("var_smooth_restrict3")
                                         / 4e-3)
    assert k2.read(run) == pytest.approx(100 * need("var_prolong_smooth3")
                                         / 3e-3)
    # Only constant instances, or no launches: nothing to read.
    assert k2.read(_run([(const_k2, 0.0, 1000.0)],
                        {"var_prolong_smooth3": 2}, 2)) is None
    assert k1.read(_run(device, {}, 2)) is None


def test_var_residual_ms_reads_the_var3_spans_only(monkeypatch):
    """The reader keeps the ``residual`` spans whose path is var3."""
    reader = harness.load_module(harness.BENCH / "metrics"
                                 / "var_residual_ms.py")
    from tpu_multigrid_torch import tracing

    class Window:
        solves = 2

        def named(self, name):
            return [tracing.Span(name, 0, 1, None, 1, {"path": p}, ms)
                    for p, ms in (("var3", 3.0), ("kernel", 5.0),
                                  ("var3", 4.0))]
    progspans = pytest.importorskip("progspans")
    monkeypatch.setattr(progspans, "of", lambda run: Window())
    assert reader.read(None) == pytest.approx(3.5)
    monkeypatch.setattr(Window, "named", lambda self, name: [])
    assert reader.read(None) is None


def test_the_system_builds_the_configured_coefficient():
    """The finest planes of the cut cell are the reference's, and the
    program's levels are the configuration's."""
    cfg = small_cell(CELL, LEVELS).config
    hier, _ = harness.build_system(cfg, "cpu")
    ref = check.reference(cfg, torch.float64, "cpu")
    for op, planes in zip(hier.levels, ref.t):
        for got, want in zip((op.tz, op.ty, op.tx), planes):
            assert torch.equal(check.nodes(got, op.n).double(), want)
