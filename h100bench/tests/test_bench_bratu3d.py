"""The ``bratu3d-513.fas-vcycles-6`` and ``poisson2d-8193.fmg-1e-7`` cells
on the CPU, cut to a few levels and run through the whole harness: a sound
run is correct and reads the FAS and FMG spans, a planted fault (a wrong
lambda, an unchanged step, an altered answer) comes out not correct, the
bfloat16 control fails the limits, the files load by name, a program
without the spans is refused, and the FAS kernels' roofline yardstick is
chip_smoke.py's."""

import pytest
import torch

import check
import devtrace
import harness
import roofline
import roofline_fas3
from smallcells import ROOT, run_small, small_cell
from tpu_multigrid_torch import cycles, precision, tracing
from tpu_multigrid_torch.cycles import fas

CELL = "bratu3d-513.fas-vcycles-6"
FMG = "poisson2d-8193.fmg-1e-7"
LEVELS = {CELL: (5, 3), FMG: (6, 3)}


@pytest.mark.parametrize("cell", [CELL, FMG])
@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(cell, trace):
    result, lines = run_small(cell, trace=trace, levels=LEVELS[cell])
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] >= 1
    if trace:
        # The program's spans read on the CPU (the device ones need the
        # card).
        assert result["metrics"]["syncs_per_solve"]["value"] >= 1


def _wrong_lambda(monkeypatch):
    """The program built with lam = 5 where the configuration states 6."""
    from tpu_multigrid_torch.problems import bratu
    build = bratu.Bratu3DProblem

    def five(cfg, lam=1.0, **kw):
        return build(cfg, lam=lam - 1.0, **kw)
    monkeypatch.setattr(bratu, "Bratu3DProblem", five)


def _unchanged_step(monkeypatch):
    monkeypatch.setattr(fas, "fas_cycle_with_norm",
                        lambda hier, cfg, u, b: (u, torch.ones(())))


def _altered_answer(monkeypatch):
    solve = fas.fas_solve_fixed

    def altered(*args, **kw):
        res = solve(*args, **kw)
        res.u = res.u * (1 + 1e-3)
        return res
    monkeypatch.setattr(fas, "fas_solve_fixed", altered)


@pytest.mark.parametrize("fault", [_wrong_lambda, _unchanged_step,
                                   _altered_answer])
def test_a_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result, lines = run_small(CELL, levels=LEVELS[CELL])
    assert not result["correct"], lines


def test_an_unconverged_fmg_start_is_not_correct(monkeypatch):
    """The refinement stopped after one iteration from the FMG start."""
    solve_ds = precision.solve_refined_ds
    monkeypatch.setattr(precision, "solve_refined_ds",
                        lambda *a, **kw: solve_ds(*a, **dict(kw,
                                                             max_iters=1)))
    result, lines = run_small(FMG, levels=LEVELS[FMG])
    assert not result["correct"], lines


@pytest.mark.parametrize("seed", [2 ** 31 + 1, 2 ** 31 + 2])
def test_control_fails_the_limits(seed):
    c = small_cell(CELL, LEVELS[CELL])
    (b,) = harness.make_pool(seed, c.config, dict(c.traffic, pool=1), "cpu")
    got = check.control(c.config, c.traffic, c.limits, b, "cpu")
    assert any(got[k] > v["limit"] for k, v in c.limits["compare"].items())
    assert got["u_gap"] > 10 * c.limits["compare"]["u_gap"]["limit"], got


def test_cell_files_load_by_name():
    cell = harness.load_cell(ROOT, CELL)
    assert cell.config["reference"] == cell.config["system"] == "bratu3d"
    assert cell.traffic["entry"] == "fas_solve_fixed"
    names = {m["name"] for m in cell.per_layer}
    assert {"k1f_roofline.3d", "k2f_roofline.3d", "coarse_newton_ms",
            "cycle_device_ms", "syncs_per_solve"} <= names
    assert "fmg_ms" not in names
    fmg = harness.load_cell(ROOT, FMG)
    assert fmg.traffic["entry"] == "solve_fmg_refined_ds"
    assert {"fmg_ms", "iters_per_solve", "accumulate_ms",
            "residual_ms"} <= {m["name"] for m in fmg.per_layer}
    for c in (cell, fmg):
        for m in c.end_to_end + c.per_layer:
            reader = harness.load_module(harness.BENCH / "metrics"
                                         / f"{m['name']}.py")
            assert callable(reader.read)
        for spec in c.limits["compare"].values():
            assert spec["lower"] < spec["limit"] < spec["upper"]


def test_a_program_without_the_spans_is_refused(monkeypatch):
    """As the program was before its FAS and FMG drivers recorded spans:
    the FAS driver's blocking reads are not counted, and ``cycles.fmg``
    opens no ``fmg`` span."""
    monkeypatch.setattr(tracing, "sync", lambda t, what: (
        t.item() if t.dim() == 0 else t.cpu()))
    monkeypatch.setattr(cycles, "fmg", lambda hier, cfg, b, b_levels=None: (
        cycles._fmg(hier, cfg, b, b_levels)))
    with pytest.raises(RuntimeError, match="blocking reads"):
        run_small(CELL, levels=LEVELS[CELL])
    with pytest.raises(RuntimeError, match="fmg"):
        run_small(FMG, levels=LEVELS[FMG])


# PERF.md section 6, rows 23-24, "bound ms" at (528, 528, 640) /
# (272, 272, 384), 2 sweeps.
PAIR3 = ([512, [528, 528, 640]], [256, [272, 272, 384]])


def test_fas_counts_match_chip_smoke():
    chip_smoke = pytest.importorskip("chip_smoke")
    (n, shape), (_, shape_c) = PAIR3
    want = chip_smoke.fas_work("fas_", "3", tuple(shape), tuple(shape_c), n,
                               2)
    assert roofline_fas3.fas3_work(shape, shape_c, n, 2) == want
    for name, ms in (("fas_smooth_restrict3", 0.601),
                     ("fas_prolong_smooth3", 0.552),
                     ("fas_prolong_smooth_resnorm3", 0.552)):
        secs, by = roofline.bound(*want[name])
        assert by == "bytes" and round(secs * 1e3, 3) == ms


def _run(device, launches, cycles):
    config = {"ndim": 3, "multigrid": {"nu1": 2, "nu2": 2},
              "levels": [list(p) for p in PAIR3] + [[128, [144, 144, 256]]]}
    t = devtrace.Trace(device=device, host=[], window_s=1.0,
                       launches=launches)
    return harness.Run(setup_s=0, window_s=1.0, solve_s=[1.0],
                       solves=[{"cycles": cycles}], peak_bytes=0,
                       held_bytes=0, trace=t, config=config)


def test_fas_shares_read_the_bratu_instances_only():
    """Two cycles over two fused pairs, 4 ms of K1f_3 and 3 of K2f_3 (one
    resnorm visit a cycle); the 7-point instances beside them are not
    counted."""
    k1 = harness.load_module(harness.BENCH / "metrics" / "k1f_roofline.3d.py")
    k2 = harness.load_module(harness.BENCH / "metrics" / "k2f_roofline.3d.py")
    fas_k1 = ("void (anonymous namespace)::smooth_restrict3_kernel<"
              "(anonymous namespace)::BratuOp3, true>(float const*)")
    fas_k2 = ("void (anonymous namespace)::prolong_smooth3_kernel<"
              "(anonymous namespace)::BratuOp3>(float const*)")
    const_k1 = ("void (anonymous namespace)::zmarch::smooth_restrict3_kernel"
                "<(anonymous namespace)::ZConstOp3, 3>(float const*)")
    device = ([(fas_k1, 0.0, 1000.0)] * 4 + [(fas_k2, 0.0, 1000.0)] * 3
              + [(const_k1, 0.0, 5000.0)])
    run = _run(device, {"fas_smooth_restrict3": 4, "fas_prolong_smooth3": 2,
                        "fas_prolong_smooth_resnorm3": 2}, 2)
    lv = run.config["levels"]

    def work(i, name):
        return roofline.bound(*roofline_fas3.fas3_work(
            lv[i][1], lv[i + 1][1], lv[i][0], 2)[name])[0]
    need1 = 2 * (work(0, "fas_smooth_restrict3")
                 + work(1, "fas_smooth_restrict3"))
    need2 = 2 * (work(0, "fas_prolong_smooth_resnorm3")
                 + work(1, "fas_prolong_smooth3"))
    assert k1.read(run) == pytest.approx(100 * need1 / 4e-3)
    assert k2.read(run) == pytest.approx(100 * need2 / 3e-3)
    # Only 7-point instances, or no launches: nothing to read.
    assert k1.read(_run([(const_k1, 0.0, 1000.0)],
                        {"fas_smooth_restrict3": 2}, 2)) is None
    assert k2.read(_run(device, {}, 2)) is None


class _Window:
    solves = 2

    def __init__(self, spans):
        self.all = self.spans = spans

    def named(self, name):
        return [s for s in self.spans if s.name == name]


def test_coarse_newton_ms_reads_the_newton_spans_only(monkeypatch):
    reader = harness.load_module(harness.BENCH / "metrics"
                                 / "coarse_newton_ms.py")
    progspans = pytest.importorskip("progspans")
    spans = [tracing.Span("coarse", 0, 1, None, 1, {"kind": k}, ms)
             for k, ms in (("newton", 3.0), ("smooth", 5.0),
                           ("newton", 4.0))]
    monkeypatch.setattr(progspans, "of", lambda run: _Window(spans))
    assert reader.read(None) == pytest.approx(3.5)
    monkeypatch.setattr(progspans, "of", lambda run: _Window(spans[1:2]))
    assert reader.read(None) is None


def test_fmg_ms_reads_the_outermost_fmg_spans(monkeypatch):
    reader = harness.load_module(harness.BENCH / "metrics" / "fmg_ms.py")
    progspans = pytest.importorskip("progspans")
    spans = [tracing.Span("solve", 0, 9, None, 1, {}, None),
             tracing.Span("fmg", 0, 1, 0, 1, {}, 3.0),
             tracing.Span("fmg", 0, 1, 1, 1, {}, 2.0),
             tracing.Span("solve", 0, 9, None, 2, {}, None),
             tracing.Span("fmg", 0, 1, 3, 2, {}, 5.0)]
    monkeypatch.setattr(progspans, "of", lambda run: _Window(spans))
    assert reader.read(None) == pytest.approx(4.0)
    monkeypatch.setattr(progspans, "of", lambda run: _Window(spans[:1]))
    assert reader.read(None) is None
