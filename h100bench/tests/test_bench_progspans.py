"""The readers of the program's own spans (``progspans`` and the metrics
that use it): the clock fit, the idle split by overlap, the per-cycle and
per-solve readings, None where there is nothing to read; which cells
report them; and a traced CPU run of each cell cut to a few levels."""

import pytest

import devtrace
import harness
import progspans
from smallcells import CELLS, ROOT, run_small
from tpu_multigrid_torch.tracing import Span

METRICS = ("syncs_per_solve", "idle_sync", "idle_issue", "cycle_issue_ms",
           "cycle_device_ms", "accumulate_ms", "residual_ms")
READ = {m: harness.load_module(harness.BENCH / "metrics" / f"{m}.py").read
        for m in METRICS}
# The compensated adds and residuals run only in the refinement cells.
REFINED_ONLY = ("accumulate_ms", "residual_ms")

# The program's clock runs this far behind the profiler's (in us).
OFFSET = 5_000_000.0


def _ns(us):
    """A profiler time in us on the program's perf_counter_ns clock."""
    return int(round((us - OFFSET) * 1e3))


def _span(name, t0, t1, parent, request, device_ms=None, **attrs):
    return Span(name, _ns(t0), _ns(t1), parent, request, attrs, device_ms)


# Two solves of the harness (its spans at 10-490 and 510-990 us inside a
# 0-1000 us window), each a program solve of one iteration: a norm sync,
# a cycle, an add, a residual and a sync.  A span of an earlier run's
# request (7) lies before them and is not of this window.
SPANS = [_span("solve", -2e6, -1.9e6, None, 7, iterations=1, syncs=2)]
for first, req in ((10, 1), (510, 2)):
    root = len(SPANS)
    SPANS += [
        _span("solve", first, first + 470, None, req, iterations=1, syncs=2),
        _span("sync", first + 10, first + 50, root, req, what="norm"),
        _span("cycle", first + 50, first + 250, root, req, device_ms=0.2),
        _span("accumulate", first + 250, first + 300, root, req,
              device_ms=0.04, kind="ds"),
        _span("residual", first + 300, first + 350, root, req,
              device_ms=0.03, path="kernel"),
        _span("sync", first + 350, first + 460, root, req, what="norm")]
HOST = [("h100bench.window", 0.0, 1000.0),
        ("h100bench.solve", 10.0, 490.0), ("h100bench.solve", 510.0, 990.0)]
# Busy 40-55 (inside the first sync), then 75-400; the gap 55-75 starts in
# the first sync and ends in the first cycle (5 us sync, 15 us issue).
DEVICE = [("k", 40.0, 55.0), ("k", 75.0, 400.0), ("k", 560.0, 700.0),
          ("k", 720.0, 870.0)]


def _run(spans, device=DEVICE, host=HOST, traced=True, monkeypatch=None):
    trace = devtrace.Trace(device=device, host=host, window_s=1000e-6,
                           launches={}) if traced else None
    run = harness.Run(setup_s=0, window_s=1000e-6, solve_s=[480e-6] * 2,
                      solves=[{"iterations": 1, "cycles": 1,
                               "converged": True}] * 2, peak_bytes=0,
                      held_bytes=0, trace=trace, config={})
    monkeypatch.setattr(progspans, "program_spans", lambda: spans)
    return run


def test_the_clock_fit_finds_the_offset(monkeypatch):
    w = progspans.of(_run(SPANS, monkeypatch=monkeypatch))
    assert w.offset_us == pytest.approx(OFFSET)
    assert w.spread_us == pytest.approx(0, abs=1e-3)
    assert [r.request for r in w.roots] == [1, 2]
    assert {s.request for s in w.spans} == {1, 2}


def test_a_gap_is_split_by_overlap(monkeypatch):
    """The gap 55-75 us starts in a sync and ends in a cycle: 5 us of sync
    (55-60) and 15 of issue (60-75), not all of it by its middle."""
    segs = progspans.Window(_run(SPANS, monkeypatch=monkeypatch),
                            SPANS).segments()
    got = progspans.split_idle([("k", 0.0, 55.0), ("k", 75.0, 100.0)],
                               (50.0, 80.0), segs)
    assert got["sync"] == pytest.approx(5e-6)
    assert got["issue"] == pytest.approx(15e-6)
    assert got["other"] == pytest.approx(0, abs=1e-12)


def test_idle_split_of_the_window(monkeypatch):
    """Gaps 0-40, 55-75, 400-560, 700-720, 870-1000 us.  Sync: 20-40,
    55-60, 400-470 (first solve), 520-560, 870-970 (second); issue: 10-20,
    60-75, 470-480, 510-520, 700-720, 970-980; other: 0-10, 480-510,
    980-1000."""
    run = _run(SPANS, monkeypatch=monkeypatch)
    sync = READ["idle_sync"](run)
    issue = READ["idle_issue"](run)
    assert sync == pytest.approx(100 * (20 + 5 + 70 + 40 + 100) / 1000)
    assert issue == pytest.approx(100 * (10 + 15 + 10 + 10 + 20 + 10) / 1000)
    idle = harness.load_module(harness.BENCH / "metrics"
                               / "device_idle.py").read(run)
    assert idle == pytest.approx(37.0)
    assert sync + issue <= idle
    assert idle - sync - issue == pytest.approx(100 * (10 + 30 + 20) / 1000)


def test_per_cycle_and_per_solve_readings(monkeypatch):
    run = _run(SPANS, monkeypatch=monkeypatch)
    assert READ["syncs_per_solve"](run) == 2
    assert READ["cycle_issue_ms"](run) == pytest.approx(0.2)
    assert READ["cycle_device_ms"](run) == pytest.approx(0.2)
    assert READ["accumulate_ms"](run) == pytest.approx(0.04)
    assert READ["residual_ms"](run) == pytest.approx(0.03)


def test_a_sync_inside_a_cycle_is_not_issue_time(monkeypatch):
    spans = SPANS[:1] + [
        _span("solve", 10, 480, None, 1, iterations=1, syncs=1),
        _span("cycle", 20, 420, 1, 1, device_ms=0.3),
        _span("sync", 100, 150, 2, 1, what="norm"),
        _span("solve", 510, 980, None, 2, iterations=1, syncs=0),
        _span("cycle", 520, 720, 4, 2, device_ms=0.1)]
    run = _run(spans, monkeypatch=monkeypatch)
    assert READ["cycle_issue_ms"](run) == pytest.approx((350 + 200) / 2e3)
    assert READ["syncs_per_solve"](run) == 0.5


@pytest.mark.parametrize("case", ["no spans", "no program", "no device",
                                  "no trace", "too few solves",
                                  "cpu spans"])
def test_nothing_to_read_gives_none(monkeypatch, case):
    spans, device, traced = SPANS, DEVICE, True
    if case == "no spans":
        spans = []
    elif case == "no program":
        spans = None
    elif case == "no device":
        device = []
    elif case == "no trace":
        traced = False
    elif case == "too few solves":
        spans = SPANS[:7]
    else:
        spans = [Span(s.name, s.start_ns, s.end_ns, s.parent, s.request,
                      s.attrs, None) for s in SPANS]
    run = _run(spans, device=device, traced=traced, monkeypatch=monkeypatch)
    got = {m: READ[m](run) for m in METRICS}
    if case == "no device":
        assert got["idle_sync"] is None and got["idle_issue"] is None
        assert got["syncs_per_solve"] == 2
    elif case == "cpu spans":
        assert got["cycle_device_ms"] is None and got["accumulate_ms"] is None
        assert got["residual_ms"] is None and got["cycle_issue_ms"] > 0
    else:
        assert set(got.values()) == {None}


def test_without_the_harness_spans_there_is_no_idle_split(monkeypatch):
    host = [("h100bench.window", 0.0, 1000.0)]
    run = _run(SPANS, host=host, monkeypatch=monkeypatch)
    assert READ["idle_sync"](run) is None
    assert READ["syncs_per_solve"](run) == 2


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_cpu_run_reads_the_program_spans(cell):
    result, lines = run_small(cell, trace=True)
    assert result["correct"], lines
    m = result["metrics"]
    syncs = m["syncs_per_solve"]["value"]
    if cell.endswith("vcycles-3"):
        assert syncs == 1
    else:
        assert syncs == pytest.approx(m["iters_per_solve"]["value"] + 1)
    assert m["cycle_issue_ms"]["value"] > 0
    # No device on the CPU: nothing for the device readers.
    for name in ("idle_sync", "idle_issue", "cycle_device_ms",
                 "accumulate_ms", "residual_ms"):
        assert name not in m


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_the_span_metrics(cell):
    """Every cell reports the span metrics but the compensated add's and
    residual's, which only the refinement cells report."""
    got = {m["name"] for m in harness.load_cell(ROOT, cell).per_layer}
    want = set(METRICS) - set(REFINED_ONLY)
    if "refined" in cell:
        want |= set(REFINED_ONLY)
    assert got & set(METRICS) == want
