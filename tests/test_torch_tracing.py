"""The port's spans and counters (``tpu_multigrid_torch.tracing``) on the
CPU: nothing is recorded with the profiler off, every driver records one
root with its cycles, compensated adds, compensated residuals and syncs
nested under it while a ``torch.profiler`` session records, ``syncs`` is
counted either way, the outputs are bitwise the same, and the buffer's
bound holds."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tpu_multigrid_torch as tmg
from tpu_multigrid_torch import cycles, precision, tracing
from tpu_multigrid_torch.core import ops, ops3d

# One torch thread per test worker (see tests/test_torch_ops.py).
torch.set_num_threads(1)


def _setup(ndim):
    if ndim == 2:
        cfg = tmg.MultigridConfig(finest_level=6, coarsest_level=3, nu1=3,
                                  nu2=2, smoother="chebyshev",
                                  use_kernels=True)
        prob = tmg.PoissonProblem(cfg, device="cpu", align=256,
                                  min_pad_level=0)
        mask = ops.mask_interior
    else:
        cfg = tmg.MultigridConfig(finest_level=4, coarsest_level=2, nu1=3,
                                  nu2=2, smoother="chebyshev",
                                  use_kernels=True)
        prob = tmg.Poisson3DProblem(cfg, device="cpu", align=16,
                                    min_pad_level=0, lane_align=128)
        mask = ops3d.mask_interior3
    hier = prob.hierarchy
    op = hier.levels[0]
    shape = getattr(op, "grid_shape", (op.S, op.S))
    g = torch.Generator().manual_seed(7)
    b = mask(torch.randn(shape, generator=g), op.n)
    return hier, cfg, b


@pytest.fixture(scope="module")
def problems():
    return {2: _setup(2), 3: _setup(3)}


def _ds(hier, cfg, b):
    return precision.solve_refined_ds(hier, cfg, b, tol=1e-7, max_iters=30)


def _ts(hier, cfg, b):
    return precision.solve_refined_ts(hier, cfg, b, tol=1e-8, max_iters=30,
                                      ds_levels=3)


def _fixed(hier, cfg, b):
    return cycles.solve_fixed(hier, cfg, b, 3)


def _until(hier, cfg, b):
    return cycles.solve_until_tol(hier, cfg, b, tol=1e-4)


def _iterations(out):
    return out.iterations if isinstance(out, cycles.SolveResult) else out[-2]


def _tensors(out):
    if isinstance(out, cycles.SolveResult):
        return [out.u, torch.as_tensor(out.res_history)]
    return list(out[:-2])


# (driver, ndim, spans per iteration besides the cycle:
#  accumulate, residual, sync; syncs outside the loop)
DRIVERS = {
    "ds2": (_ds, 2, 1, 1, 1, 1),
    "ds3": (_ds, 3, 1, 1, 1, 1),
    "ts": (_ts, 2, 2 + 2 * 3, 1 + 3, 1, 1),
    "fixed": (_fixed, 2, 0, 0, 0, 1),
    "until": (_until, 2, 0, 0, 1, 1),
}


def _traced(fn, *args):
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(*args)
    return out, tracing.spans(), prof


def test_nothing_is_recorded_with_the_profiler_off(problems):
    tracing.reset()
    _ds(*problems[2])
    _fixed(*problems[2])
    assert tracing.spans() == [] and tracing.dropped == 0
    # Off, every site shares one null context.
    assert tracing.span("cycle") is tracing.span("sync", what="x") \
        is tracing.solve()


@pytest.mark.parametrize("name", list(DRIVERS))
def test_a_driver_records_one_root_and_its_spans(problems, name):
    fn, ndim, acc, res, syn, syn0 = DRIVERS[name]
    out, spans, _ = _traced(fn, *problems[ndim])
    it = _iterations(out)
    roots = [i for i, s in enumerate(spans) if s.parent is None]
    assert len(roots) == 1 and spans[roots[0]].name == "solve"
    root = spans[roots[0]]
    assert root.attrs == {"iterations": it, "syncs": syn * it + syn0}
    count = {n: sum(1 for s in spans if s.name == n)
             for n in ("cycle", "accumulate", "residual", "sync")}
    assert count == {"cycle": it, "accumulate": acc * it,
                     "residual": res * it, "sync": syn * it + syn0}
    for s in spans:
        assert s.request == root.request is not None
        assert s.start_ns <= s.end_ns and s.device_ms is None
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    # Cycles and syncs sit right under the root; the adds and residuals
    # under the root or, inside cycle_ds, under a cycle.
    for s in spans:
        if s.name in ("cycle", "sync"):
            assert spans[s.parent] is root
        elif s.name in ("accumulate", "residual"):
            assert spans[s.parent].name in ("solve", "cycle")
    kinds = {s.attrs.get("kind") for s in spans if s.name == "accumulate"}
    assert kinds <= ({"ds", "ts"} if name == "ts" else {"ds"})
    # Both grids qualify for a compensated-residual kernel.
    paths = {s.attrs["path"] for s in spans if s.name == "residual"}
    assert paths <= {"kernel"}


@pytest.mark.parametrize("name", list(DRIVERS))
def test_outputs_are_bitwise_equal_with_tracing_on_and_off(problems, name):
    fn, ndim = DRIVERS[name][:2]
    off = fn(*problems[ndim])
    on, spans, _ = _traced(fn, *problems[ndim])
    assert spans and _iterations(on) == _iterations(off)
    for a, b in zip(_tensors(off), _tensors(on), strict=True):
        assert torch.equal(a, b) or (a.isnan() == b.isnan()).all() and \
            torch.equal(a[~a.isnan()], b[~b.isnan()])


@pytest.mark.parametrize("name", list(DRIVERS))
def test_syncs_are_counted_with_tracing_off(problems, name):
    fn, ndim, _, _, syn, syn0 = DRIVERS[name]
    tracing.reset()
    before = tracing.counts()
    out = fn(*problems[ndim])
    after = tracing.counts()
    assert after["syncs"] - before["syncs"] == syn * _iterations(out) + syn0
    assert tracing.spans() == []
    assert set(after) == {"syncs"} | set(tmg.kernels.launch_counts())


def test_reset_counts_zeroes_every_counter(problems):
    _fixed(*problems[2])
    tracing.reset_counts()
    assert set(tracing.counts().values()) == {0}


def test_a_driver_inside_a_root_opens_no_second_root(problems):
    hier, cfg, b = problems[2]

    def nested():
        with tracing.solve():
            precision.solve_refined(hier, cfg, b, tol=1e-7)
            cycles.solve_fixed(hier, cfg, b, 1)

    _, spans, _ = _traced(nested)
    assert [s.name for s in spans].count("solve") == 1
    assert len({s.request for s in spans}) == 1


def test_requests_get_new_ids(problems):
    def two():
        _fixed(*problems[2])
        _fixed(*problems[2])
    _, spans, _ = _traced(two)
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["solve", "solve"]
    assert roots[0].request != roots[1].request


def test_the_bound_drops_and_counts(problems, monkeypatch):
    monkeypatch.setattr(tracing, "BOUND", 5)
    out, spans, _ = _traced(_ds, *problems[2])
    assert len(spans) == 5
    total = 1 + 4 * _iterations(out) + 1
    assert tracing.dropped == total - 5
    tracing.reset()
    assert tracing.spans() == [] and tracing.dropped == 0


def test_no_span_reaches_the_profiler(problems):
    """The spans stay in memory: the profiler's own events hold none of
    their names (a record_function would put them there)."""
    _, spans, prof = _traced(_ts, *problems[2])
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {s.name for s in spans} == {"solve", "cycle", "accumulate",
                                       "residual", "sync"}
    assert not names & {s.name for s in spans}


class _FakeEvent:
    """A CUDA event on a fake clock: each record reads the next tick."""

    clock = 0
    made = 0

    def __init__(self, enable_timing=True):
        _FakeEvent.made += 1
        self.t = None

    def record(self, stream=None):
        _FakeEvent.clock += 1
        self.t = _FakeEvent.clock

    def query(self):
        return True

    def elapsed_time(self, end):
        return float(end.t - self.t)


class _FakeStream:
    device_index = 0


class _CudaLike:
    is_cuda = True

    def get_device(self):
        return 0


def test_events_are_read_at_the_next_sync_and_reused(monkeypatch):
    """Each device span records an event at both edges; a sync reads the
    pairs closed before the one before it and frees their events, so a
    long run keeps a few events alive; spans() reads the rest."""
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _FakeStream())
    monkeypatch.setattr(tracing, "_free", {})
    _FakeEvent.made = 0
    like, x = _CudaLike(), torch.ones(())

    def iterations():
        with tracing.solve():
            for _ in range(50):
                with tracing.span("cycle", like):
                    with tracing.span("accumulate", like, kind="ds"):
                        pass
                tracing.sync(x, "norm")

    _, spans, _ = _traced(iterations)
    cycles = [s for s in spans if s.name == "cycle"]
    adds = [s for s in spans if s.name == "accumulate"]
    assert len(cycles) == 50 and [c.device_ms for c in cycles] == [3.0] * 50
    assert [a.device_ms for a in adds] == [1.0] * 50
    assert _FakeEvent.made <= 12
    assert all(s.device_ms is None for s in spans
               if s.name in ("solve", "sync"))
