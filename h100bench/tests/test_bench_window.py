"""The window's arithmetic: the closed loop, solve_ms, the 95th percentile
with its sample count, and the sample of solves the check compares."""

import statistics
import time

import torch

import harness

METRICS = harness.BENCH / "metrics"


def _run(solve_s, window_s=None, peak=0, held=0):
    return harness.Run(setup_s=1.5, window_s=window_s or sum(solve_s),
                       solve_s=solve_s,
                       solves=[{"iterations": 8, "cycles": 8,
                                "converged": True}] * len(solve_s),
                       peak_bytes=peak, held_bytes=held, trace=None,
                       config={})


def test_solve_ms_is_the_window_over_the_solves():
    reader = harness.load_module(METRICS / "solve_ms.py")
    assert reader.read(_run([0.07] * 10, window_s=0.75)) == 75.0


def test_p95_needs_two_hundred_solves():
    reader = harness.load_module(METRICS / "solve_ms_p95.py")
    times = [0.070 + 0.0001 * (i % 100) for i in range(200)]
    got = reader.read(_run(times))
    assert got == statistics.quantiles(times, n=20)[18] * 1e3
    assert 0.0794 * 1e3 <= got <= 0.0800 * 1e3
    assert reader.read(_run(times[:199])) is None


def test_setup_and_peak_readers():
    assert harness.load_module(METRICS / "setup_s.py").read(
        _run([0.1])) == 1.5
    peak = harness.load_module(METRICS / "peak_mem_gib.py")
    assert peak.read(_run([0.1], peak=3 * 2 ** 30)) == 3.0
    assert peak.read(_run([0.1], peak=5 * 2 ** 30, held=2 ** 31)) == 3.0
    assert peak.read(_run([0.1], peak=0)) is None


class _Entry:
    """Solves in a fixed time, returning its call count as the answer."""

    def __init__(self, secs):
        self.secs, self.calls = secs, 0

    def solve(self, hier, cfg, b, traffic):
        time.sleep(self.secs)
        self.calls += 1
        return {"u": (b + self.calls,), "iterations": 1, "cycles": 1,
                "converged": True}


def test_window_ends_at_the_first_completion_past_the_seconds():
    entry = _Entry(0.02)
    pool = [torch.zeros(3), torch.ones(3)]
    sample = harness.Sample(2, 5, (pool[0],))
    t_start, window_s, solve_s, solves = harness.window(
        entry, None, None, pool, {}, 0.1, "cpu", sample, False)
    assert window_s >= 0.1
    assert window_s - sum(solve_s) < 0.02
    assert sum(solve_s[:-1]) < 0.1 + 0.01 * len(solve_s)
    assert len(solves) == entry.calls >= 4


def test_sample_is_drawn_from_the_seed_and_copies_the_answers():
    def draws(seed):
        s = harness.Sample(2, seed, (torch.zeros(1),))
        for i in range(50):
            s.offer(i, i % 4, (torch.full((1,), float(i)),))
        return [(i, j, float(parts[0])) for i, j, parts in s.items()]
    a, b = draws(11), draws(11)
    assert a == b and len(a) == 2
    assert all(v == i and j == i % 4 for i, j, v in a)
    assert any(draws(seed) != a for seed in range(12, 20))
