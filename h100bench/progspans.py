"""The program's own spans over a traced window, for the readers of the
``program_span`` and ``program_counter`` metrics.

The program records its spans in memory while the profiler records
(``tpu_multigrid_torch.tracing``); the readers run in the traced run's
process after the window, so they read ``tracing.spans()`` directly.  A
program without that module, or a run without a trace, gives nothing.

* The window's spans: the last N root ``solve`` spans, N the solves the
  window completed, and every span of the same request.  The warm-up
  solve runs before the profiler starts and records none.
* The clock: each root is paired, in order, with the harness's
  ``h100bench.solve`` span of the same call (on the profiler's clock); the
  offset from ``time.perf_counter_ns`` to the profiler's clock is the
  median of the differences of their starts, fitted on every run (it
  differs between processes).
* The idle time: the device's idle gaps inside the harness's window span
  (the complement of the union of device intervals, as
  ``devtrace.idle_gaps`` finds them), each split by overlap with the
  innermost program span at each instant: ``sync`` where that span is a
  ``sync``, ``issue`` inside any other program span, ``other`` outside
  every program span (the harness, between solves).
"""

from __future__ import annotations

import statistics
import sys
from typing import Dict, List, Optional

import devtrace

HARNESS_SOLVE = devtrace.SPAN_PREFIX + "solve"
# How far (us) a program solve may seem to lie outside the harness's span
# of its call, by the clock fit's error.
SLACK_US = 1000.0


def program_spans():
    """The program's recorded spans, or None where it records none."""
    try:
        from tpu_multigrid_torch import tracing
    except ImportError:
        return None
    return tracing.spans()


class Window:
    """The program's spans of one traced window, and what they give."""

    def __init__(self, run, spans):
        self.run = run
        self.solves = len(run.solve_s)
        roots = [i for i, s in enumerate(spans)
                 if s.parent is None and s.name == "solve"]
        if self.solves == 0 or len(roots) < self.solves:
            raise LookupError("fewer program solve spans than solves")
        self.roots = [spans[i] for i in roots[-self.solves:]]
        requests = {s.request for s in self.roots}
        self.index = [i for i, s in enumerate(spans)
                      if s.request in requests and s.end_ns is not None]
        self.all = spans
        self.spans = [spans[i] for i in self.index]
        self.offset_us = self.spread_us = self.largest_us = None
        self.idle_s: Optional[Dict[str, float]] = None
        harness = sorted((s, e) for n, s, e in run.trace.host
                         if n == HARNESS_SOLVE)
        if len(harness) == self.solves:
            offsets = [h[0] - r.start_ns / 1e3
                       for h, r in zip(harness, self.roots)]
            self.offset_us = statistics.median(offsets)
            self.largest_us = max(abs(o - self.offset_us) for o in offsets)
            self.spread_us = (0.0 if len(offsets) < 2 else
                              _iqr(offsets))
            # Each root lies in its harness span, or the pairing is wrong
            # (a root of an earlier run, spans dropped).
            for (h0, h1), r in zip(harness, self.roots):
                if not (h0 - SLACK_US <= r.start_ns / 1e3 + self.offset_us
                        and r.end_ns / 1e3 + self.offset_us <= h1 + SLACK_US):
                    raise LookupError("a program solve outside its call")
            if run.trace.device:
                self.idle_s = split_idle(
                    run.trace.device, devtrace.window_span(run.trace.host),
                    self.segments())

    def named(self, name: str) -> List:
        return [s for s in self.spans if s.name == name]

    def segments(self):
        """(start_us, end_us, label) on the profiler's clock where each
        window span is the innermost, in order: ``sync`` or ``issue``."""
        kids: Dict[int, List[int]] = {}
        for i in self.index:
            p = self.all[i].parent
            if p is not None:
                kids.setdefault(p, []).append(i)

        def us(ns):
            return ns / 1e3 + self.offset_us

        out = []
        for i in self.index:
            s = self.all[i]
            label = "sync" if s.name == "sync" else "issue"
            cursor, end = us(s.start_ns), us(s.end_ns)
            # Children open in order, so their list is sorted by start.
            for k in kids.get(i, ()):
                c0, c1 = us(self.all[k].start_ns), us(self.all[k].end_ns)
                if c0 > cursor:
                    out.append((cursor, c0, label))
                cursor = max(cursor, c1)
            if end > cursor:
                out.append((cursor, end, label))
        out.sort()
        return out

    def issue_ms(self, name: str) -> List[float]:
        """Each ``name`` span's host milliseconds less those of the syncs
        inside it."""
        inside: Dict[int, int] = {}
        for i in self.index:
            s = self.all[i]
            if s.name == "sync":
                p = s.parent
                while p is not None:
                    inside[p] = inside.get(p, 0) + s.end_ns - s.start_ns
                    p = self.all[p].parent
        return [(self.all[i].end_ns - self.all[i].start_ns
                 - inside.get(i, 0)) / 1e6
                for i in self.index if self.all[i].name == name]

    def report(self) -> str:
        """One line of the clock fit and the idle split, in %."""
        line = (f"program spans: {self.solves} solves, {len(self.spans)} "
                f"spans; clock offset {self.offset_us!r} us, spread (IQR) "
                f"{self.spread_us!r} us, largest deviation "
                f"{self.largest_us!r} us")
        t = self.run.trace
        if self.idle_s is not None and t.window_s > 0:
            idle = 100.0 * (1.0 - t.busy_s / t.window_s)
            share = {k: 100.0 * v / t.window_s
                     for k, v in self.idle_s.items()}
            line += (f"; device_idle {idle!r} %: idle_sync "
                     f"{share['sync']!r}, idle_issue {share['issue']!r}, "
                     f"outside the program's spans (device_idle - "
                     f"idle_sync - idle_issue) "
                     f"{idle - share['sync'] - share['issue']!r}")
        return line


def _iqr(values) -> float:
    q = statistics.quantiles(values, n=4)
    return q[2] - q[0]


def idle_gaps(device, start_us: float, end_us: float):
    """(start_us, end_us) of each idle gap of the device inside the
    window: the complement of the union of its operations' intervals."""
    gaps, cursor = [], start_us
    for s, e in sorted((s, e) for _, s, e in device):
        if s > cursor:
            gaps.append((cursor, min(s, end_us)))
        cursor = max(cursor, e)
        if cursor >= end_us:
            break
    if cursor < end_us:
        gaps.append((cursor, end_us))
    return [(a, b) for a, b in gaps if b > a]


def split_idle(device, window, segments) -> Dict[str, float]:
    """Seconds of idle time inside ``window`` (start_us, end_us) by the
    label of the segment (start_us, end_us, label; sorted, disjoint) that
    overlaps it at each instant; ``other`` where none does."""
    out = {"sync": 0.0, "issue": 0.0, "other": 0.0}
    j = 0
    for g0, g1 in idle_gaps(device, *window):
        while j < len(segments) and segments[j][1] <= g0:
            j += 1
        covered, k = 0.0, j
        while k < len(segments) and segments[k][0] < g1:
            s0, s1, label = segments[k]
            overlap = min(g1, s1) - max(g0, s0)
            if overlap > 0:
                out[label] += overlap * 1e-6
                covered += overlap
            k += 1
        out["other"] += (g1 - g0 - covered) * 1e-6
    return out


def of(run) -> Optional[Window]:
    """The window's program spans of a traced run (computed once a run,
    and reported once on standard error), or None where there are
    none."""
    if "_program_window" not in vars(run):
        window = None
        spans = program_spans() if run.trace is not None else None
        if spans:
            try:
                window = Window(run, spans)
            except LookupError:
                window = None
        run._program_window = window
        if window is not None:
            print(window.report(), file=sys.stderr)
    return run._program_window


def mean(values) -> Optional[float]:
    values = list(values)
    return sum(values) / len(values) if values else None
