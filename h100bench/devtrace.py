"""Reduce a torch.profiler trace of the measured window to what the per-layer
readers take: the device's operations with their times, the busy time, and
the host's operations, by which the idle gaps are named.

:func:`busy_us` and :func:`short_name` are frozen copies of
``profile_vcycle.py`` lines 81-96 (the union of kernel intervals, and a
kernel's name without its return type and arguments).
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple


# The prefix of the harness's own host spans (``torch.profiler.
# record_function``) around each call into the program.
SPAN_PREFIX = "h100bench."


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def short_name(name):
    """A kernel's name without its return type and argument list."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0][:80]


def base_name(name: str) -> str:
    """A kernel's identifier: its short name without template arguments or
    a namespace (``smooth_restrict_kernel`` from ``void (anonymous
    namespace)::smooth_restrict_kernel<3>(float const*, ...)``)."""
    return short_name(name).split("<")[0].split("::")[-1]


@dataclasses.dataclass
class Trace:
    """What a traced window gives the per-layer readers.

    ``device``: (name, start_us, end_us) of every operation on the card
    (kernels, copies, fills); ``host``: the same for the host's operations
    (torch ops, runtime calls, the harness's spans); ``window_s``: the
    traced window on the host clock; ``launches``: the program's launch
    counters over the window.
    """

    device: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    window_s: float
    launches: Dict[str, int]

    @property
    def busy_s(self) -> float:
        return busy_us([(s, e) for _, s, e in self.device]) * 1e-6

    def seconds_of(self, names) -> float:
        """Device seconds of the kernels whose identifier is in ``names``."""
        return sum(e - s for n, s, e in self.device
                   if base_name(n) in names) * 1e-6


def events(prof):
    """(device, host) events of a finished ``torch.profiler.profile``, as
    (name, start_us, end_us), from the Kineto results directly (the
    profiler's own event tree is slow to build at this size)."""
    from torch.autograd import DeviceType
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() / 1e3
        item = (e.name(), s, s + e.duration_ns() / 1e3)
        if e.device_type() == DeviceType.CUDA:
            # The harness's spans are mirrored onto the device's timeline
            # as annotations; they are not work on the card.
            if not e.name().startswith(SPAN_PREFIX):
                device.append(item)
        elif e.device_type() == DeviceType.CPU:
            host.append(item)
    return device, host


def idle_gaps(device, host, start_us: float, end_us: float):
    """The device's idle gaps inside [start_us, end_us], each named by the
    innermost host operation running at its middle ("host, between
    operations" where none is): a list of (name, seconds)."""
    busy = sorted((s, e) for _, s, e in device)
    gaps, cursor = [], start_us
    for s, e in busy:
        if s > cursor:
            gaps.append((cursor, min(s, end_us)))
        cursor = max(cursor, e)
        if cursor >= end_us:
            break
    if cursor < end_us:
        gaps.append((cursor, end_us))
    host_sorted = sorted(host, key=lambda h: h[1])
    starts = [h[1] for h in host_sorted]
    spans = [h for h in host_sorted if h[0].startswith(SPAN_PREFIX)]
    span_starts = [h[1] for h in spans]
    out = []
    for g0, g1 in gaps:
        if g1 <= g0:
            continue
        mid = 0.5 * (g0 + g1)
        # Host operations last far less than the window: the innermost one
        # at the middle is among the last few that started before it.  The
        # harness's own spans are long, and are looked up on their own.
        i = bisect.bisect_right(starts, mid)
        name = _innermost(host_sorted[max(0, i - 64):i], mid)
        if name is None:
            j = bisect.bisect_right(span_starts, mid)
            name = _innermost(spans[:j], mid)
        out.append((name or "host, between operations", (g1 - g0) * 1e-6))
    return out


def _innermost(candidates, t: float) -> Optional[str]:
    best: Optional[Tuple[str, float, float]] = None
    for name, s, e in candidates:
        if s <= t <= e and (best is None or e - s < best[2] - best[1]):
            best = (name, s, e)
    return best[0] if best else None


def window_span(host):
    """(start_us, end_us) of the harness's window span on the profiler's
    clock."""
    for name, s, e in host:
        if name == SPAN_PREFIX + "window":
            return s, e
    raise ValueError("the trace holds no window span")


def breakdown(trace: Trace, top: int = 10):
    """The device operations that took the most time, and the idle time by
    what the host was doing, each summed by name: the ``breakdown`` of the
    result line."""
    start_us, end_us = window_span(trace.host)
    ops: Dict[str, float] = {}
    for n, s, e in trace.device:
        key = short_name(n)
        ops[key] = ops.get(key, 0.0) + (e - s) * 1e-6
    gaps: Dict[str, float] = {}
    for name, secs in idle_gaps(trace.device, trace.host, start_us, end_us):
        gaps[name] = gaps.get(name, 0.0) + secs
    order = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
    gorder = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in order],
            "idle_gaps": [[k, v] for k, v in gorder]}
