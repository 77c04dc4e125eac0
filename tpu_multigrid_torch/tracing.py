"""Spans and counters inside the port's solve drivers.

Counters are always counted.  Besides the kernels' launch counters (a
``LAUNCHES`` dict in each kernel module, read by
``kernels.launch_counts()``), there is ``syncs``: the host's blocking
reads of device values made by the drivers, each through :func:`sync`.
:func:`counts` returns every counter in one dict.

Spans are recorded only while a ``torch.profiler`` session records (the
profiler's own enabled flag, as the JAX package's ``trace_annotate`` is
live only inside a profiling session).  Otherwise a span site costs one
flag test and returns a shared null context: no clock is read, no record
made, no CUDA event recorded.  The records stay in memory (up to
``BOUND``; past it they are dropped and counted in ``dropped``) and are
read by :func:`spans`.  Nothing here calls ``record_function``, NVTX or the
profiler: a host annotation would be mirrored onto the device's timeline
and read as device work.

The span sites:

* ``solve``: the root of each call of ``precision.solve_refined_ds``,
  ``solve_refined_ts``, ``cycles.solve_fixed``, ``solve_until_tol``,
  ``cycles.fas.fas_solve_fixed``, ``fas_solve_until_tol`` and
  ``fmg_fas``, and of each front door's solve (``api``: an FMG start
  and the driver after it are one request); a driver called inside
  another's root opens none; attributes ``iterations`` and ``syncs``, the
  syncs counted over it;
* ``cycle``: each finest-level cycle a driver runs (the FAS drivers'
  ``fas_cycle_with_norm`` too);
* ``accumulate``: each compensated add (attribute ``kind``: ``ds`` or
  ``ts``): on the card with kernels, each ``precision._accumulate`` call,
  one ``kernels.localref.comp_add_ext`` launch over all its addends;
  otherwise each ``precision.ds_add`` / ``ts_add``;
* ``residual``: each compensated residual (attribute ``path``: ``kernel``
  or ``plain``; ``var3`` for the 3D flux stencil's float64 one);
* ``coarse``: each coarsest-level solve of the FAS tier,
  ``cycles.fas._coarsest`` (attribute ``kind``: ``newton``, the dense
  Newton solve, or ``smooth``);
* ``fmg``: each full-multigrid pass, ``cycles.fmg`` (no root of its own:
  it starts another driver) and ``cycles.fas.fmg_fas``;
* ``sync``: each blocking read, through :func:`sync` (attribute ``what``).

``cycle``, ``accumulate``, ``residual``, ``coarse`` and ``fmg`` on CUDA
tensors also record a CUDA event on the current stream at each edge, which
gives the span's device time, ``device_ms``.  The drivers synchronise at
every ``sync``, so the events of the spans closed before one ``sync`` are
complete by the next: that one reads their times and frees the events for
reuse, before its own blocking read.  The rest are read by
:func:`spans`, after the caller has synchronised.

Recording costs the host time a solve's critical path may feel: the
records are kept as plain values in flat lists (which the garbage
collector does not walk) and the CUDA events are reused, so that a long
traced window keeps few live objects.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

from . import kernels

# Records kept between resets; later ones are dropped and counted.
BOUND = 1 << 20

# Blocking reads of device values made by the drivers (always counted).
syncs = 0
# Records dropped past BOUND since the last reset.
dropped = 0

# The records, one entry per span in each list, in the order they opened.
_name: List[str] = []
_start: List[int] = []
_end: List[Optional[int]] = []
_parent: List[Optional[int]] = []
_request: List[Optional[int]] = []
_attrs: List[tuple] = []
_device_ms: List[Optional[float]] = []
# Open spans (indices), innermost last.
_open: List[int] = []
# Event pairs by span index, of spans closed since the last sync
# (``_closed``) and before it (``_settled``: complete once that sync's
# read has returned, unless it read a CPU tensor).
_closed: Dict[int, tuple] = {}
_settled: Dict[int, tuple] = {}
# Events free for reuse, by device index.
_free: Dict[int, list] = {}
_requests = 0


@dataclasses.dataclass
class Span:
    """One recorded span.  ``start_ns`` and ``end_ns`` are
    ``time.perf_counter_ns()`` readings; ``parent`` is the index of the
    enclosing span in :func:`spans`, None at a root; ``request`` the id of
    the ``solve`` it belongs to, None outside any; ``device_ms`` the time
    between its two CUDA events, None where it records none."""

    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: Optional[int]
    request: Optional[int]
    attrs: dict
    device_ms: Optional[float] = None


class _Null:
    """The context of a span site while nothing is recorded."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NULL = _Null()


class _Recording:
    """The context of one recorded span."""

    __slots__ = ("index", "events", "syncs0")

    def __init__(self, index: int, events, syncs0: int):
        self.index, self.events, self.syncs0 = index, events, syncs0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        i = self.index
        if self.events is not None:
            self.events[1].record(self.events[2])
            _closed[i] = self.events
        if _name[i] == "solve":
            self.set(syncs=syncs - self.syncs0)
        _end[i] = time.perf_counter_ns()
        if _open and _open[-1] == i:
            _open.pop()
        return False

    def set(self, **attrs) -> None:
        i = self.index
        _attrs[i] = tuple({**dict(_attrs[i]), **attrs}.items())


def _event(device: int):
    free = _free.get(device)
    return free.pop() if free else torch.cuda.Event(enable_timing=True)


def _begin(name: str, like, attrs: dict):
    global dropped
    if len(_name) >= BOUND:
        dropped += 1
        return _NULL
    parent = _open[-1] if _open else None
    events = None
    if like is not None and like.is_cuda:
        dev = like.get_device()
        events = (_event(dev), _event(dev), torch.cuda.current_stream(dev))
    index = len(_name)
    _name.append(name)
    _start.append(time.perf_counter_ns())
    _end.append(None)
    _parent.append(parent)
    _request.append(_request[parent] if parent is not None else None)
    _attrs.append(tuple(attrs.items()))
    _device_ms.append(None)
    _open.append(index)
    if events is not None:
        events[0].record(events[2])
    return _Recording(index, events, syncs)


def span(name: str, like=None, **attrs):
    """A context manager that records the span ``name`` with ``attrs``
    while a profiler records.  ``like``: a tensor of the work inside; on a
    CUDA tensor the span records its device time too."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _begin(name, like, attrs)


def solve():
    """The root span of one driver call (``solve``), with a new request
    id; the null context inside another ``solve``.  ``.set(iterations=)``
    records the iterations; ``syncs`` is recorded on exit."""
    global _requests
    if not _profiler._is_profiler_enabled:
        return _NULL
    if any(_name[i] == "solve" for i in _open):
        return _NULL
    ctx = _begin("solve", None, {})
    if ctx is not _NULL:
        _requests += 1
        _request[ctx.index] = _requests
    return ctx


def _resolve(pairs: Dict[int, tuple], complete_only: bool) -> None:
    """Read the device times of event pairs (with ``complete_only``, of
    those whose end is complete) and free their events."""
    for i in list(pairs):
        start, end, stream = pairs[i]
        if complete_only and not end.query():
            continue
        _device_ms[i] = start.elapsed_time(end)
        _free.setdefault(stream.device_index, []).extend((start, end))
        del pairs[i]


def sync(t: torch.Tensor, what: str):
    """The host's blocking read of ``t``: ``t.item()`` for a 0-d tensor,
    else ``t.cpu()``; counted in ``syncs`` and recorded as a ``sync``
    span."""
    global syncs
    syncs += 1
    if _settled:
        _resolve(_settled, True)
    _settled.update(_closed)
    _closed.clear()
    with span("sync", what=what):
        return t.item() if t.dim() == 0 else t.cpu()


def spans() -> List[Span]:
    """The recorded spans, in the order they opened, with ``device_ms``
    read (call after synchronising the device)."""
    _settled.update(_closed)
    _closed.clear()
    _resolve(_settled, False)
    return [Span(*rec[:5], dict(rec[5]), rec[6]) for rec in zip(
        _name, _start, _end, _parent, _request, _attrs, _device_ms)]


def reset() -> None:
    """Drop every record and the ``dropped`` count."""
    global dropped
    for lst in (_name, _start, _end, _parent, _request, _attrs, _device_ms,
                _open):
        lst.clear()
    _closed.clear()
    _settled.clear()
    dropped = 0


def counts() -> dict:
    """Every counter: ``syncs`` and each kernel entry's launches."""
    return {"syncs": syncs, **kernels.launch_counts()}


def reset_counts() -> None:
    """Zero ``syncs`` and the kernels' launch counters."""
    global syncs
    syncs = 0
    kernels.reset_launch_counts()
