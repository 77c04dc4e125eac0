"""cycle_issue_ms: the mean host milliseconds of one finest-level cycle
over the traced window (cycles layer): each ``cycle`` span's duration on
the host clock, less any ``sync`` inside it (read under the profiler,
which adds its own cost to each operation issued)."""

import progspans


def read(run):
    w = progspans.of(run)
    return None if w is None else progspans.mean(w.issue_ms("cycle"))
