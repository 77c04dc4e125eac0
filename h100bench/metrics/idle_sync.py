"""idle_sync: the share of the traced window, in %, in which the card is
idle while the host is inside one of the program's ``sync`` spans (a
blocking read of a device value): the device's idle gaps split by overlap
with the innermost program span (``progspans``)."""

import progspans


def read(run):
    w = progspans.of(run)
    if w is None or w.idle_s is None or run.trace.window_s <= 0:
        return None
    return 100.0 * w.idle_s["sync"] / run.trace.window_s
