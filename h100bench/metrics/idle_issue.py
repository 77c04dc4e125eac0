"""idle_issue: the share of the traced window, in %, in which the card is
idle while the host is inside one of the program's spans other than a
``sync``: issuing the work of a solve (cycles, compensated adds and
residuals, the driver between them), split as in ``idle_sync``."""

import progspans


def read(run):
    w = progspans.of(run)
    if w is None or w.idle_s is None or run.trace.window_s <= 0:
        return None
    return 100.0 * w.idle_s["issue"] / run.trace.window_s
