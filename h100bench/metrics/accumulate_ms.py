"""accumulate_ms: the device milliseconds per solve of the compensated
accumulation over the traced window: the CUDA-event times of every
``accumulate`` span (``precision.ds_add`` and ``ts_add``, those inside
``cycle_ds`` too), summed and divided by the window's solves."""

import progspans


def read(run):
    w = progspans.of(run)
    if w is None:
        return None
    times = [s.device_ms for s in w.named("accumulate")]
    if not times or None in times:
        return None
    return sum(times) / w.solves
