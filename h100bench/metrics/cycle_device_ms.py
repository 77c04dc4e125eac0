"""cycle_device_ms: the mean device milliseconds of one finest-level cycle
over the traced window (cycles layer): the time between the CUDA events the
program records on the stream at the two edges of each ``cycle`` span, so
its kernels plus any time the card waits for the host to issue them."""

import progspans


def read(run):
    w = progspans.of(run)
    if w is None:
        return None
    times = [s.device_ms for s in w.named("cycle")]
    if not times or None in times:
        return None
    return progspans.mean(times)
