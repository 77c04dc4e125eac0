"""coarse_newton_ms: the device milliseconds per solve of the FAS tier's
dense Newton solve on the coarsest level over the traced window: the
CUDA-event times of the ``coarse`` spans whose ``kind`` is ``newton``
(``cycles.fas._coarsest``), summed and divided by the window's solves.
None where the program records no such span."""

import progspans


def read(run):
    w = progspans.of(run)
    if w is None:
        return None
    times = [s.device_ms for s in w.named("coarse")
             if s.attrs.get("kind") == "newton"]
    if not times or None in times:
        return None
    return sum(times) / w.solves
