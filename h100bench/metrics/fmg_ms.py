"""fmg_ms: the device milliseconds per solve of full multigrid over the
traced window: the CUDA-event times of the window's outermost ``fmg``
spans (``cycles.fmg``, ``cycles.fas.fmg_fas``), summed and divided by the
window's solves.  None where the program records no such span."""

import progspans


def read(run):
    w = progspans.of(run)
    if w is None:
        return None
    times = [s.device_ms for s in w.named("fmg")
             if s.parent is None or w.all[s.parent].name != "fmg"]
    if not times or None in times:
        return None
    return sum(times) / w.solves
