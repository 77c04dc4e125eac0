"""var_residual_ms: the device milliseconds per solve of the float64
compensated residual of the 3D flux stencil over the traced window: the
CUDA-event times of the ``residual`` spans whose ``path`` is ``var3``
(``precision.ds_residual_var3``), summed and divided by the window's
solves.  None where the program records no such span."""

import progspans


def read(run):
    w = progspans.of(run)
    if w is None:
        return None
    times = [s.device_ms for s in w.named("residual")
             if s.attrs.get("path") == "var3"]
    if not times or None in times:
        return None
    return sum(times) / w.solves
