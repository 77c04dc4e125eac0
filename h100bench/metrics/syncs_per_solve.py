"""syncs_per_solve: the host's blocking reads of device values per solve
over the traced window (drivers layer): the ``syncs`` the program counts
over each window ``solve`` span (``tpu_multigrid_torch.tracing``; one per
residual norm the refinement loop reads, one for the fixed-cycle
history), averaged."""

import progspans


def read(run):
    w = progspans.of(run)
    if w is None:
        return None
    return progspans.mean(r.attrs.get("syncs", 0) for r in w.roots)
