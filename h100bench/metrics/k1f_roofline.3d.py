"""k1f_roofline.3d: the share of its roofline, in %, that K1f_3
(``kernels/fas3d.py`` ``fas_smooth_restrict3``, the Bratu instance)
reaches over the traced window (``roofline_fas3.share``): the least time
of its level visits, counted by the program's launch counters, against the
device time of its Bratu instances in the trace."""

from roofline_fas3 import share

KERNELS = ('smooth_restrict3_kernel',)
COUNTERS = ('fas_smooth_restrict3',)


def read(run):
    return share(run, KERNELS, COUNTERS, "nu1")
