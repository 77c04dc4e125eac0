"""k1_roofline.3d: the share of its roofline, in %, that K1_3
(``kernels/transfer3d.py`` ``smooth_restrict3``) reaches over the traced
window (``kernel_roofline.share``): the least time of its level visits,
counted by the program's launch counters, against the device time of its
kernel in the trace."""

from kernel_roofline import share

KERNELS = ('smooth_restrict3_kernel',)
COUNTERS = ('smooth_restrict3',)


def read(run):
    return share(run, 3, "k1", KERNELS, COUNTERS)
