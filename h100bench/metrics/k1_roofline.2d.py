"""k1_roofline.2d: the share of its roofline, in %, that K1
(``kernels/transfer.py`` ``smooth_restrict``) reaches over the traced
window (``kernel_roofline.share``): the least time of its level visits,
counted by the program's launch counters, against the device time of its
kernel in the trace."""

from kernel_roofline import share

KERNELS = ('smooth_restrict_kernel',)
COUNTERS = ('smooth_restrict',)


def read(run):
    return share(run, 2, "k1", KERNELS, COUNTERS)
