"""k2_roofline.2d: the share of its roofline, in %, that K2 and
K2-resnorm (``kernels/transfer.py`` ``prolong_smooth``,
``prolong_smooth_resnorm``) reach over the traced window
(``kernel_roofline.share``): the least time of their level visits, counted
by the program's launch counters, against the device time of their kernels
in the trace."""

from kernel_roofline import share

KERNELS = ('prolong_smooth_kernel', 'sum_partials_kernel')
COUNTERS = ('prolong_smooth', 'prolong_smooth_resnorm')


def read(run):
    return share(run, 2, "k2", KERNELS, COUNTERS)
