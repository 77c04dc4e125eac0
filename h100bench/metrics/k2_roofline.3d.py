"""k2_roofline.3d: the share of its roofline, in %, that K2_3 and
K2_3-resnorm (``kernels/transfer3d.py`` ``prolong_smooth3``,
``prolong_smooth_resnorm3``) reach over the traced window
(``kernel_roofline.share``): the least time of their level visits, counted
by the program's launch counters, against the device time of their kernels
in the trace."""

from kernel_roofline import share

KERNELS = ('prolong_smooth3_kernel', 'sum_partials_kernel')
COUNTERS = ('prolong_smooth3', 'prolong_smooth_resnorm3')


def read(run):
    return share(run, 3, "k2", KERNELS, COUNTERS)
