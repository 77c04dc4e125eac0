"""k2f_roofline.3d: the share of its roofline, in %, that K2f_3 and
K2f_3-resnorm (``kernels/fas3d.py`` ``fas_prolong_smooth3``,
``fas_prolong_smooth_resnorm3``, the Bratu instances) reach over the
traced window (``roofline_fas3.share``): the least time of their level
visits, counted by the program's launch counters, against the device time
of their Bratu instances in the trace."""

from roofline_fas3 import share

KERNELS = ('prolong_smooth3_kernel',)
COUNTERS = ('fas_prolong_smooth3', 'fas_prolong_smooth_resnorm3')


def read(run):
    return share(run, KERNELS, COUNTERS, "nu2")
