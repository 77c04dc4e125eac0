"""k2v_roofline.3d: the share of its roofline, in %, that K2v_3 and
K2v_3-resnorm (``kernels/vartransfer3d.py`` ``var_prolong_smooth3``,
``var_prolong_smooth_resnorm3``) reach over the traced window
(``roofline_var3.share``): the least time of their level visits, counted
by the program's launch counters, against the device time of their var
instances in the trace."""

from roofline_var3 import share

KERNELS = ('prolong_smooth3_kernel',)
COUNTERS = ('var_prolong_smooth3', 'var_prolong_smooth_resnorm3')


def read(run):
    return share(run, KERNELS, COUNTERS)
