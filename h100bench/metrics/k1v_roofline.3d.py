"""k1v_roofline.3d: the share of its roofline, in %, that K1v_3
(``kernels/vartransfer3d.py`` ``var_smooth_restrict3``, a z march) reaches
over the traced window (``roofline_var3.share``): the least time of its
level visits, counted by the program's launch counters, against the device
time of its var instances in the trace."""

from roofline_var3 import share

KERNELS = ('zmarch_smooth_restrict3_kernel',)
COUNTERS = ('var_smooth_restrict3',)


def read(run):
    return share(run, KERNELS, COUNTERS)
