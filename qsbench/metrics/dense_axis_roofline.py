"""dense_axis_roofline: the ``dense_axis`` launches' least time
(``roofline.py``) over their device time in the trace, percent."""

from qsbench.reduce import roofline_percent

LAUNCHES = True


def read(ctx):
    return roofline_percent(ctx, "dense_axis")
