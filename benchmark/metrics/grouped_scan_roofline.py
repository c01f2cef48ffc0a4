"""grouped_scan_roofline: the least time of the traced batches' list
scans (``counts.grouped_scan_work``) over the device time of the grouped
scan kernel (``csrc/ivf_scan_grouped.cu``, ``grouped_scan_*``) in them,
in percent."""

import re

from benchlib import counts

KERNEL = re.compile(r"grouped_scan")


def read(ctx):
    if ctx.trace is None:
        return None
    t_kernel = ctx.trace.kernel_seconds(KERNEL)
    works = ctx.traced_work("scan")
    if t_kernel <= 0 or not works:
        return None
    w = counts.add_work(works)
    return 100.0 * counts.least_seconds(w["bytes"], w["flops"])[0] / t_kernel
