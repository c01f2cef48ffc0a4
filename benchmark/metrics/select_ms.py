"""select_ms: device milliseconds a batch in sort and top-k kernels
(``torch.sort``, ``torch.topk`` and the CUB sorts under them: the coarse
top-nprobe, ``merge_partials``' sort, ``chunked_knn``'s selection), by
kernel name, over the traced batches."""

import re

SELECT = re.compile(r"(?i)sort|topk|kthvalue")


def read(ctx):
    if ctx.trace is None:
        return None
    s = ctx.trace.kernel_seconds(SELECT)
    return 1e3 * s / ctx.traced_batches if s > 0 else None
