"""kv_roofline: the bytes the kv ops launched in the window need
(``pbench.roofline.kv_op_bytes``; the ops counted as their windows
launch) over the device time of the kv kernels in the trace
(``kv_dict.cu``, ``kv_window.cu``, ``kv_read.cu``), as a share of the
card's published peak rate."""

from pbench import roofline
from pbench.trace import kernel_seconds

KERNELS = ("kv_dict_kernel", "kv_window_kernel", "kv_read_kernel")


def read(run: dict):
    trace = run.get("trace")
    if not trace or "shape" not in run or "launched_set_ops" not in run:
        return None
    secs = sum(kernel_seconds(trace, k)[1] for k in KERNELS)
    per = roofline.kv_op_bytes(run["shape"]["key_bytes"], run["shape"]["value_bytes"])
    nbytes = run["launched_set_ops"] * per["set"] + run["launched_get_ops"] * per["get"]
    return roofline.share_pct(nbytes, secs)
