"""fused_window_roofline: ``fused_window.cu``'s replica-major kernel over the
traced window: the bytes each of its windows needs
(``pbench.roofline.fused_window_bytes``) times the kernel's device records,
over their device time, as a share of the card's published peak rate."""

from pbench import roofline
from pbench.trace import kernel_seconds


def read(run: dict):
    trace = run.get("trace")
    if not trace or "shape" not in run or "slots" not in run["shape"]:
        return None
    n, secs = kernel_seconds(trace, "fused_window_kernel")
    sh = run["shape"]
    return roofline.share_pct(n * roofline.fused_window_bytes(sh["replicas"], sh["slots"],
                                                              sh["shards"]), secs)
