"""kv_launches_per_kop: launches of the kv kernels (``KV_WINDOW.launches``)
in the window per thousand client ops settled in it: one window of W
full-width blocks is one launch, so this counts ops carried a launch."""


def read(run: dict):
    if "kv_launches" not in run or not run.get("settled_ops"):
        return None
    return run["kv_launches"] / (run["settled_ops"] / 1000.0)
