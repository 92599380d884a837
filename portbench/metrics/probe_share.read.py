"""probe_share.read: GET ops the read lane served off consensus (probe
windows, no slot) as a percentage of every GET the device lane served in
the window (``MeshEngine.read_lane_stats``: probe over probe + slot)."""


def read(run: dict):
    reads = run.get("reads")
    if not reads:
        return None
    total = reads["probe"] + reads["slot"]
    return 100.0 * reads["probe"] / total if total else None
