"""movegen_device_ms: Device time of one legal_afterstates_batch call on
the cell's B games, from a replayed CUDA graph.
"""


def read(r):
    return 1e3 * r["movegen_device_s"] if "movegen_device_s" in r else None
