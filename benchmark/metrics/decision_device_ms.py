"""decision_device_ms: Device time of one 2-ply decision: the union of its
CUDA intervals.
"""


def read(r):
    return 1e3 * r["decision_device_s"] if "decision_device_s" in r else None
