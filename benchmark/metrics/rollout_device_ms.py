"""rollout_device_ms: Device time of one rollout (trainer step layer): the
union of its CUDA intervals, traced on its own.
"""


def read(r):
    return 1e3 * r["rollout_device_s"] if "rollout_device_s" in r else None
