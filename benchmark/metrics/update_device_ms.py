"""update_device_ms: Device time of one ppo_update on a rollout's output
(trainer step layer), traced on its own.
"""


def read(r):
    return 1e3 * r["update_device_s"] if "update_device_s" in r else None
