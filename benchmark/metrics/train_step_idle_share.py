"""train_step_idle_share: 1 - (device time of a rollout + of an update) /
the mean wall time of the window's updates.
"""


def read(r):
    if r.get("phase") != "train":
        return None
    busy = r["rollout_device_s"] + r["update_device_s"]
    return 100 * (1 - busy / r["step_wall_s"])
