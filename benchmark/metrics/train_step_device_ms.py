"""train_step_device_ms: Device time of one whole update (rollout and
epochs), traced after the window with device activity alone: the union
of its CUDA intervals.  What the card itself spends on each B x T env
steps trained; the host's speed does not change it.
"""


def read(r):
    if "train_step_device_s" not in r:
        return None
    return 1e3 * r["train_step_device_s"]
