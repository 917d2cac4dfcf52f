"""afterstate_eval_roofline.wildbg2net: The first layer's forward kernel
in its routed form (fc1 of each kept board with its own network's W1, a
launch a network): least time on its inputs over its summed device time,
in one traced update.
"""

from benchmark.yardstick import work


def read(r):
    if not r.get("routed"):
        return None
    return work.roofline_share(r, "train", "afterstate_hidden")
