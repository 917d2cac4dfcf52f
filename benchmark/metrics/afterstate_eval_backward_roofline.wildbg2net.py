"""afterstate_eval_backward_roofline.wildbg2net: The first layer's
backward kernels in their routed form (each network's dW1 and db1 from its
group's dpre): least time on their inputs over their summed device time,
in one traced update.
"""

from benchmark.yardstick import work


def read(r):
    if not r.get("routed"):
        return None
    return work.roofline_share(r, "train", "afterstate_hidden_backward")
