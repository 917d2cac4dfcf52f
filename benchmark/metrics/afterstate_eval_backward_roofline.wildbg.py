"""afterstate_eval_backward_roofline.wildbg: The first layer's backward
kernels in their deep form (dW1 and db1 from the dense layers' dpre):
least time on their inputs over their summed device time, in one traced
update.
"""

from benchmark.yardstick import work


def read(r):
    return work.roofline_share(r, "train", "afterstate_hidden_backward")
