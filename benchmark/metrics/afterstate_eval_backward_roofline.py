"""afterstate_eval_backward_roofline: The afterstate backward kernel's
least time on its inputs over its summed device time, in one traced
update.
"""

from benchmark.yardstick import work


def read(r):
    return work.roofline_share(r, "train", "afterstate_eval_backward")
