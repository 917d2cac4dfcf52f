"""afterstate_eval_roofline.twoply: The afterstate forward kernel's least
time (the min epilogue) over its summed device time, in one traced
decision.
"""

from benchmark.yardstick import work


def read(r):
    return work.roofline_share(r, "twoply", "afterstate_eval")
