"""afterstate_eval_roofline.wildbg: The first layer's forward kernel in
its deep form (fc1 of each kept board, its activations written for the
dense layers): least time on its inputs over its summed device time, in
one traced update.
"""

from benchmark.yardstick import work


def read(r):
    return work.roofline_share(r, "train", "afterstate_hidden")
