"""nondoubles_roofline.train: The nondoubles kernel's byte bound over its
summed device time, in one traced update.
"""

from benchmark.yardstick import work


def read(r):
    return work.roofline_share(r, "train", "nondoubles")
