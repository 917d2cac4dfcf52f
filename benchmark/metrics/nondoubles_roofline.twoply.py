"""nondoubles_roofline.twoply: The nondoubles kernel's byte bound over its
summed device time, in one traced decision's reply sweep.
"""

from benchmark.yardstick import work


def read(r):
    return work.roofline_share(r, "twoply", "nondoubles")
