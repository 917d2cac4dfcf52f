"""dense_layers_roofline.wildbg: The dense layers' least time (their
operations on the kept rows at the tensor cores' peak, or their bytes at
the memory's, whichever is larger) over their kernels' summed device
time, in one traced update.
"""

from benchmark.yardstick import work


def read(r):
    return work.roofline_share(r, "train", "dense_layers")
