"""dense_layers_roofline.wildbg2net: The dense layers' least time (the
operations of the kept rows that each network received, at the tensor
cores' peak, or their bytes at the memory's, whichever is larger) over
their kernels' summed device time, both networks, in one traced update.
"""

from benchmark.yardstick import work


def read(r):
    if not r.get("routed"):
        return None
    return work.roofline_share(r, "train", "dense_layers")
