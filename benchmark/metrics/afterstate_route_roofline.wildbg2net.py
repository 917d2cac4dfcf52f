"""afterstate_route_roofline.wildbg2net: The routed pass's class split
(``afterstate_route_kernel``: each kept board's class from its bytes, the
floors, each class's slots in order): its bytes at the memory's peak over
its summed device time, in one traced update.
"""

from benchmark.yardstick import work


def read(r):
    if not r.get("routed"):
        return None
    return work.roofline_share(r, "train", "afterstate_route")
