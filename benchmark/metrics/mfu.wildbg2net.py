"""mfu.wildbg2net: The routed model's operations in one update (the
``model_ops`` rule, each row counted once, on the network its class
selects) over (the mean wall time of the window's updates x the peak).
"""

from benchmark.yardstick import peaks


def read(r):
    if r.get("phase") != "train" or not r.get("routed"):
        return None
    return 100 * r["model_ops"] / (r["step_wall_s"] * peaks.PEAK_OPS_PER_S)
