"""mfu.train: The MLP's operations in one update over (the mean wall time
of the window's updates x the peak).
"""

from benchmark.yardstick import peaks


def read(r):
    if r.get("phase") != "train":
        return None
    return 100 * r["model_ops"] / (r["step_wall_s"] * peaks.PEAK_OPS_PER_S)
