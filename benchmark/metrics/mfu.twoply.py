"""mfu.twoply: The MLP's operations in one decision over (the mean wall
time of the window's plies x the peak).
"""

from benchmark.yardstick import peaks


def read(r):
    if r.get("phase") != "twoply":
        return None
    return 100 * r["model_ops"] / (r["ply_wall_s"] * peaks.PEAK_OPS_PER_S)
