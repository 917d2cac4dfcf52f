"""decision_idle_share: 1 - device time of one ply (decision and env step)
/ the mean wall time of the window's plies.
"""


def read(r):
    if r.get("phase") != "twoply":
        return None
    return 100 * (1 - r["ply_device_s"] / r["ply_wall_s"])
