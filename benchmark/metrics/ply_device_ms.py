"""ply_device_ms: Device time of one 2-ply self-play ply (the decision
over every game and the env step), the union of the CUDA intervals of
``traced_plies`` plies traced after the window with device activity
alone, over their number.  What the card itself spends on each B
decisions; the host's speed does not change it.
"""


def read(r):
    return 1e3 * r["ply_device_s"] if "ply_device_s" in r else None
