"""host_decisions_per_s: 2-ply game-decisions per second by the host's
clock: B x plies completed in the window (env steps included), over the
window's wall time.  Per layer, not end to end: the host paces this
cell, and its speed spreads runs of one tree by 12-18%.
"""


def read(r):
    return r["decisions"] / r["window_s"] if "decisions" in r else None
