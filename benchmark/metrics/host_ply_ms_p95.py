"""host_ply_ms_p95: 95th percentile of every ply of the window, each timed
from its start to its synchronised end (decision and env step), in ms by
the host's clock.  Per layer, not end to end: the host paces this cell,
and its speed spreads runs of one tree by up to a fifth.
"""

import statistics


def read(r):
    if "ply_s" not in r:
        return None
    ms = sorted(1e3 * s for s in r["ply_s"])
    if len(ms) < 2:
        return ms[0]
    return statistics.quantiles(ms, n=100, method="inclusive")[94]
