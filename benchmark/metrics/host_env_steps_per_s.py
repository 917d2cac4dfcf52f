"""host_env_steps_per_s: env steps trained per second by the host's clock:
B x T x whole updates completed in the window, over the window's wall
time.  Per layer, not end to end: the host paces these cells, and its
speed spreads runs of one tree by up to a quarter.
"""


def read(r):
    return r["env_steps"] / r["window_s"] if "env_steps" in r else None
