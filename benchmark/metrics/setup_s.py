"""setup_s: Set-up time: process start to the window's start (imports, CUDA
context, the built kernels, weights, warm-up, the checked first updates
or ply).
"""


def read(r):
    return r["setup_s"]
