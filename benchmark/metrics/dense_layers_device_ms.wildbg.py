"""dense_layers_device_ms.wildbg: Device time of the dense layers of the
deep network, forward and backward: the union of the device intervals
launched inside the program's ``dense_layers`` and
``dense_layers_backward`` spans, in one traced update.
"""


def read(r):
    if "dense_layers_device_s" not in r:
        return None
    return 1e3 * r["dense_layers_device_s"]
