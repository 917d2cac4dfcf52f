"""dense_layers_device_ms.wildbg2net: Device time of the dense layers of
both networks of the routed model, forward and backward: the union of the
device intervals launched inside the program's ``dense_layers`` and
``dense_layers_backward`` spans, which open inside each group's
``dense_layers.contact`` or ``dense_layers.race`` span, in one traced
update.
"""


def read(r):
    if not r.get("routed") or "dense_layers_device_s" not in r:
        return None
    return 1e3 * r["dense_layers_device_s"]
