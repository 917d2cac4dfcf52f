"""The port's hand-written CUDA kernels and their wrappers
(``compaction``, ``doubles``, ``nondoubles``, ``afterstate``; built by
``build``)."""

# every kernel wrapper, in the order of the launch tuples
# (``agents.twoply.launches_per_decision``)
KERNELS = ("compact_rows", "dedup_compact_rows", "doubles_level",
           "nondoubles", "doubles_final", "afterstate_eval",
           "afterstate_eval_backward")


def counters() -> dict:
    """{kernel: the wrapper function that owns its ``launches`` count}, in
    ``KERNELS`` order."""
    from . import afterstate, compaction, doubles, nondoubles

    owners = {**compaction._COUNTERS, **doubles._COUNTERS,
              **nondoubles._COUNTERS, **afterstate._COUNTERS}
    return {name: owners[name] for name in KERNELS}


def launches() -> dict:
    """{kernel: launches counted so far}."""
    return {name: fn.launches for name, fn in counters().items()}


def zero_launches() -> None:
    for fn in counters().values():
        fn.launches = 0
