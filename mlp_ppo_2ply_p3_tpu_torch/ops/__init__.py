"""The port's hand-written CUDA kernels and their wrappers
(``compaction``, ``doubles``, ``nondoubles``, ``afterstate``, ``dense``,
``adam``; built by ``build``)."""

# every kernel wrapper, in the order of the launch tuples
# (``agents.twoply.launches_per_decision``)
KERNELS = ("compact_rows", "doubles_level", "nondoubles", "doubles_final",
           "afterstate_eval", "afterstate_eval_backward")
# the optimizer's wrapper (``adam.adam_update``): counted and zeroed with
# the others under this key, its calls (one kernel pair each), but not one
# of ``KERNELS``, whose tuples no 2-ply decision extends
OPTIMIZER = "adam_update"
# a deep network's pass (``afterstate.afterstate_deep``): fc1 in the
# afterstate kernels' deep forms, then the dense layers; a routed model's
# (``afterstate.afterstate_routed``) adds the route, and runs the others
# once a group; counted and zeroed with the others, outside ``KERNELS`` too
DEEP = ("afterstate_hidden", "afterstate_hidden_backward", "dense_layers",
        "dense_layers_backward", "afterstate_route")


def counters() -> dict:
    """{kernel: the wrapper function that owns its ``launches`` count}, in
    ``KERNELS`` order, then the optimizer's under ``OPTIMIZER``, then the
    deep pass's, ``DEEP``."""
    from . import adam, afterstate, compaction, dense, doubles, nondoubles

    owners = {**compaction._COUNTERS, **doubles._COUNTERS,
              **nondoubles._COUNTERS, **afterstate._COUNTERS,
              **dense._COUNTERS}
    return {**{name: owners[name] for name in KERNELS},
            OPTIMIZER: adam.adam_update,
            **{name: owners[name] for name in DEEP}}


def launches() -> dict:
    """{kernel: launches counted so far; ``OPTIMIZER``: its calls; the
    ``DEEP`` wrappers' calls}."""
    return {name: fn.launches for name, fn in counters().items()}


def zero_launches() -> None:
    """Zero every count, the routed pass's tally of kept boards
    (``afterstate.routed_rows``) and the tally of whole rows
    (``afterstate.collapsed_rows``)."""
    from . import afterstate

    for fn in counters().values():
        fn.launches = 0
    afterstate.zero_routed_rows()
    afterstate.zero_collapsed_rows()
