"""What a routed model's pass needs (``ops/afterstate.py::afterstate_routed``
of the port: wildbg's contact and race networks, each kept board through
the network its class selects), on its actual inputs, held to
``work.py``'s yardstick and ``deep_work.py``'s rules, each kept board's
work counted once, on its own network:

- the route (the class split): each row's n read once, each kept board's
  52 bytes read once, the floor of each slot not kept, each kept board's
  slot and each row's two counts written once; bytes alone;
- each group's first layer and dense layers: ``deep_work``'s counts over
  that group's kept boards, each group reading its own network's weights.

The class is ``reference/routed.py``'s rule.  The model's operations in
one update are ``deep_work.model_ops``'s: both networks have the same
widths, so a row costs the same whichever it goes through.  The device
time launched inside the dense spans, of both groups and of each, is
``deep_work.span_seconds``'s over ``DENSE_SPANS`` and over each of
``GROUP_SPANS``.
"""

from __future__ import annotations

from ..reference import routed as ref_routed
from . import deep_work, work

# the spans a routed pass adds around each group's dense calls
GROUP_SPANS = ("dense_layers.contact", "dense_layers.race")
DENSE_SPANS = ("dense_layers", "dense_layers_backward")


def groups(boards, n, epilogue):
    """[(contact kept mask, race kept mask)] (R, M) of one pass."""
    r, m, _ = boards.shape
    kept = work._kept(n, m, epilogue)
    race = ref_routed.race_of_boards(boards)
    return kept & ~race, kept & race


def route_bytes(boards, n, epilogue):
    """Bytes of one route call over (R, M, 52) ``boards``."""
    r, m, _ = boards.shape
    n_kept = int(work._kept(n, m, epilogue).sum())
    return 4 * r + n_kept * (52 + 4) + 4 * (r * m - n_kept) + 8 * r


def hidden(boards, mask, h, backward=False):
    """(bytes, operations, kept boards, their non-zero features) of one
    group's first layer: ``deep_work.hidden``'s counts over ``mask``, the
    floors (the route's) left out."""
    r, _, _ = boards.shape
    n_kept = int(mask.sum())
    n_feat = int((work._nnz(boards) * mask).sum())
    params = 198 * h + h
    ops = 2 * n_feat * h + 2 * n_kept * h
    if backward:
        return n_kept * (52 + 4 * h) + 8 * r + 4 * params, ops, n_kept, \
            n_feat
    return n_kept * (52 + 4 * h + 4) + 8 * r + 4 * params, ops, n_kept, \
        n_feat


def pass_work(boards, n, epilogue, widths, heads, backward):
    """{kernel: (bytes, operations)} of one routed pass's forward (and its
    backward), both groups summed, and (contact, race) kept boards."""
    out = {"afterstate_route": [route_bytes(boards, n, epilogue), 0],
           "afterstate_hidden": [0, 0], "afterstate_hidden_backward": [0, 0],
           "dense_layers": [0, 0]}
    rows = []
    for mask in groups(boards, n, epilogue):
        got = hidden(boards, mask, widths[0])
        out["afterstate_hidden"] = [a + b for a, b in
                                    zip(out["afterstate_hidden"], got[:2])]
        rows.append(got[2])
        d = deep_work.dense(got[2], widths, heads)
        if backward:
            back = hidden(boards, mask, widths[0], True)
            out["afterstate_hidden_backward"] = [
                a + b for a, b in zip(out["afterstate_hidden_backward"],
                                      back[:2])]
            d2 = deep_work.dense(got[2], widths, heads, True)
            d = [a + b for a, b in zip(d, d2)]
        out["dense_layers"] = [a + b for a, b in
                               zip(out["dense_layers"], d)]
    return out, rows
