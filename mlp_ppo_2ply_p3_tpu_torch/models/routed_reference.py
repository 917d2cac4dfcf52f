"""A plain reference of wildbg's whole evaluator, for the tests: two
networks of ``deep_reference.py``'s layers, one for contact positions and
one for races (github.com/carsten-wenderdel/wildbg: the engine's composite
evaluator picks a network by each position's game phase), written out in
float32 on a dict of weights, with no kernel, no cache and no batching:
every slot of every row goes through the network its board's class selects.

    race(position) = (player 0's rearmost point > player 1's rearmost point)

with player 0 moving up the points (0 to 23) and player 1 down, a checker
on the bar the rearmost of its side (player 0's at point -1, player 1's at
24), and a side with no checker on the board or the bar rearmost nowhere
(99 for player 0, -99 for player 1), so that it meets nothing.  It is written out here on the
features (``race_of_features``) and on canonical boards (``race_of_boards``),
apart from the port's ``core.features.is_race`` and ``core.board.is_race``.

The weights are ``MLP.named_parameters()`` without the ``layers.`` prefix:
the contact network's ("fc1.weight", ...) and the race network's under
``race_`` ("race_fc1.weight", ...).  The products are ``torch.matmul`` with
TF32 off (the caller's setting).

Departures from wildbg, as the configuration ``wildbg2net4096`` states:
(1) both networks take the port's 198 features, where wildbg gives its race
network race inputs of its own; (2) the value is p . r with the env's
rewards; (3) the score head is the afterstate policy; (4) a finished
afterstate, all 15 of the mover's checkers off, goes through the race
network, since the rule holds for it, where wildbg gives such a position
its exact outcome.
"""

from __future__ import annotations

import torch

from . import deep_reference as D

FLOOR = D.FLOOR
RACE = "race_"


def split(params) -> tuple:
    """(the contact network's weights, the race network's), each keyed as
    ``deep_reference``'s."""
    contact = {k: v for k, v in params.items() if not k.startswith(RACE)}
    race = {k[len(RACE):]: v for k, v in params.items()
            if k.startswith(RACE)}
    return contact, race


def _rear(mine, theirs, my_bar, their_bar):
    """The rule on each side's occupied points (..., 24), mine moving up."""
    idx = torch.arange(24, device=mine.device)
    lo = torch.full(mine.shape, 99, dtype=torch.long, device=mine.device)
    hi = torch.full(mine.shape, -99, dtype=torch.long, device=mine.device)
    my_rear = torch.where(mine, idx, lo).min(-1).values
    their_rear = torch.where(theirs, idx, hi).max(-1).values
    my_rear = torch.where(my_bar, torch.full_like(my_rear, -1), my_rear)
    their_rear = torch.where(their_bar, torch.full_like(their_rear, 24),
                             their_rear)
    return my_rear > their_rear


def race_of_features(x):
    """(..., 198) features -> (...,) bool: columns 4 i (player 0) and
    98 + 4 i (player 1) are n >= 1 on point i, 96 and 194 the bars."""
    return _rear(x[..., 0:96:4] > 0, x[..., 98:194:4] > 0, x[..., 96] > 0,
                 x[..., 194] > 0)


def race_of_boards(boards):
    """(..., 52) canonical boards -> (...,) bool: the mover's points are
    bytes 0-23 and move up, the opponent's 24-47, the bars 48 and 49."""
    return _rear(boards[..., 0:24] > 0, boards[..., 24:48] > 0,
                 boards[..., 48] > 0, boards[..., 49] > 0)


def _pick(race, c, r):
    return torch.where(race.reshape(race.shape + (1,) * (c.dim()
                                                         - race.dim())), r, c)


def value(params, x):
    contact, race = split(params)
    return _pick(race_of_features(x), D.value(contact, x), D.value(race, x))


def score(params, x):
    contact, race = split(params)
    return _pick(race_of_features(x), D.score(contact, x), D.score(race, x))


def logits(params, x):
    contact, race = split(params)
    return _pick(race_of_features(x), D.logits(contact, x),
                 D.logits(race, x))


def outcome_probs(params, x):
    contact, race = split(params)
    return _pick(race_of_features(x), D.outcome_probs(contact, x),
                 D.outcome_probs(race, x))


def afterstate(params, boards, mover, n, head, opponent=False,
               epilogue="logits", sign=1.0):
    """``deep_reference.afterstate`` with each slot's value from the network
    its board's class selects."""
    contact, race = split(params)
    ys = [D.afterstate(p, boards, mover, n, head, opponent, epilogue, sign)
          for p in (contact, race)]
    return torch.where(race_of_boards(boards), ys[1], ys[0])
