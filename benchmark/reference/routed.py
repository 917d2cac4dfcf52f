"""wildbg's whole evaluator as plain PyTorch, and PPO self-play with it.

Two networks of ``deep.py``'s layers (github.com/carsten-wenderdel/wildbg:
the engine's composite evaluator, a contact network and a race network,
each its training code's ``Network``), each position through the network
its class selects:

    race = player 0's rearmost point > player 1's rearmost point

player 0 moving up the points (0 to 23) and player 1 down, a checker on
the bar the rearmost of its side (player 0's at -1, player 1's at 24), a
side with no checker on the board or the bar rearmost nowhere (99 for
player 0, -99 for player 1).  Written out here on the 198 features (state
values) and on canonical boards (afterstate scores), where the mover moves
up and the opponent down; the class of a position is the same in either
frame.  The parameters are the contact network's (``deep.init``'s draws,
under ``deep.py``'s names), then the race network's (the same draws, under
``race_``), all before the first reset.

``Trainer`` is ``deep.Trainer`` with the routed network: the rollout, GAE,
the loss, the replay of the program's actions, the TF32 control, the
one-ulp nudge and ``ppo.py``'s planted faults, and two routing faults:
``all_contact`` (every position through the contact network) and
``swapped`` (each position through the other class's network).  Every slot
of every row goes through both networks; nothing of the port is imported.
"""

from __future__ import annotations

import torch

from . import deep
from . import ppo
from . import rules

RACE = "race_"
FAULTS = ppo.FAULTS + ("all_contact", "swapped")


def _rear(mine, theirs, my_bar, their_bar):
    idx = torch.arange(24, device=mine.device)
    my_rear = torch.where(mine, idx, 99).amin(-1)
    their_rear = torch.where(theirs, idx, -99).amax(-1)
    my_rear = torch.where(my_bar, -1, my_rear)
    their_rear = torch.where(their_bar, 24, their_rear)
    return my_rear > their_rear


def race_of_features(x):
    """(..., 198): columns 4 i and 98 + 4 i are player 0's and player 1's
    n >= 1 on point i, 96 and 194 their bars."""
    return _rear(x[..., 0:96:4] > 0, x[..., 98:194:4] > 0, x[..., 96] > 0,
                 x[..., 194] > 0)


def race_of_boards(boards):
    """(..., 52) canonical: the mover's points 0-23, the opponent's 24-47,
    their bars 48 and 49."""
    return _rear(boards[..., 0:24] > 0, boards[..., 24:48] > 0,
                 boards[..., 48] > 0, boards[..., 49] > 0)


def split(params):
    contact = {k: v for k, v in params.items() if not k.startswith(RACE)}
    race = {k[len(RACE):]: v for k, v in params.items()
            if k.startswith(RACE)}
    return contact, race


def _pick(race, contact_out, race_out, fault):
    if fault == "all_contact":
        return contact_out
    if fault == "swapped":
        race = ~race
    return torch.where(race, race_out, contact_out)


class Trainer(deep.Trainer):
    """``deep.Trainer`` with the routed network of ``cfg["model"]``."""

    def __init__(self, cfg, seed, device, precision="float32", follow=None,
                 fault=None, judged=None, nudge=False):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.cfg, self.p = cfg, cfg["ppo"]
        if not (self.p["use_gae"] and self.p["reward_perspective"] == "mover"
                and not self.p["reset_each_update"]):
            raise ValueError("the reference trains with mover-perspective "
                             "GAE and no reset between updates")
        self.mg = rules.Movegen(**cfg["movegen"])
        self.precision, self.fault = precision, fault
        self.follow = None if follow is None else list(follow)
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)
        m = cfg["model"]
        self.rewards = tuple(cfg["outcome_rewards"])
        widths = [m["hidden_size"], *m["trunk"]]
        contact = deep.init(self.gen, widths, m["action_size"],
                            len(self.rewards), device)
        race = deep.init(self.gen, widths, m["action_size"],
                         len(self.rewards), device)
        self.params = {**contact, **{RACE + k: v for k, v in race.items()}}
        if nudge:   # every weight one float32 ulp up: rounding's own drift
            self.params = {k: torch.nextafter(v, torch.full_like(v, 1e30))
                           for k, v in self.params.items()}
        self.names = list(self.params)
        self.mu = [torch.zeros_like(v) for v in self.params.values()]
        self.nu = [torch.zeros_like(v) for v in self.params.values()]
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        self.episodes = torch.zeros((), dtype=torch.int32, device=device)
        self.state = rules.reset(self.gen, self.p["num_envs"], self.mg)
        self.actions, self.action_gap, self.half_turns = [], 0.0, 0
        self.judged = judged
        self.first = None
        self.afterstate = self.p["policy_mode"] == "afterstate"

    def _value(self, params, x, precision):
        contact, race = split(params)
        return _pick(race_of_features(x),
                     deep.value(contact, x, self.rewards, precision),
                     deep.value(race, x, self.rewards, precision),
                     self.fault)

    def _logits(self, obs, after, turn, n):
        """(masked logits (B, M), value (B,))."""
        pr, m = self.precision, self.mg.max_moves
        val = self._value(self.params, obs, pr)
        contact, race = split(self.params)
        if self.afterstate:
            mover = turn.to(torch.int32)
            score = _pick(race_of_boards(after),
                          deep.board_score(contact, after, mover, pr),
                          deep.board_score(race, after, mover, pr),
                          self.fault)
            return torch.where(ppo._prefix_mask(n, m), score, ppo.FLOOR), val
        feats = race_of_features(obs)[:, None]
        out = _pick(feats, deep.head(contact, deep.hidden(contact, obs, pr),
                                     "action", pr),
                    deep.head(race, deep.hidden(race, obs, pr), "action", pr),
                    self.fault)
        return torch.where(ppo._prefix_mask(n, m), out[:, :m],
                           ppo.FLOOR), val

    @torch.no_grad()
    def _rollout(self):
        # ppo.Trainer's rollout bootstraps with model.value: the routed
        # value for the call
        saved = ppo.Mdl.value
        ppo.Mdl.value = lambda params, x, precision="float32": self._value(
            params, x, precision)
        try:
            return ppo.Trainer._rollout(self)
        finally:
            ppo.Mdl.value = saved
