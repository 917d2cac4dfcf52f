"""Port parity: the arena (``agents/arena.py``).

32 games for 300 plies with JAX's draws replayed into the port through
its key schedule (the reset, then per ply each side's uniforms and the
env's draws): ``ArenaResult`` must equal JAX's bit for bit.  The pubeval
side plays jittered heuristic weights (``test_torch_agents.
jittered_weights``), so that no two afterstates tie in exact arithmetic.
This file is apart from ``test_torch_agents.py`` so that the two run on
two test workers: each arena run is about 300 env steps on the CPU."""

import jax
import pytest
import torch

from mlp_ppo_2ply_p3_tpu.agents import arena as JA
from mlp_ppo_2ply_p3_tpu.agents import basic as JB
from mlp_ppo_2ply_p3_tpu.agents import pubeval as JP
from mlp_ppo_2ply_p3_tpu_torch.agents import arena as TA
from mlp_ppo_2ply_p3_tpu_torch.agents import basic as TB
from mlp_ppo_2ply_p3_tpu_torch.agents import pubeval as TP

from .test_torch_agents import JENV, TENV, jittered_weights
from .test_torch_utils import JaxArenaDraws


def _j_random(p, s, k):
    return JB.random_actions(s, k)


def _j_pubeval(w, s, k):
    return JP.pubeval_actions(w, s)


def _t_random(p, s, r):
    return TB.random_actions(s, r)


# name -> (JAX policy, port policy, (JAX params, port params))
PLAYERS = {"random": (_j_random, _t_random, lambda: (None, None)),
           "pubeval": (_j_pubeval, TP.pubeval_actions, jittered_weights)}


@pytest.mark.parametrize("pair", ["random:random", "pubeval:random"])
def test_arena_matches_jax_with_replayed_draws(pair):
    """32 games, 300 plies: ``ArenaResult`` equals JAX's bit for bit; where
    every game finishes, ``play_hostloop`` (early exit) equals ``play``."""
    games, plies = 32, 300
    (ja, ta, pa), (jb, tb, pb) = (PLAYERS[n] for n in pair.split(":"))
    (jpa, tpa), (jpb, tpb) = pa(), pb()
    key = jax.random.PRNGKey(0)
    want = JA.play_jit(ja, jpa, jb, jpb, key, JENV, games, plies)
    got = TA.play(ta, tpa, tb, tpb, JaxArenaDraws(key, plies), TENV, games,
                  plies, device="cpu")
    for name, g, w in zip(TA.ArenaResult._fields, got, want):
        assert g.dtype == torch.int32 and g.shape == ()
        assert int(g) == int(w), name
    assert TA.win_rate(got) == JA.win_rate(want)
    if pair == "pubeval:random":
        assert int(got.finished) == games   # so the early exit is taken
        host = TA.play_hostloop(ta, tpa, tb, tpb, JaxArenaDraws(key, plies),
                                TENV, games, plies, device="cpu")
        assert tuple(int(x) for x in host) == tuple(int(x) for x in got)
        assert TA.win_rate(got) > 0.75   # tests/test_agents.py:373-388


def test_arena_own_generator_and_device_rules(monkeypatch):
    """The port's own draws: a seeded generator reproduces its result;
    the run defaults to the card and never falls back to the CPU."""
    w = TP.heuristic_weights("cpu")
    runs = [TA.play(TP.pubeval_actions, w, _t_random, None,
                    torch.Generator().manual_seed(5), TENV, 8, 40,
                    device="cpu") for _ in range(2)]
    assert tuple(int(x) for x in runs[0]) == tuple(int(x) for x in runs[1])
    assert int(runs[0].plies) <= 8 * 40
    assert TA.play_jit is TA.play
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        TA.play(_t_random, None, _t_random, None, torch.Generator(), TENV, 4,
                1)
