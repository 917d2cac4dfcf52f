"""Port parity: 2-ply expectimax (``agents/twoply.py``).

At ``ModelConfig(action_size=128, hidden_size=32)`` and
``MovegenConfig(max_moves=128)``, as ``tests/test_agents.py``.  The JAX
side runs compiled.  Tolerances: reply minima and backup scores 1e-5
(float32 value heads summed in another order); actions are compared
where the best candidate's 2-ply score leads the second's by more than
1e-4; overflow flags exactly.  Chunking is held to identical outputs:
the min and the roll sums are per candidate, so a chunk size changes
only which rows share a launch."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlp_ppo_2ply_p3_tpu.agents import twoply as JT
from mlp_ppo_2ply_p3_tpu.core import dice as JD
from mlp_ppo_2ply_p3_tpu.core import movegen as JMG
from mlp_ppo_2ply_p3_tpu.core import oracle
from mlp_ppo_2ply_p3_tpu.env import bg_env as JE
from mlp_ppo_2ply_p3_tpu.models import mlp as JMLP
from mlp_ppo_2ply_p3_tpu.utils.config import SearchConfig as JSearchConfig
from mlp_ppo_2ply_p3_tpu_torch.agents import twoply as TT
from mlp_ppo_2ply_p3_tpu_torch.core import movegen as TMG
from mlp_ppo_2ply_p3_tpu_torch.env import bg_env as TE
from mlp_ppo_2ply_p3_tpu_torch.ops import compaction as TC
from mlp_ppo_2ply_p3_tpu_torch.utils import convert
from mlp_ppo_2ply_p3_tpu_torch.utils.config import SearchConfig, get_preset

from .test_agents import np_afterstate_values, np_forward_value
from .test_features import ref_features_np
from .test_movegen import canonical_to_abs_np
from .test_torch_utils import nn_, split_abs, tt

M = 128
JENV = JE.EnvConfig(movegen=JMG.MovegenConfig(max_moves=M))
TENV = TE.EnvConfig(movegen=TMG.MovegenConfig(max_moves=M))
JMODEL = JMLP.ModelConfig(action_size=M, hidden_size=32)


def models(seed=1):
    params = jax.tree_util.tree_map(
        np.asarray, JMLP.init_params(jax.random.PRNGKey(seed), JMODEL))
    return (jax.tree_util.tree_map(jnp.asarray, params),
            convert.params_from_jax(params, device="cpu"))


def both_states(seed, n):
    """n oracle positions ("any" stage), random movers and dice, as a
    JAX and a port ``EnvState``."""
    rng = np.random.default_rng(seed)
    boards = np.stack([oracle.random_board(rng, "any") for _ in range(n)])
    turn = rng.integers(0, 2, n).astype(np.int8)
    dice = rng.integers(1, 7, (n, 2)).astype(np.int8)
    arrays = (*split_abs(boards), turn, dice)
    return (JE.make_state(*(jnp.asarray(x) for x in arrays), JENV),
            TE.make_state(*(tt(x) for x in arrays), TENV))


def scfgs(**kw):
    return JSearchConfig(**kw), SearchConfig(**kw)


@pytest.mark.parametrize("width", [128, 481, 482, 512])
def test_reply_cfg_matches_jax(width):
    j, t = scfgs(reply_max_moves=width)
    assert dataclasses.asdict(TT._reply_cfg(t)) == dataclasses.asdict(
        JT._reply_cfg(j))
    assert TT._reply_cfg(t).dedup is (width < 482)


def test_chance_split_and_preset():
    assert TT._DBL_IDX == JT._DBL_IDX and TT._ND_IDX == JT._ND_IDX
    rolls = np.asarray(JD.ROLLS_21)
    assert all(rolls[i, 0] == rolls[i, 1] for i in TT._DBL_IDX)
    search = get_preset("twoply").search
    assert (search.top_k, search.reply_max_moves) == (8, 512)


@pytest.mark.parametrize("slot_chunk", [32, 48, 128])
def test_masked_min_values_matches_jax(slot_chunk):
    """Reply lists of a 5-3 at the 2-ply reply widths (the port's
    movegen, held to JAX's in test_torch_movegen.py), some games without
    replies, and a slot chunk that needs padding."""
    jp, model = models(2)
    _, ts = both_states(5, 24)
    us = np.random.default_rng(0).integers(0, 2, 24).astype(np.int8)
    rcfg = TT._reply_cfg(SearchConfig(reply_max_moves=M))
    full = lambda d: torch.full((24,), d, dtype=torch.int32)
    boards, n, _ = TMG.nondoubles_afterstates_batch(ts.after[:, 0], full(5),
                                                    full(3), rcfg)
    boards = nn_(boards)
    n = np.where(np.arange(24) % 7 == 3, 0, nn_(n)).astype(np.int32)
    want = jax.jit(JT._masked_min_values, static_argnums=(4, 5))(
        jp, jnp.asarray(boards), jnp.asarray(n), jnp.asarray(us), JMODEL,
        slot_chunk)
    got = TT._masked_min_values(model, tt(boards), tt(n), tt(us), slot_chunk)
    np.testing.assert_allclose(nn_(got), np.asarray(want), atol=1e-5)
    assert (nn_(got)[n == 0] == TT.POS_INF).all()


def _margin_ok(model, ts, scfg):
    """Games whose best 2-ply score leads the second's by > 1e-4."""
    _, score2, _ = TT.candidate_scores(model, ts, scfg)
    top2 = torch.topk(score2, 2, dim=1).values
    return nn_(top2[:, 0] - top2[:, 1] > 1e-4)


@pytest.mark.parametrize("width", [128, 512])
def test_twoply_values_match_jax(width):
    jp, model = models(1)
    js, ts = both_states(11, 8)
    j_scfg, t_scfg = scfgs(top_k=8, reply_max_moves=width)
    ja, jv, jo = jax.jit(JT.twoply_actions_values, static_argnums=(2, 3))(
        jp, js, JMODEL, j_scfg)
    ta, tv, to = TT.twoply_actions_values(model, ts, t_scfg)
    np.testing.assert_array_equal(nn_(to), np.asarray(jo))
    np.testing.assert_allclose(nn_(tv), np.asarray(jv), atol=1e-5)
    clear = _margin_ok(model, ts, t_scfg) & (nn_(ts.n_moves) > 1)
    assert clear.sum() >= 4
    np.testing.assert_array_equal(nn_(ta)[clear], np.asarray(ja)[clear])
    assert ta.dtype == torch.int32
    np.testing.assert_array_equal(
        nn_(TT.twoply_actions(model, ts, t_scfg)), nn_(ta))
    a2, o2 = TT.twoply_actions_report(model, ts, t_scfg)
    assert torch.equal(a2, ta) and torch.equal(o2, to)


@pytest.mark.parametrize("chunk", [3, 7, "full"])
def test_chunking_gives_identical_outputs(chunk):
    _, model = models(3)
    _, ts = both_states(13, 3)
    base = SearchConfig(top_k=4, reply_max_moves=M)
    c = 10**6 if chunk == "full" else chunk
    chunked = dataclasses.replace(base, game_chunk=c, dbl_game_chunk=c,
                                  eval_slot_chunk=c)
    want = TT.twoply_actions_values(model, ts, base)
    got = TT.twoply_actions_values(model, ts, chunked)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("width,chunk", [(128, 5), (512, 4), (512, 2048)])
def test_launches_per_decision(monkeypatch, width, chunk):
    """The wrappers' calls of one decision, counted on the CPU, equal the
    formula that ``chip_smoke.py`` holds the card's launches to."""
    _, model = models(4)
    _, ts = both_states(17, 2)
    calls = {"compact": 0, "dedup": 0}

    def counted(name, fn):
        def wrapper(*args):
            calls[name] += 1
            return fn(*args)
        return wrapper

    monkeypatch.setattr(TC, "compact_rows",
                        counted("compact", TC.compact_rows_plain))
    monkeypatch.setattr(TC, "dedup_compact_rows",
                        counted("dedup", TC.dedup_compact_rows_plain))
    scfg = SearchConfig(top_k=4, reply_max_moves=width, game_chunk=chunk,
                        dbl_game_chunk=chunk)
    TT.twoply_actions_values(model, ts, scfg)
    assert (calls["compact"], calls["dedup"]) == TT.launches_per_decision(
        2, scfg)
    # B=256 at the JAX package's chunks: 1 x 15 x 2 + 4 x 6 x 4, no
    # dedup; at the port's, the doubles leg is one chunk: 30 + 1 x 6 x 4
    jax_chunks = SearchConfig(game_chunk=2048, dbl_game_chunk=512)
    assert TT.launches_per_decision(256, jax_chunks) == (126, 0)
    assert TT.launches_per_decision(256, SearchConfig()) == (54, 0)


def test_twoply_matches_bruteforce():
    """The port's 2-ply candidate scores equal a brute-force oracle
    expectimax with the same value function (tests/test_agents.py:90-157
    run against the port)."""
    rng = np.random.default_rng(11)
    jp, model = models(1)
    params = jax.tree_util.tree_map(np.asarray, jp)
    scfg = SearchConfig(top_k=4, reply_max_moves=M)
    rolls = np.asarray(JD.ROLLS_21)
    probs = np.asarray(JD.ROLL_PROBS_21)
    checked = 0
    for _ in range(12):
        ob = oracle.random_board(rng, "any")
        turn = int(rng.integers(0, 2))
        dice = (int(rng.integers(1, 7)), int(rng.integers(1, 7)))
        arrays = (*split_abs(ob[None]), np.array([turn], np.int8),
                  np.array([dice], np.int8))
        ts = TE.make_state(*(tt(x) for x in arrays), TENV)
        n = int(ts.n_moves[0])
        if n == 0:
            continue
        action, backup, _ = TT.twoply_actions_values(model, ts, scfg)
        action, backup = int(action[0]), float(backup[0])
        assert 0 <= action < n

        def our_value(after_abs):
            feats = ref_features_np(after_abs, turn)[None]
            return float(np_forward_value(params, feats)[0])

        def two_ply_score(after_abs):
            total = 0.0
            for r, p in zip(rolls, probs):
                replies = oracle.full_moves(after_abs, 1 - turn,
                                            tuple(int(x) for x in r))
                worst = (min(our_value(b) for b, _ in replies) if replies
                         else our_value(after_abs))
                total += p * worst
            return total

        v1 = np_afterstate_values(params, ts, turn, n)
        top_idx = np.argsort(-v1)[:min(scfg.top_k, n)]
        scores = {int(i): two_ply_score(canonical_to_abs_np(
            nn_(ts.after[0, int(i)]), turn)) for i in top_idx}
        best = max(scores, key=scores.get)
        assert scores[best] - scores.get(action, -np.inf) <= 1e-4
        assert abs(backup - scores[action]) < 5e-4
        checked += 1
    assert checked >= 5


def test_overflow_reported_on_combinatorial_blowup():
    """15 singleton checkers with open destinations on double 1s admit
    about 3060 afterstates: the reply movegen saturates at 512 and says
    so, and a 2-ply decision whose replies meet that position reports it
    (tests/test_agents.py:325-344)."""
    vec = np.zeros(52, np.int8)
    vec[0:15] = 1          # mover: 15 singletons on points 0..14
    vec[24 + 23] = 15      # opponent: stacked out of the way
    rcfg = TT._reply_cfg(SearchConfig())
    _, n, ovf = TMG.legal_afterstates(tt(vec), tt(np.array([1, 1])), rcfg)
    assert bool(ovf) and int(n) == 512
    # the same 15 singletons as the replier's, our 15 checkers on our
    # point 0 (their 23): a 1-2 from there hits nothing
    ob = np.zeros(52, np.int8)
    ob[0] = 15                        # player 0, absolute point 0
    ob[24 + 9:48] = 1                 # player 1: absolute 9..23, its 14..0
    arrays = (*split_abs(ob[None]), np.array([0], np.int8),
              np.array([[1, 2]], np.int8))
    ts = TE.make_state(*(tt(x) for x in arrays), TENV)
    _, model = models(5)
    _, overflow = TT.twoply_actions_report(model, ts,
                                           SearchConfig(top_k=2))
    assert bool(overflow[0])


def test_perf_twoply_script_on_cpu(capsys):
    """The port's 2-ply timing script: one JSON row per chunking, the
    mean of two visits (in order, then in reverse), each visit's output
    equal to the first chunking's; no peak memory off the card."""
    import json

    from mlp_ppo_2ply_p3_tpu_torch.scripts import perf_twoply

    perf_twoply.main(["--batch", "1", "--chunks", "8192/2048/128",
                      "3/2/64", "--reps", "1", "--device", "cpu"])
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [(r["game_chunk"], r["dbl_game_chunk"], r["eval_slot_chunk"])
            for r in rows] == [(8192, 2048, 128), (3, 2, 64)]
    for r in rows:
        assert r["equal_first"] and r["peak_mem_gb"] is None
        assert r["batch"] == 1 and r["device"] == "cpu"
        assert r["ms_per_decision"] == sum(r["ms_visits"]) / 2
    # the positions are reachable and the same for every call
    a = perf_twoply.realistic_state(TENV, 4, steps=3, device="cpu")
    b = perf_twoply.realistic_state(TENV, 4, steps=3, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert int(a.n_moves.min()) >= 0 and int(a.n_moves.max()) > 0
