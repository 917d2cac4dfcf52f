"""Port parity: the agents (``agents/{basic,pubeval,frozen,arena,league}``).

Inputs are made with numpy from seeds and handed to both packages; the
JAX side runs compiled.  Tolerances: values and logits 1e-5 (float32
products summed in another order); greedy choices are compared where the
best value leads the second by more than 1e-4; the pubeval encoding
1e-6 against the literal ``setx`` transcription; the arena bit for bit,
with JAX's draws replayed through its key schedule (reset, then per ply
the two sides' uniforms and the env's draws)."""

import dataclasses
import hashlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlp_ppo_2ply_p3_tpu.agents import arena as JA
from mlp_ppo_2ply_p3_tpu.agents import basic as JB
from mlp_ppo_2ply_p3_tpu.agents import frozen as JF
from mlp_ppo_2ply_p3_tpu.agents import league as JLG
from mlp_ppo_2ply_p3_tpu.agents import pubeval as JP
from mlp_ppo_2ply_p3_tpu.core import oracle
from mlp_ppo_2ply_p3_tpu.core.movegen import MovegenConfig as JMovegenConfig
from mlp_ppo_2ply_p3_tpu.env import bg_env as JE
from mlp_ppo_2ply_p3_tpu.models import mlp as JMLP
from mlp_ppo_2ply_p3_tpu.utils.config import get_preset as j_preset
from mlp_ppo_2ply_p3_tpu_torch.agents import arena as TA
from mlp_ppo_2ply_p3_tpu_torch.agents import basic as TB
from mlp_ppo_2ply_p3_tpu_torch.agents import frozen as TF
from mlp_ppo_2ply_p3_tpu_torch.agents import league as TLG
from mlp_ppo_2ply_p3_tpu_torch.agents import pubeval as TP
from mlp_ppo_2ply_p3_tpu_torch.core.movegen import MovegenConfig
from mlp_ppo_2ply_p3_tpu_torch.env import bg_env as TE
from mlp_ppo_2ply_p3_tpu_torch.models import mlp as TMLP
from mlp_ppo_2ply_p3_tpu_torch.utils import convert
from mlp_ppo_2ply_p3_tpu_torch.utils.config import get_preset

from .test_agents import canonical_to_pos_np, setx_np
from .test_movegen import abs_to_canonical_np
from .test_torch_utils import (
    JaxArenaDraws,
    jax_uniforms,
    nn_,
    random_positions,
    split_abs,
    tt,
)

M = 128
# doubles frontiers cut to 64 (truncation is part of the parity: both
# packages cut the same lists), which keeps a CPU env step near 65 ms
WIDTHS = dict(max_moves=M, k2=64, k3=64, dedup_width=128)
JENV = JE.EnvConfig(movegen=JMovegenConfig(**WIDTHS))
TENV = TE.EnvConfig(movegen=MovegenConfig(**WIDTHS))
JMODEL = JMLP.ModelConfig(action_size=M, hidden_size=32)


def jax_params(seed=0):
    params = JMLP.init_params(jax.random.PRNGKey(seed), JMODEL)
    return jax.tree_util.tree_map(np.asarray, params)


def both_states(seed, n=24):
    """The same n positions (random stages, both players, random dice)
    as a JAX and a port ``EnvState``."""
    rng = np.random.default_rng(seed)
    boards, players = [], []
    for stage in ("any", "bearoff", "bar"):
        b, p = random_positions(rng, n // 3, stage)
        boards.append(b)
        players.append(p)
    points, bar, off = split_abs(np.concatenate(boards))
    turn = np.concatenate(players).astype(np.int8)
    dice = rng.integers(1, 7, (n, 2)).astype(np.int8)
    arrays = (points, bar, off, turn, dice)
    return (JE.make_state(*(jnp.asarray(x) for x in arrays), JENV),
            TE.make_state(*(tt(x) for x in arrays), TENV))


# --- basic -------------------------------------------------------------------


def test_random_actions_with_jax_uniforms():
    js, ts = both_states(0, 48)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = jax.jit(JB.random_actions)(js, key)
        got = TB.random_actions(ts, jax_uniforms(key))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(nn_(got), np.asarray(want))
    n = nn_(ts.n_moves)
    assert (nn_(got) < np.maximum(n, 1)).all()


@pytest.mark.parametrize("name", ["afterstate_values", "index_policy_logits",
                                  "afterstate_policy_logits"])
def test_values_and_logits_match_jax(name):
    params = jax_params(1)
    model = convert.params_from_jax(params, device="cpu")
    js, ts = both_states(1)
    want = jax.jit(getattr(JB, name), static_argnums=2)(
        jax.tree_util.tree_map(jnp.asarray, params), js, JMODEL)
    got = getattr(TB, name)(model, ts)
    if name == "afterstate_values":
        # the port evaluates only the legal prefix, NEG_INF past it, as
        # each caller of the JAX twin masks it
        want = jnp.where(JE.action_mask(js), want, JB.NEG_INF)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(nn_(g), np.asarray(w), atol=1e-5)


def test_greedy_1ply_on_oracle_positions():
    """Equal choices on 20 oracle positions wherever the best value leads
    the second by more than 1e-4 (a closer pair may swap on float32
    summation order)."""
    rng = np.random.default_rng(3)
    params = jax_params(0)
    model = convert.params_from_jax(params, device="cpu")
    boards = np.stack([oracle.random_board(rng, "any") for _ in range(20)])
    turn = rng.integers(0, 2, 20).astype(np.int8)
    dice = rng.integers(1, 7, (20, 2)).astype(np.int8)
    arrays = (*split_abs(boards), turn, dice)
    js = JE.make_state(*(jnp.asarray(x) for x in arrays), JENV)
    ts = TE.make_state(*(tt(x) for x in arrays), TENV)
    want = np.asarray(jax.jit(JB.greedy_1ply, static_argnums=2)(
        jax.tree_util.tree_map(jnp.asarray, params), js, JMODEL))
    got = nn_(TB.greedy_1ply(model, ts))
    vals = nn_(torch.where(TE.action_mask(ts), TB.afterstate_values(model, ts),
                           TB.NEG_INF))
    top2 = -np.sort(-vals, axis=1)[:, :2]
    clear = (nn_(ts.n_moves) > 0) & (top2[:, 0] - top2[:, 1] > 1e-4)
    assert clear.sum() >= 15
    np.testing.assert_array_equal(got[clear], want[clear])


@pytest.mark.parametrize("policy", ["index", "afterstate"])
def test_sampled_policy_distribution(policy):
    """Sampling is checked by its distribution: masked slots are never
    drawn and frequencies follow softmax(logits) (99.9% chi-square bound
    at the row's degrees of freedom)."""
    params = jax_params(2)
    model = convert.params_from_jax(params, device="cpu")
    js, ts = both_states(2, 3)
    row = int(np.argmax(nn_(ts.n_moves) >= 3))
    one = TE.EnvState(*(x[row:row + 1].expand((4000,) + x.shape[1:])
                        for x in ts))
    logits_fn = {"index": lambda: TB.index_policy_logits(model, one)[0],
                 "afterstate": lambda: TB.afterstate_policy_logits(model,
                                                                   one)}
    fn = getattr(TB, f"{policy}_policy")
    gen = torch.Generator().manual_seed(0)
    a = nn_(fn(model, one, TB.uniforms(gen)))
    n = int(ts.n_moves[row])
    assert a.max() < n
    p = nn_(torch.softmax(logits_fn[policy]()[0, :n].double(), 0))
    counts = np.bincount(a, minlength=n)
    keep = p * len(a) >= 5   # chi-square cells with enough mass
    expect = len(a) * p[keep]
    chi2 = float(((counts[keep] - expect) ** 2 / expect).sum())
    from scipy.stats import chi2 as chi2_dist

    assert chi2 < chi2_dist.ppf(0.999, max(1, keep.sum() - 1)), chi2
    assert (fn(model, one, None, sample=False) == int(np.argmax(p))).all()


# --- pubeval -----------------------------------------------------------------


def pubeval_boards():
    """The starting position and random boards of every stage, for both
    players, in the canonical frame (tests/test_agents.py's cases)."""
    rng = np.random.default_rng(7)
    boards = [oracle.initial_board()] + [
        oracle.random_board(rng, stage)
        for stage in ("any", "bearoff", "bar") for _ in range(10)]
    return np.stack([abs_to_canonical_np(ob, p)
                     for ob in boards for p in (0, 1)])


def test_pubeval_encoding_matches_jax_and_setx():
    vecs = pubeval_boards()
    got = nn_(TP.encode_pubeval(tt(vecs)))
    want = np.asarray(jax.jit(JP.encode_pubeval)(jnp.asarray(vecs)))
    np.testing.assert_array_equal(got, want)
    for g, v in zip(got, vecs):
        np.testing.assert_allclose(g, setx_np(canonical_to_pos_np(v)),
                                   atol=1e-6)


def jittered_weights(seed=0):
    """The heuristic weights, each scaled by 1 + 0.01 N(0, 1) from a numpy
    seed, as (JAX dict, port dict).  The heuristic's weights are so
    regular that distinct afterstates often score the same in exact
    arithmetic; each package's float32 sum then breaks the tie in its own
    summation order.  The jitter leaves no such ties, so actions can be
    compared exactly."""
    rng = np.random.default_rng(seed)
    w = {k: np.asarray(v) * (1 + 0.01 * rng.normal(size=122)).astype(
        np.float32) for k, v in JP.heuristic_weights().items()}
    return ({k: jnp.asarray(v) for k, v in w.items()},
            {k: tt(v) for k, v in w.items()})


def test_pubeval_race_evaluate_and_actions():
    vecs = pubeval_boards()
    jw = JP.heuristic_weights()
    tw = TP.heuristic_weights("cpu")
    for k in ("contact", "race"):
        np.testing.assert_array_equal(nn_(tw[k]), np.asarray(jw[k]))
    np.testing.assert_array_equal(
        nn_(TP.is_race(tt(vecs))), np.asarray(JP.is_race(jnp.asarray(vecs))))
    np.testing.assert_allclose(
        nn_(TP.evaluate(tw, tt(vecs))),
        np.asarray(jax.jit(JP.evaluate)(jw, jnp.asarray(vecs))), atol=1e-5)
    # the win short-circuit, and a race turned into contact
    won = np.zeros(52, np.int8)
    won[50] = 15
    assert float(TP.evaluate(tw, tt(won))) == float(np.float32(TP.WIN_SCORE))
    race = np.zeros(52, np.int8)
    race[20], race[24 + 4] = 15, 15
    assert bool(TP.is_race(tt(race)))
    race[2], race[20] = 1, 14
    assert not bool(TP.is_race(tt(race)))
    # actions: the heuristic where the best score leads by more than 1e-4,
    # jittered weights everywhere
    js, ts = both_states(4, 48)
    got = nn_(TP.pubeval_actions(tw, ts))
    want = np.asarray(jax.jit(JP.pubeval_actions)(jw, js))
    vals = nn_(torch.where(TE.action_mask(ts), TP.evaluate(tw, ts.after),
                           TP.NEG_INF))
    top2 = -np.sort(-vals, axis=1)[:, :2]
    clear = top2[:, 0] - top2[:, 1] > 1e-4
    assert clear.sum() >= 24
    np.testing.assert_array_equal(got[clear], want[clear])
    jw, tw = jittered_weights()
    np.testing.assert_array_equal(
        nn_(TP.pubeval_actions(tw, ts)),
        np.asarray(jax.jit(JP.pubeval_actions)(jw, js)))


def test_pubeval_weights_from_file(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    wc, wr = rng.normal(size=(2, 122)).astype(np.float32)
    path = tmp_path / "pubeval.npz"
    np.savez(path, contact=wc, race=wr)
    monkeypatch.setenv("PUBEVAL_WEIGHTS", str(path))
    w = TP.default_weights("cpu")
    np.testing.assert_array_equal(nn_(w["contact"]), wc)
    np.testing.assert_array_equal(nn_(w["race"]), wr)
    monkeypatch.setenv("PUBEVAL_WEIGHTS", "")
    np.testing.assert_array_equal(nn_(TP.default_weights("cpu")["race"]),
                                  nn_(TP.heuristic_weights("cpu")["race"]))
    np.savez(path, contact=wc[:5], race=wr)
    with pytest.raises(ValueError):
        TP.load_weights(str(path), "cpu")


# --- frozen ------------------------------------------------------------------


def test_frozen_asset_copy_and_values(tmp_path):
    digest = [hashlib.sha256(open(p, "rb").read()).hexdigest()
              for p in (JF.FROZEN_V1_PATH, TF.FROZEN_V1_PATH)]
    assert digest[0] == digest[1]
    model, cfg = TF.load_frozen(device="cpu")
    j_params, j_cfg = JF.load_frozen()
    assert (cfg.input_size, cfg.hidden_size, cfg.action_size) == (
        j_cfg.input_size, j_cfg.hidden_size, j_cfg.action_size) == (
        198, 128, 256)
    assert cfg == get_preset("twoply").model
    want = convert.params_from_jax(j_params, device="cpu")
    x = tt(np.random.default_rng(0).random((64, 198)).astype(np.float32))
    for head in ("value", "score"):
        assert torch.equal(getattr(model, head)(x), getattr(want, head)(x))
    # save_frozen writes what the JAX package reads
    path = str(tmp_path / "sub" / "frozen.npz")
    TF.save_frozen(path, model)
    back, back_cfg = JF.load_frozen(path)
    assert back_cfg == j_cfg
    for layer in TMLP.HEADS:
        for k in ("w", "b"):
            np.testing.assert_array_equal(back[layer][k], j_params[layer][k])
    assert TF.load_frozen(str(tmp_path / "absent.npz")) is None


# --- league ------------------------------------------------------------------


def test_league_run_pair_frozen_keys_match_jax(capsys):
    """``--params-from frozen`` at 4 games and 20 plies: the JSON line
    has the JAX CLI's keys."""
    want = JLG.run_pair(j_preset("twoply"), "oneply:pubeval", 4, 2, 0,
                        params_from="frozen")
    out = TLG.run_pair(get_preset("twoply"), "oneply:pubeval", 4, 20, 0,
                       params_from="frozen", device="cpu")
    assert list(out) == list(want)
    assert out["games"] == 4 and 0 <= out["finished"] <= 4
    assert out["wins_a"] + out["wins_b"] == out["finished"]
    json.dumps(out)
    assert "frozen_v1" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        TLG.run_pair(get_preset("twoply"), "oneply:nobody", 2, 1, 0,
                     params_from="frozen", device="cpu")


def test_league_ckpt_mode(tmp_path, capsys):
    """No checkpoint: a fresh net from the seed; checkpoints present: the
    newest is restored and played, as in the JAX runner."""
    from mlp_ppo_2ply_p3_tpu_torch.ppo import learner as TL
    from mlp_ppo_2ply_p3_tpu_torch.utils import checkpoint as ckpt

    cfg = dataclasses.replace(get_preset("debug"),
                              checkpoint_dir=str(tmp_path))
    out = TLG.run_pair(cfg, "oneply:random", 2, 3, 0, device="cpu")
    assert out["games"] == 2
    assert "fresh-initialized" in capsys.readouterr().out
    # another seed's net stands for a trained one
    ts = TL.init_train_state(5, cfg.model, cfg.ppo, device="cpu")
    ts = ts._replace(update_idx=torch.tensor(7, dtype=torch.int32))
    env = TE.reset(torch.Generator().manual_seed(2), cfg.env,
                   cfg.ppo.num_envs, device="cpu")
    ckpt.save(str(tmp_path / cfg.name / "ckpt_7"), (ts, env))
    (tmp_path / cfg.name / "ckpt_3.npz").write_bytes(b"")  # older: unread
    got = TLG.run_pair(cfg, "oneply:random", 2, 3, 0, device="cpu")
    assert "ckpt_7.npz (update 7)" in capsys.readouterr().out
    want = TLG.run_pair(cfg, "oneply:random", 2, 3, 0, params=ts.model,
                        device="cpu")
    del got["seconds"], want["seconds"]
    assert got == want


def test_league_cli_main(capsys):
    TLG.main(["--preset", "twoply", "--pair", "frozen:random", "--games",
              "2", "--max-plies", "2", "--params-from", "frozen",
              "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line)["pair"] == "frozen:random"
