"""Port parity: legal-move enumeration (``core/movegen.py``).

The port's four entry points must give the JAX package's move lists in
order, counts and overflow flags, bit for bit, under the ``fast()``,
default-style and ``parity()`` width configs; and the lists must be
set-equal to the numpy rules oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlp_ppo_2ply_p3_tpu.core import movegen as JM
from mlp_ppo_2ply_p3_tpu.core import oracle
from mlp_ppo_2ply_p3_tpu_torch.core import movegen as TM
from mlp_ppo_2ply_p3_tpu_torch.ops import compaction as TC

from .test_movegen import abs_to_canonical_np, canonical_to_abs_np
from .test_torch_utils import canonical, nn_, random_positions, tt

# the JAX package jits only two of its four entries; compile the other
# two as well (op-by-op dispatch of a movegen graph is slow)
J_DOUBLES = jax.jit(JM.doubles_afterstates_batch, static_argnames=("cfg",))
J_NONDOUBLES = jax.jit(JM.nondoubles_afterstates_batch,
                       static_argnames=("cfg",))

# name -> (kwargs for MovegenConfig of both packages, batch size)
CONFIGS = {
    "fast": (dict(max_moves=256, k2=80, k3=192, dedup_width=288, dbl_div=5,
                  dbl_add=56), 64),
    "wide": (dict(max_moves=500, k2=128, k3=320), 64),
    "parity": (dict(max_moves=500, k2=128, k3=512, dedup_width=512,
                    exact_order=True, k4=1920), 16),
}


def _cfgs(name, **over):
    kw = {**CONFIGS[name][0], **over}
    return JM.MovegenConfig(**kw), TM.MovegenConfig(**kw)


def _assert_same(got, want):
    for g, w, what in zip(got, want, ("boards", "n_moves", "overflow")):
        np.testing.assert_array_equal(nn_(g), np.asarray(w), err_msg=what)


def _batch(vecs, dice, mirror, name, **over):
    jcfg, tcfg = _cfgs(name, **over)
    want = JM.legal_afterstates_batch(jnp.asarray(vecs), jnp.asarray(dice),
                                      jcfg, mirror=jnp.asarray(mirror))
    got = TM.legal_afterstates_batch(tt(vecs), tt(dice), tcfg,
                                     mirror=tt(mirror))
    _assert_same(got, want)
    return got


def _pad(vecs, dice, mirror, b, seed):
    """Fill up to b games with random positions and rolls."""
    rng = np.random.default_rng(seed)
    k = b - len(vecs)
    boards, players = random_positions(rng, k, "any")
    return (np.concatenate([vecs, canonical(boards, players)]),
            np.concatenate([dice, rng.integers(1, 7, (k, 2)).astype(np.int8)]),
            np.concatenate([mirror, players == 1]))


ALL_ROLLS = [(d0, d1) for d0 in range(1, 7) for d1 in range(d0, 7)]


@pytest.mark.parametrize("name", ["fast", "wide", "parity"])
def test_opening_all_rolls_both_players(name):
    b = CONFIGS[name][1]
    ob = oracle.initial_board()
    items = [(p, r) for p in (0, 1) for r in ALL_ROLLS]
    for start in range(0, len(items), b):
        chunk = items[start:start + b]
        vecs = np.stack([abs_to_canonical_np(ob, p) for p, _ in chunk])
        dice = np.array([r for _, r in chunk], np.int8)
        mirror = np.array([p == 1 for p, _ in chunk])
        if len(chunk) < b:
            vecs, dice, mirror = _pad(vecs, dice, mirror, b, seed=start)
        _batch(vecs, dice, mirror, name)


STAGES = ["any", "bar", "bearoff"]


@pytest.mark.parametrize("name", ["fast", "wide", "parity"])
@pytest.mark.parametrize("stage", STAGES)
def test_random_positions(name, stage):
    b = CONFIGS[name][1]
    rng = np.random.default_rng(
        100 * list(CONFIGS).index(name) + STAGES.index(stage))
    boards, players = random_positions(rng, b, stage)
    dice = rng.integers(1, 7, (b, 2)).astype(np.int8)
    _batch(canonical(boards, players), dice, players == 1, name)


@pytest.mark.parametrize("name", ["fast", "wide", "parity"])
def test_doubles_deep_and_direct_entries(name):
    """Doubles on spread positions (widest frontiers) through the public
    batch entry and through doubles_afterstates_batch; non-doubles
    through nondoubles_afterstates_batch."""
    b = CONFIGS[name][1]
    rng = np.random.default_rng(99)
    boards, players = random_positions(rng, b, "any")
    vecs, mirror = canonical(boards, players), players == 1
    die = rng.integers(1, 7, (b,)).astype(np.int32)
    _batch(vecs, np.stack([die, die], 1).astype(np.int8), mirror, name)

    jcfg, tcfg = _cfgs(name)
    want = J_DOUBLES(jnp.asarray(vecs), jnp.asarray(die), cfg=jcfg,
                     mirror=jnp.asarray(mirror))
    got = TM.doubles_afterstates_batch(tt(vecs), tt(die), tcfg,
                                       mirror=tt(mirror))
    _assert_same(got, want)

    d = rng.integers(1, 7, (b, 2))
    d = d[d[:, 0] != d[:, 1]][: b // 2]
    hi = d.max(1).astype(np.int32)
    lo = d.min(1).astype(np.int32)
    k = len(d)
    want = J_NONDOUBLES(jnp.asarray(vecs[:k]), jnp.asarray(hi),
                        jnp.asarray(lo), cfg=jcfg,
                        mirror=jnp.asarray(mirror[:k]))
    got = TM.nondoubles_afterstates_batch(tt(vecs[:k]), tt(hi), tt(lo), tcfg,
                                          mirror=tt(mirror[:k]))
    _assert_same(got, want)


@pytest.mark.parametrize("name", ["fast", "parity"])
def test_single_board_entry(name):
    jcfg, tcfg = _cfgs(name)
    rng = np.random.default_rng(4)
    boards, players = random_positions(rng, 6, "any")
    vecs = canonical(boards, players)
    for i, dice in enumerate([(3, 3), (6, 5), (1, 1), (2, 4), (5, 5), (6, 1)]):
        want = JM.legal_afterstates(jnp.asarray(vecs[i]), jnp.asarray(dice),
                                    jcfg, mirror=bool(players[i]))
        got = TM.legal_afterstates(tt(vecs[i]), torch.tensor(dice), tcfg,
                                   mirror=bool(players[i]))
        _assert_same(got, want)


def test_saturation_flags():
    """Absurdly tight caps (the overflow test's TINY config): every
    opening position overflows, on both sides identically."""
    tiny = dict(max_moves=4, k2=8, k3=8, dedup_width=16)
    rng = np.random.default_rng(0)
    ob = oracle.initial_board()
    players = rng.integers(0, 2, 32)
    vecs = np.stack([abs_to_canonical_np(ob, p) for p in players])
    d = np.array([r for r in ALL_ROLLS if r[0] != r[1]] * 3, np.int8)[:32]
    want = JM.legal_afterstates_batch(jnp.asarray(vecs), jnp.asarray(d),
                                      JM.MovegenConfig(**tiny),
                                      mirror=jnp.asarray(players == 1))
    got = TM.legal_afterstates_batch(tt(vecs), tt(d), TM.MovegenConfig(**tiny),
                                     mirror=tt(players == 1))
    _assert_same(got, want)
    assert bool(got[2].all())
    # doubles levels overflow too
    dd = np.tile(np.array([[1, 1], [2, 2], [3, 3], [6, 6]], np.int8), (8, 1))
    want = JM.legal_afterstates_batch(jnp.asarray(vecs), jnp.asarray(dd),
                                      JM.MovegenConfig(**tiny))
    got = TM.legal_afterstates_batch(tt(vecs), tt(dd),
                                     TM.MovegenConfig(**tiny))
    _assert_same(got, want)
    assert bool(got[2].any())


def test_partitioned_batch_uniform_dice():
    """B = 600 >= 512 with uniform random dice: the non-doubles /
    doubles sub-batches get their reduced capacities (nondoubles_capacity,
    doubles_capacity), which smaller batches never exercise."""
    b = 600
    jcfg, tcfg = _cfgs("fast")
    assert TM.nondoubles_capacity(b, tcfg) == JM.nondoubles_capacity(b, jcfg)
    assert TM.doubles_capacity(b, tcfg) == JM.doubles_capacity(b, jcfg)
    assert TM.nondoubles_capacity(b, tcfg) < b
    assert TM.doubles_capacity(b, tcfg) < b
    rng = np.random.default_rng(600)
    boards, players = random_positions(rng, b, "any")
    dice = rng.integers(1, 7, (b, 2)).astype(np.int8)
    got = _batch(canonical(boards, players), dice, players == 1, "fast")
    assert int(got[1].sum()) > 0


def test_set_equality_with_oracle():
    """A sample of positions: the port's lists (parity caps) hold exactly
    the oracle's afterstates, with no duplicates."""
    _, tcfg = _cfgs("parity")
    rng = np.random.default_rng(31)
    boards, players = random_positions(rng, 24, "any")
    dice = rng.integers(1, 7, (24, 2)).astype(np.int8)
    out, n, of = TM.legal_afterstates_batch(
        tt(canonical(boards, players)), tt(dice), tcfg,
        mirror=tt(players == 1))
    for i in range(24):
        assert not bool(of[i])
        got = {canonical_to_abs_np(nn_(out[i, j]), int(players[i])).tobytes()
               for j in range(int(n[i]))}
        assert len(got) == int(n[i])
        assert got == oracle.afterstate_set(boards[i], int(players[i]),
                                            tuple(dice[i]))


@pytest.mark.parametrize("over", [
    dict(use_pallas=True, pallas_kernel="onehot"),
    dict(use_pallas=True, pallas_kernel="segmented"),
    dict(dedup=False),
])
def test_kernel_selectors_and_dedup_off(over, monkeypatch):
    """Every kernel selector gives the JAX result; dedup=False too.  The
    number of compactions per call is what compactions_per_call says.
    (16 games: the JAX Pallas kernels run in interpret mode here.)"""
    b = 16
    rng = np.random.default_rng(17)
    boards, players = random_positions(rng, b, "any")
    dice = rng.integers(1, 7, (b, 2)).astype(np.int8)
    calls = []
    real = TC.compact_rows

    def counting(payload, valid, k_out):
        calls.append(k_out)
        return real(payload, valid, k_out)

    monkeypatch.setattr(TC, "compact_rows", counting)
    _batch(canonical(boards, players), dice, players == 1, "fast", **over)
    _, tcfg = _cfgs("fast", **over)
    assert len(calls) == TM.compactions_per_call(tcfg)
