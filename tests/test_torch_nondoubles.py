"""Port parity: the non-doubles batch (``ops/nondoubles.py``).

``nondoubles_batch_plain`` (what ``nondoubles_batch`` runs on the CPU, and
what ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the CUDA
kernel against on the card) must give the JAX package's
``_nondoubles_batch`` (``mlp_ppo_2ply_p3_tpu/core/movegen.py:346-369``,
jnp compaction, ``use_pallas=False``) bit for bit: the boards in list
order, the clamped counts and the overflow flags.  Inputs are made with
numpy from a seed: the oracle's random positions of every stage, the edge
boards of ``tests/test_torch_doubles.py``, every non-double roll, both
mirrors, and all-zero padding games of dice (0, 0)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlp_ppo_2ply_p3_tpu.core import movegen as JM
from mlp_ppo_2ply_p3_tpu.core import oracle
from mlp_ppo_2ply_p3_tpu_torch.core import movegen as TM
from mlp_ppo_2ply_p3_tpu_torch.ops import nondoubles as TN

from .test_torch_doubles import EDGE_BOARDS, _board
from .test_torch_utils import canonical, nn_, random_positions, tt

# the 15 non-double rolls as (high, low)
ROLLS = np.array([(h, lo) for h in range(2, 7) for lo in range(1, h)],
                 np.int32)

# MovegenConfig widths of both packages: the presets, the 2-ply reply
# widths (512 without dedup, 128 with), and widths small enough to cut the
# singles (k1), the raw block (dedup_width) and the list (max_moves)
WIDTHS = {
    "default": dict(),
    "fast": dict(k2=80, k3=192, dedup_width=288, dbl_div=5, dbl_add=56),
    "parity": dict(max_moves=500, k2=128, k3=512, dedup_width=512,
                   exact_order=True, k4=1920),
    "reply512": dict(max_moves=512, k2=128, k3=256, dedup_width=288,
                     dedup=False),
    "reply128": dict(max_moves=128, k2=128, k3=224, dedup_width=288),
    "tiny": dict(max_moves=4, k1=4, dedup_width=12),
    "tiny_raw": dict(max_moves=5, k1=3, dedup_width=16, dedup=False),
}


@functools.lru_cache(maxsize=None)
def _jax_batch(cfg):
    return jax.jit(lambda v, h, lo, mir: JM._nondoubles_batch(
        v, h, lo, cfg, mir))


def _both(name):
    return JM.MovegenConfig(**WIDTHS[name]), TM.MovegenConfig(**WIDTHS[name])


def _games(seed):
    """(vecs, d_hi, d_lo, mirror): 24 random positions (8 of each stage)
    and the edge boards, each with every non-double roll, mirrored on
    every other game; then 4 all-zero padding games of dice (0, 0)."""
    rng = np.random.default_rng(seed)
    boards, players = zip(*(random_positions(rng, 8, stage)
                            for stage in ("any", "bar", "bearoff")))
    vecs = np.concatenate([canonical(np.concatenate(boards),
                                     np.concatenate(players)),
                           np.stack(list(EDGE_BOARDS.values()))])
    g = len(vecs) * len(ROLLS)
    vecs = np.repeat(vecs, len(ROLLS), axis=0)
    rolls = np.tile(ROLLS, (g // len(ROLLS), 1))
    mirror = np.arange(g) % 2 == 1
    vecs = np.concatenate([vecs, np.zeros((4, 52), np.int8)])
    rolls = np.concatenate([rolls, np.zeros((4, 2), np.int32)])
    mirror = np.concatenate([mirror, [False, True, False, True]])
    return vecs.astype(np.int8), rolls[:, 0], rolls[:, 1], mirror


def _check(vecs, d_hi, d_lo, mirror, name):
    """The port's plain batch against JAX's; returns the port's output."""
    jcfg, tcfg = _both(name)
    want = _jax_batch(jcfg)(vecs, d_hi, d_lo, mirror)
    got = TN.nondoubles_batch_plain(tt(vecs), tt(d_hi), tt(d_lo),
                                    tt(mirror), tcfg.k1, tcfg.dedup_width,
                                    tcfg.max_moves, tcfg.dedup)
    for g, w, what in zip(got, want, ("boards", "n", "overflow")):
        np.testing.assert_array_equal(nn_(g), np.asarray(w),
                                      err_msg=f"{name}: {what}")
    return got


@pytest.mark.parametrize("name", sorted(WIDTHS))
def test_plain_matches_jax(name):
    vecs, d_hi, d_lo, mirror = _games(5)
    out, n, overflow = _check(vecs, d_hi, d_lo, mirror, name)
    assert int(n[-4:].abs().sum()) == 0 and not bool(overflow[-4:].any())
    assert int(n.sum()) > 0
    _, tcfg = _both(name)
    # where the widths cut, both overflow terms fire: the raw block above
    # dedup_width, and the unique moves above max_moves within it
    _, _, n_raw = TN.raw_block_plain(tt(vecs), tt(d_hi), tt(d_lo),
                                     tt(mirror), tcfg.k1, tcfg.dedup_width)
    if name == "tiny":
        assert bool((n_raw > tcfg.dedup_width).any())
        assert bool((overflow & (n_raw <= tcfg.dedup_width)).any())
    if name == "tiny_raw":
        assert bool(overflow.any())


def test_plain_matches_jax_swapped_dice_and_random_boards():
    """d_hi below or equal to d_lo (order A is then the low die first) and
    boards of random counts, some negative, which the rules never make.
    Dice stay in 1..6: a die of 0 comes only with an all-zero padding
    board, and with a checker on the bar the two packages read the entry
    point of die 0 differently (JAX wraps index -1 to point 23, the port
    clamps it to 0)."""
    rng = np.random.default_rng(21)
    g = 300
    vecs = rng.integers(-2, 16, (g, 52)).astype(np.int8)
    vecs[:, :48] *= (rng.random((g, 48)) < 0.3).astype(np.int8)
    vecs[rng.random(g) < 0.5, :18] = 0
    vecs[:, 48] *= (rng.random(g) < 0.2).astype(np.int8)
    d = rng.integers(1, 7, (g, 2)).astype(np.int32)
    assert (d[:, 0] < d[:, 1]).any() and (d[:, 0] == d[:, 1]).any()
    _check(vecs, d[:, 0], d[:, 1], rng.random(g) < 0.5, "fast")


def test_skip_of_the_reversed_order():
    """One checker, on point 0; the point both dice reach together is
    blocked.  Order A (6 first) has no pair and one single, so order B,
    whose single (3 first) would add a second move, is skipped: one move,
    the high die's, as in the JAX package."""
    board = _board({0: 1}, {9: 2}, off=14)
    vecs = np.stack([board, board])
    d_hi, d_lo = np.array([6, 6], np.int32), np.array([3, 3], np.int32)
    out, n, overflow = _check(vecs, d_hi, d_lo, np.array([False, True]),
                              "fast")
    assert n.tolist() == [1, 1] and not bool(overflow.any())
    assert nn_(out[0, 0, 6]) == 1 and nn_(out[0, 0, 0]) == 0
    # with the high die blocked as well, only the low die plays
    board[24 + 6] = 2
    _, n, _ = _check(board[None], d_hi[:1], d_lo[:1], np.array([False]),
                     "fast")
    assert n.tolist() == [1]


@pytest.mark.parametrize("dedup", [True, False])
def test_movegen_batch_matches_jax(dedup):
    """``legal_afterstates_batch`` at B = 640 (the sub-batch split and its
    padding games) with the dedup on and off, and
    ``nondoubles_afterstates_batch`` on game-over boards too."""
    kw = dict(WIDTHS["fast"], dedup=dedup, max_moves=256 if dedup else 512)
    jcfg, tcfg = JM.MovegenConfig(**kw), TM.MovegenConfig(**kw)
    rng = np.random.default_rng(640 + dedup)
    b = 640
    boards, players = random_positions(rng, b, "any")
    vecs, mirror = canonical(boards, players), players == 1
    dice = rng.integers(1, 7, (b, 2)).astype(np.int8)
    want = JM.legal_afterstates_batch(jnp.asarray(vecs), jnp.asarray(dice),
                                      jcfg, mirror=jnp.asarray(mirror))
    got = TM.legal_afterstates_batch(tt(vecs), tt(dice), tcfg,
                                     mirror=tt(mirror))
    for g, w, what in zip(got, want, ("boards", "n_moves", "overflow")):
        np.testing.assert_array_equal(nn_(g), np.asarray(w), err_msg=what)
    assert TM.nondoubles_capacity(b, tcfg) < b

    sub = np.concatenate([vecs[:40], np.stack([EDGE_BOARDS["game_over"]])])
    hi = np.concatenate([ROLLS[:, 0], ROLLS[:, 0], ROLLS[:11, 0]])
    lo = np.concatenate([ROLLS[:, 1], ROLLS[:, 1], ROLLS[:11, 1]])
    want = jax.jit(JM.nondoubles_afterstates_batch,
                   static_argnames=("cfg",))(
        jnp.asarray(sub), jnp.asarray(hi), jnp.asarray(lo), jcfg,
        mirror=jnp.asarray(mirror[:41]))
    got = TM.nondoubles_afterstates_batch(tt(sub), tt(hi), tt(lo), tcfg,
                                          mirror=tt(mirror[:41]))
    for g, w, what in zip(got, want, ("boards", "n_moves", "overflow")):
        np.testing.assert_array_equal(nn_(g), np.asarray(w), err_msg=what)
    assert int(got[1][-1]) == 0


def test_wrapper_on_cpu_and_its_checks():
    """On CPU tensors the wrapper is the plain version and launches
    nothing (uint8 mirror flags too); it refuses what the kernel does not
    take."""
    vecs, d_hi, d_lo, mirror = (tt(x) for x in _games(3))
    before = TN.nondoubles_batch.launches
    for mir in (mirror, mirror.to(torch.uint8)):
        got = TN.nondoubles_batch(vecs, d_hi, d_lo, mir, 16, 288, 256, True)
        want = TN.nondoubles_batch_plain(vecs, d_hi, d_lo, mirror, 16, 288,
                                         256, True)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert TN.nondoubles_batch.launches == before
    meta = torch.zeros(d_hi.shape, dtype=torch.int32, device="meta")
    bad = [
        (vecs.to(torch.int32), d_hi, d_lo, mirror, 16, 288, 256),
        (vecs[:, :51].contiguous(), d_hi, d_lo, mirror, 16, 288, 256),
        (vecs, d_hi.to(torch.int64), d_lo, mirror, 16, 288, 256),
        (vecs, d_hi[:5], d_lo, mirror, 16, 288, 256),
        (vecs, d_hi, meta, mirror, 16, 288, 256),
        (vecs.t().contiguous().t(), d_hi, d_lo, mirror, 16, 288, 256),
        (vecs, d_hi, d_lo, mirror.to(torch.int32), 16, 288, 256),
        (vecs, d_hi, d_lo, mirror, 0, 288, 256),
        (vecs, d_hi, d_lo, mirror, 16, -1, 256),
        (vecs, d_hi, d_lo, mirror, 16, 288, 70000),
    ]
    for a in bad:
        with pytest.raises(ValueError):
            TN.nondoubles_batch(*a, True)
    # the in-place form takes the caller's out, and only with a place
    g = vecs.shape[0]
    src = torch.arange(g, dtype=torch.int32)
    fits = torch.ones((g,), dtype=torch.bool)
    dst = torch.full((3,), -1, dtype=torch.int32)
    place = (src, fits, dst, torch.zeros((3,), dtype=torch.int32),
             torch.zeros((3,), dtype=torch.bool))
    out = torch.empty((g, 256, 52), dtype=torch.int8)
    got = TN.nondoubles_batch(vecs, d_hi, d_lo, mirror, 16, 288, 256, True,
                              place, out)
    assert got[0] is out and TN.nondoubles_batch.launches == before
    for g_, w in zip(got, want):
        assert torch.equal(g_, w)
    for pl, o in ((place, None), (None, out), (place, out[:, :128]),
                  (place, out.to(torch.int32)),
                  ((src, fits, dst.long(), *place[3:]), out),
                  ((src, fits, dst, place[3][:2], place[4]), out)):
        with pytest.raises(ValueError):
            TN.nondoubles_batch(vecs, d_hi, d_lo, mirror, 16, 288, 256,
                                True, pl, o)


def _reset_batch(seed, b=600):
    """(vecs, dice, mirror) of ``b`` games: the first b - 40 at the
    opening position with a non-double first roll (a reset, whose rolls
    are all non-doubles: the non-doubles capacity binds), then 32 random
    positions and 8 game-over boards with random rolls; movers at
    random."""
    rng = np.random.default_rng(seed)
    players = rng.integers(0, 2, b)
    opening = np.repeat(oracle.initial_board()[None], b - 40, axis=0)
    boards, _ = random_positions(rng, 32, "any")
    vecs = canonical(np.concatenate([opening, boards]), players[:b - 8])
    vecs = np.concatenate([vecs, np.repeat(EDGE_BOARDS["game_over"][None],
                                           8, axis=0)])
    dice = np.concatenate([ROLLS[rng.integers(0, 15, b - 40)],
                           rng.integers(1, 7, (40, 2))]).astype(np.int8)
    return vecs.astype(np.int8), dice, players == 1


# (widths, dedup): fast() and the default widths and a width that
# truncates the singles, the raw block and the list, each with the dedup on
# and off
IN_PLACE = [(name, dedup) for name in ("fast", "default", "tiny")
            for dedup in (True, False)]


@pytest.mark.parametrize("name,dedup", IN_PLACE)
def test_in_place_plain_matches_jax(name, dedup):
    """``nondoubles_place_plain`` (the in-place form's plain version, which
    ``nondoubles_batch`` runs on the CPU) on ``legal_afterstates_batch``'s
    own placement, into an output whose doubles rows ``doubles_final``
    wrote in place, equals the JAX package's
    ``legal_afterstates_batch`` at B = 600: the slot clamp of the
    non-doubles capacity, doubles games, game-over games, both movers."""
    kw = dict(WIDTHS[name], dedup=dedup)
    jcfg, tcfg = JM.MovegenConfig(**kw), TM.MovegenConfig(**kw)
    vecs, dice, mirror = _reset_batch(17 + len(name) + dedup)
    b = len(vecs)
    want = JM.legal_afterstates_batch(jnp.asarray(vecs), jnp.asarray(dice),
                                      jcfg, mirror=jnp.asarray(mirror))
    tv, tm = tt(vecs), tt(mirror)
    d0, d1 = (tt(dice)[:, i].to(torch.int32) for i in (0, 1))
    is_double = d0 == d1
    bd, bn = TM.doubles_capacity(b, tcfg), TM.nondoubles_capacity(b, tcfg)
    (dv, dd, dm), _ = TM._compact_games((tv, d0, tm.to(torch.int8)),
                                        is_double, bd)
    src, fits, _, _, dst = TM._placement(is_double, bd, bn)
    out = torch.full((b, tcfg.max_moves, 52), -77, dtype=torch.int8)
    _, db_n, db_of = TM._doubles_batch(dv, dd, tcfg, dm > 0, out, dst)
    got = TN.nondoubles_place_plain(
        tv, torch.maximum(d0, d1), torch.minimum(d0, d1), tm, tcfg.k1,
        tcfg.dedup_width, tcfg.max_moves, tcfg.dedup,
        (src, fits, dst, db_n, db_of), out)
    assert got[0] is out
    for g, w, what in zip(got, want, ("boards", "n_moves", "overflow")):
        np.testing.assert_array_equal(nn_(g), np.asarray(w),
                                      err_msg=f"{name}: {what}")
    clamped = ~fits & ~is_double
    assert bool(clamped.any()) and bool(is_double.any())
    assert bool((src[clamped] == src[clamped][0]).all())
    assert int(got[1][clamped].abs().sum()) == 0
    assert bool(got[2][clamped].all())
    assert int(got[1][-8:].abs().sum()) == 0 and int(got[1].sum()) > 0
    assert bool(mirror.any()) and not bool(mirror.all())
