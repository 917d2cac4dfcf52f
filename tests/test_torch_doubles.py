"""Port parity: the doubles frontier levels (``ops/doubles.py``).

``doubles_level_plain`` (one level) and ``doubles_levels_plain`` (L1-L3
chained, what ``doubles_levels`` runs on the CPU, and what
``chip_smoke.py`` holds the CUDA kernel against on the card) must give the
JAX package's levels bit for bit: each frontier's boards, its origin
ranks and the unclamped candidate counts.  The JAX level is built here
from the JAX package's own module functions, as its ``_doubles_batch``
builds it (``mlp_ppo_2ply_p3_tpu/core/movegen.py:395-416``, with the jnp
compaction); the root level is its ``first`` + compaction.  Inputs are
made with numpy from a seed."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from mlp_ppo_2ply_p3_tpu.core import board as JB
from mlp_ppo_2ply_p3_tpu.core import movegen as JM
from mlp_ppo_2ply_p3_tpu_torch.core import movegen as TM
from mlp_ppo_2ply_p3_tpu_torch.ops import doubles as TD

from .test_torch_utils import canonical, nn_, random_positions, tt


@partial(jax.jit, static_argnames=("k_out",))
def jax_root(vecs, die, mirror, k_out):
    """The JAX package's first doubles level on (G, 52) root boards."""
    def first(vec, d, mi):
        v1, o1, d1, h1 = (JM._perm_scan(a, mi)
                          for a in JB.submoves_one_die(vec, d))
        b1 = jax.vmap(JB.apply_submove, (None, 0, 0, 0))(vec, o1, d1, h1)
        return b1, JM._rank_of(o1).astype(jnp.int8), v1

    b1, r1, v1 = jax.vmap(first)(vecs, die, mirror)
    (nb, nr), n = JM._compact_batch((b1, r1), v1, k_out, False)
    return nb, nr, n


@partial(jax.jit, static_argnames=("k_out",))
def jax_level(fb, fr, n_in, die, mirror, k_out):
    """The JAX package's doubles ``level`` on a (G, K, 52) frontier."""
    fv = jnp.arange(fb.shape[1])[None, :] < jnp.minimum(
        n_in, fb.shape[1])[:, None]
    eb, ev, eo = jax.vmap(JM._expand_one_die)(fb, fv, die, mirror)
    erank = JM._rank_of(eo).astype(jnp.int8)
    parent = jnp.repeat(fr.astype(jnp.int32), JM.NSLOT, axis=1)
    ev = ev & (erank.astype(jnp.int32) >= parent)
    (nb, nr), n = JM._compact_batch((eb, erank), ev, k_out, False)
    return nb, nr, n


def _same(got, want, what):
    for g, w, name in zip(got, want, ("boards", "ranks", "n")):
        np.testing.assert_array_equal(nn_(g), np.asarray(w),
                                      err_msg=f"{what}: {name}")


def run_chain(vecs, die, mirror, widths):
    """Roots through ``len(widths)`` levels, each level's port output
    held against the JAX level on the same inputs.  Returns the port's
    counts of every level."""
    v, d, m = (np.asarray(x) for x in (vecs, die, mirror))
    got = TD.doubles_level_plain(tt(v)[:, None, :], None, None, tt(d), tt(m),
                                 widths[0])
    _same(got, jax_root(v, d, m, k_out=widths[0]), "level 1")
    counts = [nn_(got[2])]
    for lvl, w in enumerate(widths[1:], start=2):
        fb, fr, n = got
        got = TD.doubles_level_plain(fb, fr, n, tt(d), tt(m), w)
        want = jax_level(nn_(fb), nn_(fr), nn_(n), d, m, k_out=w)
        _same(got, want, f"level {lvl}")
        counts.append(nn_(got[2]))
    return counts


def _positions(seed, g, stage):
    rng = np.random.default_rng(seed)
    boards, players = random_positions(rng, g, stage)
    die = rng.integers(1, 7, g).astype(np.int32)
    return canonical(boards, players).astype(np.int8), die, players == 1


FAST = (16, 80, 192, 256)


@pytest.mark.parametrize("stage", ["any", "bar", "bearoff"])
def test_level_chain_matches_jax(stage):
    """Four levels at ``fast()``'s widths on random positions of both
    players, with an all-zero padding row of die 0 and a game-over
    board."""
    vecs, die, mirror = _positions(7 + len(stage), 24, stage)
    vecs[5], die[5] = 0, 0            # a sub-batch's padding row
    vecs[6, 50] = 15                  # game over: no submove
    counts = run_chain(vecs, die, mirror, FAST)
    assert counts[0][5] == counts[0][6] == 0
    assert counts[-1].sum() > 0


def _board(my=None, opp=None, bar=0, off=0):
    b = np.zeros(52, np.int8)
    for p, c in (my or {}).items():
        b[p] = c
    for p, c in (opp or {}).items():
        b[24 + p] = c
    b[48], b[50] = bar, off
    return b


# canonical boards (the mover travels 0 -> 23, enters from the bar on
# die - 1, bears off past 23), each played with every die, unmirrored
# and mirrored
EDGE_BOARDS = {
    # entry on a blot (die 1: hit), a block (die 2), open points
    "bar_entry": _board({5: 6, 12: 5, 16: 2}, {0: 1, 1: 2, 3: 3, 10: 1},
                        bar=2),
    "bar_blocked": _board({12: 14}, {p: 2 for p in range(6)}, bar=1),
    # farthest home point 20: die 4 bears off exactly from the farthest
    # point, 5 and 6 overshoot, 1 and 2 bear off exactly from 23 and 22,
    # which differ from the farthest
    "bearoff": _board({20: 3, 22: 2, 23: 1}, {3: 2}, off=9),
    "bearoff_exact_not_farthest": _board({18: 1, 21: 2, 23: 4}, {}, off=8),
    "game_over": _board({}, {4: 2}, off=15),
    "padding": _board(),
}


@pytest.mark.parametrize("name", sorted(EDGE_BOARDS))
def test_edge_positions_match_jax(name):
    vecs = np.stack([EDGE_BOARDS[name]] * 12)
    die = np.tile(np.arange(1, 7, dtype=np.int32), 2)
    if name == "padding":
        die[:] = 0
    mirror = np.arange(12) >= 6
    counts = run_chain(vecs, die, mirror, FAST)
    if name in ("bar_blocked", "game_over", "padding"):
        assert all(c.sum() == 0 for c in counts)
    else:
        assert counts[0].sum() > 0
    if name == "bar_entry":   # die 2 meets the block
        assert counts[0][1] == counts[0][7] == 0


def test_truncation_and_overflow():
    """Widths below the counts: the outputs truncate in order and the
    counts stay unclamped."""
    vecs, die, mirror = _positions(31, 16, "any")
    counts = run_chain(vecs, die, mirror, (4, 3, 2, 1))
    assert (counts[1] > 3).any() and (counts[3] > 1).any()


def test_parity_wide_frontier():
    """A frontier as wide as ``parity()``'s k3 (512 rows), every row a
    random position with a random parent rank, and ``max_moves`` (500)
    out: hundreds of valid rows a game (several chunks of the kernel)."""
    g, k = 3, 512
    rng = np.random.default_rng(47)
    boards, players = random_positions(rng, g * k, "any")
    fb = canonical(boards, players).astype(np.int8).reshape(g, k, 52)
    fr = rng.integers(-1, 24, (g, k)).astype(np.int8)
    n = np.array([k, 300, 129], np.int32)
    die = np.array([1, 3, 6], np.int32)
    mirror = np.array([False, True, False])
    got = TD.doubles_level_plain(tt(fb), tt(fr), tt(n), tt(die), tt(mirror),
                                 500)
    _same(got, jax_level(fb, fr, n, die, mirror, k_out=500), "512 rows")
    assert (nn_(got[2]) > 500).any()


@settings(max_examples=20, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2**31 - 1),
       stage=st.sampled_from(["any", "bar", "bearoff"]),
       k_out=st.sampled_from([1, 8, 64]),
       parent=st.integers(-128, 24))
def test_random_levels_match_jax(seed, stage, k_out, parent):
    """Random positions and dice through the root level and two more,
    the second level's frontier given a random parent rank on some rows
    (ranks the canonical path would never produce)."""
    vecs, die, mirror = _positions(seed, 8, stage)
    rng = np.random.default_rng(seed)
    got = TD.doubles_level_plain(tt(vecs)[:, None, :], None, None, tt(die),
                                 tt(mirror), 16)
    _same(got, jax_root(vecs, die, mirror, k_out=16), "root")
    fb, fr, n = (nn_(x) for x in got)
    fr = np.where(rng.random(fr.shape) < 0.3, np.int8(parent), fr)
    n = np.minimum(n, rng.integers(0, 17, n.shape)).astype(np.int32)
    for w in (40, k_out):
        got = TD.doubles_level_plain(tt(fb), tt(fr), tt(n), tt(die),
                                     tt(mirror), w)
        _same(got, jax_level(fb, fr, n, die, mirror, k_out=w), f"to {w}")
        fb, fr, n = (nn_(x) for x in got)


# (k1, k2, k3): fast() and the default widths, the 2-ply reply widths,
# the parity widths, and widths that truncate each level in turn
LEVELS_WIDTHS = {"fast": (16, 80, 192), "default": (16, 96, 224),
                 "reply": (16, 128, 256), "parity": (16, 128, 512),
                 "cut_l1": (3, 96, 224), "cut_l2": (16, 5, 224),
                 "cut_l3": (16, 96, 7), "zero_l3": (16, 40, 0)}


@pytest.mark.parametrize("name", sorted(LEVELS_WIDTHS))
def test_levels_match_three_jax_levels(name):
    """``doubles_levels_plain`` (L1-L3 chained) equals the JAX root level
    and two JAX levels on random positions of every stage, the edge
    boards with every die, both mirrors, a padding row of die 0 and a
    game-over board; where a width cuts, the count above it is kept."""
    k1, k2, k3 = LEVELS_WIDTHS[name]
    rng = np.random.default_rng(300 + k1 + k2 + k3)
    boards, players = zip(*(random_positions(rng, 8, stage)
                            for stage in ("any", "bar", "bearoff")))
    edge = np.repeat(np.stack(list(EDGE_BOARDS.values())), 6, axis=0)
    vecs = np.concatenate([canonical(np.concatenate(boards),
                                     np.concatenate(players)),
                           edge]).astype(np.int8)
    g = len(vecs)
    die = np.concatenate([rng.integers(1, 7, 24),
                          np.tile(np.arange(1, 7), len(EDGE_BOARDS))])
    die = die.astype(np.int32)
    die[np.all(vecs == 0, axis=1)] = 0
    mirror = np.arange(g) % 2 == 1
    got = TD.doubles_levels_plain(tt(vecs), tt(die), tt(mirror), k1, k2, k3)
    f1 = jax_root(vecs, die, mirror, k_out=k1)
    f2 = jax_level(*f1, die, mirror, k_out=k2)
    f3 = jax_level(*f2, die, mirror, k_out=k3)
    want = (f1[0], f1[2], f2[0], f2[2], f3[0], f3[1], f3[2])
    for x, w, what in zip(got, want, ("f1b", "n1", "f2b", "n2", "f3b", "f3r",
                                      "n3")):
        np.testing.assert_array_equal(nn_(x), np.asarray(w),
                                      err_msg=f"{name}: {what}")
    n1, n2, n3 = (nn_(got[i]) for i in (1, 3, 6))
    assert n3.sum() > 0 or k3 == 0
    for n, k, cut in ((n1, k1, "cut_l1"), (n2, k2, "cut_l2"),
                      (n3, k3, "cut_l3")):
        if name == cut:
            assert (n > k).any()


def test_wrapper_on_cpu_and_its_checks():
    """On CPU tensors the fused levels' wrapper is the plain version and
    launches nothing (uint8 mirror flags too); it refuses what the kernel
    does not take."""
    vecs, die, mirror = _positions(3, 6, "any")
    args = (tt(vecs), tt(die), tt(mirror))
    before = TD.doubles_levels.launches
    got = TD.doubles_levels(*args, 16, 40, 9)
    want = TD.doubles_levels_plain(*args, 16, 40, 9)
    assert TD.doubles_levels.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    u8 = TD.doubles_levels(tt(vecs), tt(die), tt(mirror).to(torch.uint8), 16,
                           40, 9)
    for g, w in zip(u8, want):
        assert torch.equal(g, w)
    v, d, m = args
    meta = torch.zeros(d.shape, dtype=torch.int32, device="meta")
    bad = [
        (v.to(torch.int32), d, m, 16, 40, 9),
        (v[:, :51].contiguous(), d, m, 16, 40, 9),
        (v, d.to(torch.int64), m, 16, 40, 9),
        (v, d[:3], m, 16, 40, 9),
        (v, meta, m, 16, 40, 9),
        (v, d, m.to(torch.int32), 16, 40, 9),
        (v, d, m, 16, 40, -1),
        (v, d, m, -1, 40, 9),
        (v.t().contiguous().t(), d, m, 16, 40, 9),
    ]
    for a in bad:
        with pytest.raises(ValueError):
            TD.doubles_levels(*a)


@pytest.mark.parametrize("name", ["fast", "default"])
def test_movegen_through_levels_matches_jax(name, monkeypatch):
    """``legal_afterstates_batch`` with its doubles sub-batch on
    ``doubles_levels`` and ``doubles_final`` equals JAX at ``fast()`` and
    the default widths, on a batch of doubles and non-doubles with the
    partition active (B = 600), and makes ``doubles_levels_per_call``
    fused-levels calls and ``doubles_finals_per_call`` final ones."""
    cfgs = {"fast": dict(max_moves=256, k2=80, k3=192, dedup_width=288,
                         dbl_div=5, dbl_add=56),
            "default": dict(max_moves=256)}
    jcfg, tcfg = JM.MovegenConfig(**cfgs[name]), TM.MovegenConfig(
        **cfgs[name])
    rng = np.random.default_rng(600 + len(name))
    b = 600
    boards, players = random_positions(rng, b, "any")
    dice = rng.integers(1, 7, (b, 2)).astype(np.int8)
    vecs, mirror = canonical(boards, players), players == 1
    want = JM.legal_afterstates_batch(jnp.asarray(vecs), jnp.asarray(dice),
                                      jcfg, mirror=jnp.asarray(mirror))
    calls, finals = [], []
    real, real_final = TD.doubles_levels, TD.doubles_final

    def counted(*a):
        calls.append(a[3:])
        return real(*a)

    def counted_final(*a):
        finals.append(a[9])
        return real_final(*a)

    monkeypatch.setattr(TD, "doubles_levels", counted)
    monkeypatch.setattr(TD, "doubles_final", counted_final)
    got = TM.legal_afterstates_batch(tt(vecs), tt(dice), tcfg,
                                     mirror=tt(mirror))
    for g, w, what in zip(got, want, ("boards", "n_moves", "overflow")):
        np.testing.assert_array_equal(nn_(g), np.asarray(w), err_msg=what)
    assert calls == [(tcfg.k1, tcfg.k2, tcfg.k3)]
    assert finals == [tcfg.max_moves]
    assert len(calls) == TM.doubles_levels_per_call(tcfg) == 1
    assert len(finals) == TM.doubles_finals_per_call(tcfg) == 1
    assert TM.doubles_levels_per_call(TM.MovegenConfig.parity()) == 0
    assert TM.doubles_finals_per_call(TM.MovegenConfig.parity()) == 0


@partial(jax.jit, static_argnames=("cfg",))
def jax_doubles_batch(vecs, die, mirror, cfg):
    return JM._doubles_batch(vecs, die, cfg, mirror)


def _final_chain(vecs, die, mirror, k1, k2, k3, m):
    """The port's three plain levels and ``doubles_final_plain`` against
    the JAX ``_doubles_batch`` at (k1, k2, k3, M); returns the port's
    (n1, n2, n3, n4) and the final output."""
    d, mi = tt(die), tt(mirror)
    f1b, _, n1 = l1 = TD.doubles_level_plain(tt(vecs)[:, None, :], None,
                                             None, d, mi, k1)
    f2b, _, n2 = l2 = TD.doubles_level_plain(*l1, d, mi, k2)
    f3b, f3r, n3 = TD.doubles_level_plain(*l2, d, mi, k3)
    got = TD.doubles_final_plain(f1b, n1, f2b, n2, f3b, f3r, n3, d, mi, m)
    cfg = JM.MovegenConfig(max_moves=m, k1=k1, k2=k2, k3=k3)
    want = jax_doubles_batch(vecs, die, mirror, cfg=cfg)
    for g, w, what in zip(got, want, ("boards", "n", "overflow")):
        np.testing.assert_array_equal(nn_(g), np.asarray(w), err_msg=what)
    n4 = TD.doubles_level_plain(f3b, f3r, n3, d, mi, m)[2]
    return [nn_(x) for x in (n1, n2, n3, n4)], got


# (k1, k2, k3, M): fast() and the default widths, the 2-ply reply widths,
# L3 wider than M (the selection truncates it), and k2, k3 so small that
# the counts exceed them (rows past the width are zeros, n = min(n, M))
FINAL_WIDTHS = {"fast": (16, 80, 192, 256), "default": (16, 96, 224, 256),
                "reply": (16, 128, 256, 512), "l3_wider": (16, 96, 64, 12),
                "narrow": (16, 6, 3, 40)}


@pytest.mark.parametrize("name", sorted(FINAL_WIDTHS))
def test_final_level_matches_jax(name):
    """``doubles_final_plain`` on the three levels before it equals the
    JAX ``_doubles_batch`` on random positions of every stage, the edge
    boards and two bear-offs that end the game within two submoves, every
    die, both mirrors, with padding rows of die 0; games whose L4 (and
    L3, L2) is empty among them."""
    k1, k2, k3, m = FINAL_WIDTHS[name]
    rng = np.random.default_rng(77 + k3)
    boards, players = zip(*(random_positions(rng, 10, stage)
                            for stage in ("any", "bar", "bearoff")))
    ending = [_board({22: 1, 23: 1}, {5: 2}, off=13),
              _board({19: 1}, {}, off=14)]
    vecs = np.concatenate([canonical(np.concatenate(boards),
                                     np.concatenate(players)),
                           np.stack(list(EDGE_BOARDS.values()) + ending)])
    vecs = np.repeat(vecs, 6, axis=0).astype(np.int8)
    die = np.tile(np.arange(1, 7, dtype=np.int32), len(vecs) // 6)
    die[np.all(vecs == 0, axis=1)] = 0
    mirror = np.arange(len(vecs)) % 4 >= 2
    (n1, n2, n3, n4), (_, n, overflow) = _final_chain(vecs, die, mirror, k1,
                                                      k2, k3, m)
    assert ((n4 == 0) & (n3 > 0)).any()       # L4 empty: L3 is the list
    assert ((n3 == 0) & (n2 > 0)).any() and (n1 == 0).any()
    if name == "l3_wider":
        assert (n3 > m).any() and bool(overflow.any())
    if name == "narrow":
        assert (n3 > k3).any() and (n2 > k2).any()
        assert (nn_(n) > k3).any()            # n = min(n, M) past the width


@partial(jax.jit, static_argnames=("m",))
def jax_final(f1b, n1, f2b, n2, f3b, f3r, n3, die, mirror, m):
    """The JAX package's fourth level and selection on given L1-L3
    frontiers: its ``level`` (``jax_level``), then ``_doubles_batch``'s
    tail (``mlp_ppo_2ply_p3_tpu/core/movegen.py:421-439``) with its own
    ``_embed``."""
    f4b, _, n4 = jax_level(f3b, f3r, n3, die, mirror, k_out=m)
    k2, k3 = f2b.shape[1], f3b.shape[1]
    has2, has3, has4 = n2 > 0, n3 > 0, n4 > 0
    embed = jax.vmap(lambda b_, n_: JM._embed(b_, n_, m))
    l1b, l1n = embed(f1b, n1)
    l2b, l2n = embed(f2b, n2)
    l3b, l3n = embed(f3b, n3)
    w4, w3, w2 = (h[:, None, None] for h in (has4, has3, has2))
    out = jnp.where(w4, f4b, jnp.where(w3, l3b, jnp.where(w2, l2b, l1b)))
    n = jnp.where(has4, n4, jnp.where(has3, l3n, jnp.where(has2, l2n, l1n)))
    overflow = ((has2 & (n2 > k2)) | (has3 & (n3 > k3)) | (has4 & (n4 > m))
                | (jnp.logical_not(has4) & has3 & (n3 > m))
                | (jnp.logical_not(has3) & has2 & (n2 > m)))
    return out, jnp.minimum(n, m), overflow


@pytest.mark.parametrize("m", [8, 100])
def test_final_level_on_random_frontiers_matches_jax(m):
    """Random L1-L3 frontiers (random positions, random counts within and
    above each width, parent ranks so high that many L4s are empty): the
    selection falls back on L3, L2 and L1, truncates a level wider than
    M, and reports n = min(n, M) where a count exceeds its width."""
    g, k1, k2, k3 = 64, 16, 24, 40
    rng = np.random.default_rng(91 + m)
    boards, players = random_positions(rng, g * (k1 + k2 + k3), "any")
    rows = canonical(boards, players).astype(np.int8)
    f1b = rows[:g * k1].reshape(g, k1, 52)
    f2b = rows[g * k1:g * (k1 + k2)].reshape(g, k2, 52)
    f3b = rows[g * (k1 + k2):].reshape(g, k3, 52)
    f3r = np.where(rng.random((g, k3)) < 0.5, 23,
                   rng.integers(-1, 24, (g, k3))).astype(np.int8)
    f3r[: g // 2] = 24                    # no expansion at all: L4 empty
    n1, n2, n3 = (rng.integers(0, k + 4, g).astype(np.int32)
                  for k in (k1, k2, k3))
    n3[::3], n2[::4] = 0, 0
    die = rng.integers(1, 7, g).astype(np.int32)
    mirror = rng.random(g) < 0.5
    args = (f1b, n1, f2b, n2, f3b, f3r, n3, die, mirror)
    got = TD.doubles_final_plain(*(tt(x) for x in args), m)
    want = jax_final(*args, m=m)
    for g_, w, what in zip(got, want, ("boards", "n", "overflow")):
        np.testing.assert_array_equal(nn_(g_), np.asarray(w), err_msg=what)
    n4 = nn_(TD.doubles_level_plain(*(tt(x) for x in args[4:]), m)[2])
    empty = n4 == 0
    assert (empty & (n3 > k3)).any() and (empty & (n3 == 0) & (n2 > 0)).any()
    if m < k3:                            # L3 truncated to M
        assert (empty & (n3 > m)).any()
    assert (empty & (n3 == 0) & (n2 == 0)).any()


# (widths, B, share of doubles): below 512 games the doubles sub-batch is
# the whole batch, so its slots past the doubles games are empty; at
# B = 600 with doubles only the capacity binds
IN_PLACE_FINAL = [("fast", 96, 0.5), ("default", 96, 0.5),
                  ("fast", 600, 1.0)]


@pytest.mark.parametrize("name,b,share", IN_PLACE_FINAL)
def test_final_in_place_matches_jax(name, b, share):
    """``doubles_final_plain`` in place, on ``legal_afterstates_batch``'s
    own doubles sub-batch and placement (``dst``): each fitting doubles
    game's row of the batch's (B, M, 52) output, its count (with the
    game-over rule) and its flag equal the JAX package's
    ``legal_afterstates_batch`` (``_doubles_batch`` gathered back) bit for
    bit; every other row stays as it was; an empty slot's count and flag
    are 0.  Positions of every stage, game-over boards, both movers."""
    from mlp_ppo_2ply_p3_tpu_torch.core import board as TB

    cfgs = {"fast": dict(max_moves=256, k2=80, k3=192, dedup_width=288,
                         dbl_div=5, dbl_add=56),
            "default": dict(max_moves=256)}
    jcfg, tcfg = (JM.MovegenConfig(**cfgs[name]),
                  TM.MovegenConfig(**cfgs[name]))
    m = tcfg.max_moves
    rng = np.random.default_rng(b + len(name))
    boards, players = zip(*(random_positions(rng, b // 3, stage)
                            for stage in ("any", "bar", "bearoff")))
    players = np.concatenate(players)
    vecs = canonical(np.concatenate(boards), players)
    vecs[::12] = EDGE_BOARDS["game_over"]
    dice = rng.integers(1, 7, (b, 2)).astype(np.int8)
    dbl = rng.random(b) < share
    dbl[::12] = True
    dice[dbl, 1] = dice[dbl, 0]
    dice[~dbl, 1] = dice[~dbl, 0] % 6 + 1
    mirror = players == 1
    jb, jn, jof = (np.asarray(x) for x in JM.legal_afterstates_batch(
        jnp.asarray(vecs), jnp.asarray(dice), jcfg,
        mirror=jnp.asarray(mirror)))

    tv, tm = tt(vecs), tt(mirror)
    d0, d1 = (tt(dice)[:, i].to(torch.int32) for i in (0, 1))
    is_double = d0 == d1
    bd = TM.doubles_capacity(b, tcfg)
    src, fits, _, _, dst = TM._placement(
        is_double, bd, TM.nondoubles_capacity(b, tcfg))
    (dv, dd, dm), _ = TM._compact_games((tv, d0, tm.to(torch.int8)),
                                        is_double, bd)
    dm = dm > 0
    levels = TD.doubles_levels_plain(dv, dd, dm, tcfg.k1, tcfg.k2, tcfg.k3)
    out = torch.full((b, m, 52), -77, dtype=torch.int8)
    got, n, of = TD.doubles_final_plain(*levels, dd, dm, m, out, dst)
    assert got is out
    wrote = nn_(is_double & fits)
    np.testing.assert_array_equal(nn_(out)[wrote], jb[wrote])
    assert bool((out[tt(~wrote)] == -77).all())
    slot = torch.clamp(-1 - src.long(), min=0)
    n_game = nn_(torch.where(TB.game_over(tv), 0, n[slot]))
    np.testing.assert_array_equal(n_game[wrote], jn[wrote])
    np.testing.assert_array_equal(nn_(of[slot])[wrote], jof[wrote])
    empty = dst < 0
    assert int(n[empty].abs().sum()) == 0 and not bool(of[empty].any())
    assert bool(empty.any()) == (b < 512)
    assert bool((is_double & ~fits).any()) == (b >= 512)
    assert (jn[wrote] > 0).any() and (n_game[wrote] == 0).any()
    assert mirror[wrote].any() and not mirror[wrote].all()


def test_final_wrapper_on_cpu_and_its_checks():
    """On CPU tensors ``doubles_final`` is the plain version and launches
    nothing; it refuses what the kernel does not take."""
    vecs, die, mirror = _positions(9, 12, "bearoff")
    d, mi = tt(die), tt(mirror)
    l1 = TD.doubles_level_plain(tt(vecs)[:, None, :], None, None, d, mi, 16)
    l2 = TD.doubles_level_plain(*l1, d, mi, 32)
    l3 = TD.doubles_level_plain(*l2, d, mi, 48)
    args = (l1[0], l1[2], l2[0], l2[2], *l3, d, mi)
    before = TD.doubles_final.launches
    for g, w in zip(TD.doubles_final(*args, 64),
                    TD.doubles_final_plain(*args, 64)):
        assert torch.equal(g, w)
    assert TD.doubles_final.launches == before
    bad = [
        (l1[0].to(torch.int32), *args[1:]),
        (args[0], args[1].to(torch.int64), *args[2:]),
        (args[0][:5], *args[1:]),
        (*args[:2], args[2].transpose(0, 1).contiguous().transpose(0, 1),
         *args[3:]),
        (*args[:5], None, None, *args[7:]),
        (*args[:7], args[7].to(torch.int64), args[8]),
    ]
    for a in bad:
        with pytest.raises(ValueError):
            TD.doubles_final(*a, 64)
    # the in-place form: slot g's list at row dst[g] of out, none at -1
    dst = torch.tensor([5, -1, 0, 7, 2, -1, 9, 11, 1, 3, -1, 4],
                       dtype=torch.int32)
    out = torch.full((14, 64, 52), 9, dtype=torch.int8)
    want = TD.doubles_final_plain(*args, 64)
    got = TD.doubles_final(*args, 64, out, dst)
    assert got[0] is out and TD.doubles_final.launches == before
    filled = dst >= 0
    assert torch.equal(out[dst[filled].long()], want[0][filled])
    rest = torch.ones(14, dtype=torch.bool)
    rest[dst[filled].long()] = False
    assert bool((out[rest] == 9).all())
    assert torch.equal(got[1], torch.where(filled, want[1], 0))
    assert torch.equal(got[2], want[2] & filled)
    bad_in_place = [
        (out, None), (None, dst), (out, dst.long()), (out, dst[:5]),
        (out[:, :32].contiguous(), dst), (out.to(torch.int32), dst),
        (out.transpose(0, 1).contiguous().transpose(0, 1), dst),
    ]
    for o, d in bad_in_place:
        with pytest.raises(ValueError):
            TD.doubles_final(*args, 64, o, d)


@pytest.mark.parametrize("row", [14, 40, -2])
def test_final_in_place_refuses_rows_outside_the_output(row):
    """A ``dst`` row outside [-1, B) raises ``IndexError`` on the CPU and
    writes nothing, as the kernel refuses it on the card (the card's case
    is in tests/test_torch_cuda.py)."""
    vecs, die, mirror = _positions(9, 12, "bearoff")
    d, mi = tt(die), tt(mirror)
    l1 = TD.doubles_level_plain(tt(vecs)[:, None, :], None, None, d, mi, 16)
    l2 = TD.doubles_level_plain(*l1, d, mi, 32)
    l3 = TD.doubles_level_plain(*l2, d, mi, 48)
    args = (l1[0], l1[2], l2[0], l2[2], *l3, d, mi)
    dst = torch.tensor([5, -1, 0, 7, 2, -1, 9, 11, 1, 3, -1, row],
                       dtype=torch.int32)
    out = torch.full((14, 64, 52), 9, dtype=torch.int8)
    with pytest.raises(IndexError):
        TD.doubles_final(*args, 64, out, dst)
    assert bool((out == 9).all())
