"""The port's CUDA kernels on the card (``csrc/compaction.cu``,
``csrc/doubles.cu``, ``csrc/nondoubles.cu``, ``csrc/afterstate.cu``,
``csrc/dense.cu``, ``csrc/adam.cu``).

Every test here needs an NVIDIA card and skips without one: a CUDA
kernel has no CPU mode.  The file imports neither JAX nor the JAX
package, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` configures JAX).  This is
where each kernel is held against its plain version on inputs made up for
the test, at the shapes the program's paths call it with and at edge
shapes; ``chip_smoke.py`` runs the program's own paths on the card.  The
CPU parity of the plain versions with the JAX package is in
``tests/test_torch_compaction.py``, ``tests/test_torch_dedup.py`` (the
plain non-doubles dedup), ``tests/test_torch_doubles.py``,
``tests/test_torch_nondoubles.py`` and ``tests/test_torch_afterstate.py``;
the optimizer's wrapper on the CPU is ``tests/test_torch_adam.py``."""

import copy
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mlp_ppo_2ply_p3_tpu_torch.core import movegen as TM
from mlp_ppo_2ply_p3_tpu_torch.env import bg_env as TE
from mlp_ppo_2ply_p3_tpu_torch.ops import afterstate as TAS
from mlp_ppo_2ply_p3_tpu_torch.ops import compaction as TC
from mlp_ppo_2ply_p3_tpu_torch.ops import dense as TDN
from mlp_ppo_2ply_p3_tpu_torch.ops import doubles as TD
from mlp_ppo_2ply_p3_tpu_torch.ops import nondoubles as TN

pytestmark = pytest.mark.cuda

# (B, N, C, k_out, fraction valid): N not a multiple of 8 / 32 / 128 /
# 256, B = 1, counts above and below k_out, k_out = 0, every main-path
# call shape of train4096, and the split-N layout (B small, N large: B = 1
# with N in the tens of thousands, counts crossing k_out inside a tile)
CASES = [
    (1, 1, 1, 1, 1.0),
    (1, 5, 3, 4, 0.7),
    (1, 4096, 55, 3604, 0.8),
    (3, 37, 52, 16, 0.5),
    (9, 130, 53, 40, 0.5),
    (5, 300, 7, 400, 0.4),
    (6, 257, 1, 33, 0.2),
    (4, 50, 2, 0, 0.5),
    (875, 5184, 53, 256, 0.03),
    (1, 4096, 54, 875, 0.17),
    (7208, 27, 52, 16, 0.3),
    (3604, 896, 52, 288, 0.12),
    (3604, 288, 52, 256, 0.12),
    (875, 2160, 53, 192, 0.04),
    (875, 27, 53, 16, 0.3),
    (875, 432, 53, 80, 0.08),
    (1, 40000, 52, 7001, 0.35),
    (1, 25001, 7, 1, 0.5),
    (3, 20000, 55, 20000, 0.9),
    (200, 1500, 13, 100, 0.2),
    (263, 1024, 4, 2000, 0.5),
    # the 2-ply reply movegen at a candidate chunk of 512 (twoply preset:
    # k2 128, k3 256, M' 512; output runs up to 27 KB), and L3/L4 of a
    # 32-game decision (256 rows: the split layout)
    (1024, 27, 52, 16, 0.3),
    (512, 896, 52, 512, 0.12),
    (512, 896, 52, 288, 0.12),
    (512, 27, 53, 16, 0.3),
    (512, 432, 53, 128, 0.3),
    (512, 3456, 53, 256, 0.08),
    (512, 6912, 53, 512, 0.08),
    (256, 3456, 53, 256, 0.08),
    (256, 6912, 53, 512, 0.3),
    # the non-doubles calls at the JAX package's game_chunk (2048) and at
    # the port's (8192, a B=4096 decision)
    (4096, 27, 52, 16, 0.3),
    (2048, 896, 52, 512, 0.12),
    (16384, 27, 52, 16, 0.3),
    (8192, 896, 52, 512, 0.12),
    # the doubles sub-batch split (games, 54) -> its capacity, a sixth of
    # the games doubles, at every batch the paths list moves for: the
    # arenas' 64 and 512 games, the league's 256, B=4096 at the default
    # widths, a data-parallel rank's 8192 and pod's 16384
    (1, 64, 54, 64, 0.17),
    (1, 256, 54, 256, 0.17),
    (1, 512, 54, 192, 0.17),
    (1, 4096, 54, 1088, 0.17),
    (1, 8192, 54, 2112, 0.17),
    (1, 16384, 54, 4160, 0.17),
]


@pytest.fixture
def card():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (a CUDA kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("b,n,c,k_out,frac", CASES)
def test_kernel_matches_plain(card, b, n, c, k_out, frac):
    rng = np.random.default_rng(b * 1000 + n)
    payload = torch.from_numpy(
        rng.integers(-128, 128, (b, n, c)).astype(np.int8)).to(card)
    flags = rng.random((b, n)) < frac
    if b > 2:
        flags[1] = False
        flags[2] = True
    valid = torch.from_numpy(flags).to(card)
    before = TC.compact_rows.launches
    out, count = TC.compact_rows(payload, valid, k_out)
    assert TC.compact_rows.launches == before + 1
    want_out, want_count = TC.compact_rows_plain(payload, valid, k_out)
    torch.cuda.synchronize()
    assert torch.equal(out, want_out) and torch.equal(count, want_count)
    # uint8 flags take the same kernel
    out8, _ = TC.compact_rows(payload, valid.to(torch.uint8), k_out)
    assert torch.equal(out8, want_out)


def test_kernel_on_views_at_odd_offsets(card):
    """Payload and flags that start at odd addresses (contiguous views
    into larger buffers): the kernel copies bytes, and reads flags from
    the aligned 16-byte blocks around them."""
    rng = np.random.default_rng(21)
    for b, n, c, k_out in ((1, 5000, 52, 900), (50, 300, 52, 64),
                           (40, 27, 52, 16)):
        pay_all = torch.from_numpy(
            rng.integers(-128, 128, b * n * c + 3).astype(np.int8)).to(card)
        flag_all = torch.from_numpy(rng.random(b * n + 5) < 0.4).to(card)
        payload = pay_all[3:].view(b, n, c)
        valid = flag_all[5:].view(b, n)
        out, count = TC.compact_rows(payload, valid, k_out)
        want_out, want_count = TC.compact_rows_plain(payload, valid, k_out)
        torch.cuda.synchronize()
        assert torch.equal(out, want_out) and torch.equal(count, want_count)


def test_kernel_rejects_bad_inputs(card):
    payload = torch.zeros((2, 8, 3), dtype=torch.int8, device=card)
    valid = torch.zeros((2, 8), dtype=torch.bool, device=card)
    with pytest.raises(TypeError):
        TC.compact_rows(payload.float(), valid, 4)
    with pytest.raises(ValueError):
        TC.compact_rows(payload.transpose(1, 2).contiguous().transpose(1, 2),
                        valid, 4)
    with pytest.raises(ValueError):
        TC.compact_rows(payload, valid.cpu(), 4)


def _doubles_board(my=None, opp=None, bar=0, off=0):
    b = np.zeros(52, np.int8)
    for p, c in (my or {}).items():
        b[p] = c
    for p, c in (opp or {}).items():
        b[24 + p] = c
    b[48], b[50] = bar, off
    return b


# canonical boards that reach every slot kind (the CPU file
# tests/test_torch_doubles.py holds the same ones against JAX): entry on
# a blot, a block and open points; every entry blocked; bear-off exact
# from the farthest point, overshooting, and exact from a nearer point;
# game over; a sub-batch's all-zero padding row
DOUBLES_BOARDS = [
    _doubles_board({5: 6, 12: 5, 16: 2}, {0: 1, 1: 2, 3: 3, 10: 1}, bar=2),
    _doubles_board({12: 14}, {p: 2 for p in range(6)}, bar=1),
    _doubles_board({20: 3, 22: 2, 23: 1}, {3: 2}, off=9),
    _doubles_board({18: 1, 21: 2, 23: 4}, {}, off=8),
    _doubles_board({}, {4: 2}, off=15),
    _doubles_board(),
]


def _edge_roots(card):
    """(vecs, die, mirror) of 72 doubles games: each of DOUBLES_BOARDS 12
    times, with every die unmirrored and mirrored (the padding board with
    die 0)."""
    vecs = torch.from_numpy(np.stack(DOUBLES_BOARDS)).to(card)
    vecs = vecs.repeat_interleave(12, dim=0).contiguous()
    die = torch.arange(1, 7, dtype=torch.int32, device=card).repeat(12)
    die[-12:] = 0
    mirror = (torch.arange(72, device=card) % 12) >= 6
    return vecs, die, mirror


def _doubles_frontier(seed, g, k, root):
    """Random (G, K, 52) frontier rows: sparse counts (some negative,
    which the rules never make), some rows on the bar, half of them all
    home, a tenth game over, the edge boards above spread in; parent ranks
    with many bars; ragged valid counts (some above K); dice 0..6 (a die 0
    game is all-zero padding); mirrored games."""
    r = np.random.default_rng(seed)
    b = r.integers(-2, 16, (g, k, 52)).astype(np.int8)
    b[:, :, :48] *= r.random((g, k, 48)) < 0.4
    b[:, :, 48] *= r.random((g, k)) < 0.3
    b[r.random((g, k)) < 0.5, :18] = 0
    b[:, :, 50] = np.where(r.random((g, k)) < 0.1, 15, b[:, :, 50] % 15)
    edge = r.integers(0, len(DOUBLES_BOARDS), (g, k))
    pick = r.random((g, k)) < 0.2
    b[pick] = np.stack(DOUBLES_BOARDS)[edge[pick]]
    ranks = r.integers(-128, 25, (g, k)).astype(np.int8)
    ranks[r.random((g, k)) < 0.4] = -1
    n_in = r.integers(0, k + 3, g).astype(np.int32)
    die = r.integers(1, 7, g).astype(np.int32)
    pad = r.random(g) < 0.1
    b[pad], die[pad] = 0, 0
    mirror = r.random(g) < 0.5
    if root:
        return b[:, :1], None, None, die, mirror
    return b, ranks, n_in, die, mirror


# (G, kind, (k1, k2, k3)): train4096's doubles sub-batch at fast() and
# the default widths (875 and 1088 games), pod's (B=16384: 4160 games), the
# league's 256 games and the 512-game arena's 192-game sub-batch, the
# 2-ply reply widths (512 games, k2 128, k3 256), the parity widths, widths
# that truncate each level, an empty L3, and the edge boards with every die
LEVELS_CASES = [
    (875, "played", (16, 80, 192)),
    (875, "random", (16, 80, 192)),
    (1088, "played", (16, 96, 224)),
    (4160, "played", (16, 96, 224)),
    (256, "random", (16, 80, 192)),
    (192, "random", (16, 96, 224)),
    (72, "edge", (16, 80, 192)),
    (512, "played", (16, 128, 256)),
    (64, "random", (16, 128, 512)),
    (300, "random", (3, 5, 7)),
    (300, "played", (16, 6, 40)),
    (40, "random", (16, 30, 0)),
]


def _levels_inputs(card, seed, g, kind):
    """(vecs, die, mirror) on the card: ``played`` boards after random env
    steps with random dice, ``random`` roots (``_doubles_frontier``'s:
    negative counts, bars, bear-offs, game over, the edge boards, padding
    rows of die 0, mirrored games), or the ``edge`` boards with every
    die (``_edge_roots``)."""
    if kind == "edge":
        return _edge_roots(card)
    if kind == "played":
        vecs, dice, mirror = _played(card, g, 12, seed)
        return (vecs.contiguous(), dice[:, 0].to(torch.int32).contiguous(),
                mirror.contiguous())
    b, _, _, die, mirror = _doubles_frontier(seed, g, 1, True)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(card)
                 for x in (b[:, 0], die, mirror))


@pytest.mark.parametrize("g,kind,widths", LEVELS_CASES)
def test_doubles_level_matches_plain(card, g, kind, widths):
    """The fused L1-L3 launch against the three plain levels: every
    frontier with its zero tail, L3's ranks and the unclamped counts."""
    args = _levels_inputs(card, g + sum(widths), g, kind)
    before = TD.doubles_levels.launches
    got = TD.doubles_levels(*args, *widths)
    assert TD.doubles_levels.launches == before + 1
    want = TD.doubles_levels_plain(*args, *widths)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert int(want[1].sum()) > 0
    # uint8 mirror flags and roots at an odd address take the same kernel
    raw = torch.zeros(args[0].numel() + 3, dtype=torch.int8, device=card)
    raw[3:] = args[0].reshape(-1)
    odd = raw[3:].view(args[0].shape)
    got = TD.doubles_levels(odd, args[1], args[2].to(torch.uint8), *widths)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_doubles_levels_on_played_boards(card):
    """The fused levels and the final one at ``fast()``'s widths on the
    boards of 900 games after a few random env steps, every game given a
    double: kernel == plain at each launch, on the plain's own inputs."""
    cfg = TE.EnvConfig(movegen=TM.MovegenConfig.fast(256))
    vecs, dice, mirror = _played(card, 900, 10, 5, cfg)
    die = dice[:, 0].to(torch.int32).contiguous()
    mirror = mirror.contiguous()
    mg = cfg.movegen
    widths = (mg.k1, mg.k2, mg.k3)
    got = TD.doubles_levels(vecs.contiguous(), die, mirror, *widths)
    want = TD.doubles_levels_plain(vecs, die, mirror, *widths)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    final = TD.doubles_final(*want, die, mirror, mg.max_moves)
    for x, y in zip(final, TD.doubles_final_plain(*want, die, mirror,
                                                  mg.max_moves)):
        assert torch.equal(x, y)
    assert int(want[6].sum()) > 0


def test_doubles_level_rejects_bad_inputs(card):
    vecs = torch.zeros((2, 52), dtype=torch.int8, device=card)
    die = torch.ones((2,), dtype=torch.int32, device=card)
    mirror = torch.zeros((2,), dtype=torch.bool, device=card)
    with pytest.raises(ValueError):
        TD.doubles_levels(vecs.int(), die, mirror, 16, 80, 192)
    with pytest.raises(ValueError):
        TD.doubles_levels(vecs, die.cpu(), mirror, 16, 80, 192)
    with pytest.raises(ValueError):
        TD.doubles_levels(vecs, die.long(), mirror, 16, 80, 192)
    with pytest.raises(ValueError):
        TD.doubles_levels(vecs[:, ::2], die, mirror, 16, 80, 192)
    # more shared memory than a block may have: no fallback
    with pytest.raises(RuntimeError):
        TD.doubles_levels(vecs, die, mirror, 16, 80, 60000)
    with pytest.raises(RuntimeError):
        TD.doubles_levels(vecs, die, mirror, 16, 5000, 192)


# every movegen kernel wrapper and its plain version, then the afterstate
# pass's two, in the order of agents/twoply.py::launches_per_decision
WRAPPERS = ((TC, "compact_rows"), (TD, "doubles_levels"),
            (TN, "nondoubles_batch"), (TD, "doubles_final"))
AFTERSTATE = ((TAS, "afterstate_eval"), (TAS, "afterstate_eval_backward"))
DEEP = ((TAS, "afterstate_hidden"), (TAS, "afterstate_hidden_backward"),
        (TDN, "dense_layers"), (TDN, "dense_layers_backward"))
ROUTED = DEEP + ((TAS, "afterstate_route"),)


def _launches(wrappers=WRAPPERS):
    return {name: getattr(m, name).launches for m, name in wrappers}


def _plain_wrappers(monkeypatch):
    """The movegen kernels' plain versions in their place (the afterstate
    pass keeps its kernel: it is deterministic, so both paths score the
    same boards to the same bits)."""
    for m, name in WRAPPERS:
        monkeypatch.setattr(m, name, getattr(m, name + "_plain"))


def _played(card, batch, steps, seed, cfg=None):
    """Canonical boards, dice and mirror flags of ``batch`` games after
    ``steps`` random-play env steps."""
    from mlp_ppo_2ply_p3_tpu_torch.core import board

    cfg = cfg or TE.EnvConfig(movegen=TM.MovegenConfig.fast(256))
    gen = torch.Generator(device=card).manual_seed(seed)
    es = TE.reset(gen, cfg, batch, device=card)
    for _ in range(steps):
        u = torch.rand((batch,), generator=gen, device=card)
        es, _ = TE.step(es, (u * es.n_moves.clamp(min=1)).to(torch.int32),
                        gen, cfg)
    vecs = board.to_canonical(es.points, es.bar, es.off, es.turn)
    return vecs, es.dice, es.turn == 1


# the 15 non-double rolls as (high, low)
ROLLS = [(h, lo) for h in range(2, 7) for lo in range(1, h)]


def _nondoubles_inputs(card, seed, g, kind):
    """(vecs, d_hi, d_lo, mirror) on the card: ``played`` boards after
    random env steps, or ``random`` sparse boards (``_doubles_frontier``'s
    rows: negative counts, bars, bear-offs, game over, the edge boards);
    the 15 non-double rolls in turn, both mirrors, and a tenth of the
    games all-zero padding rows of dice (0, 0).  ``edge``: each of
    DOUBLES_BOARDS with every non-double roll, unmirrored and mirrored
    (``g`` = 180)."""
    if kind == "edge":
        rolls = torch.tensor(ROLLS, dtype=torch.int32, device=card)
        vecs = torch.from_numpy(np.stack(DOUBLES_BOARDS)).to(card)
        vecs = vecs.repeat_interleave(2 * len(ROLLS), dim=0).contiguous()
        hi, lo = (rolls[:, i].repeat(2 * len(DOUBLES_BOARDS)).contiguous()
                  for i in (0, 1))
        mirror = (torch.arange(g, device=card) // len(ROLLS)) % 2 == 1
        return vecs, hi, lo, mirror
    r = np.random.default_rng(seed)
    if kind == "played":
        vecs, _, _ = _played(card, g, 10, seed)
        vecs = vecs.cpu().numpy()
    else:
        vecs = _doubles_frontier(seed, g, 1, True)[0][:, 0]
    rolls = np.array(ROLLS, np.int32)[(np.arange(g) + seed) % 15]
    mirror = r.random(g) < 0.5
    pad = r.random(g) < 0.1
    vecs = np.where(pad[:, None], 0, vecs).astype(np.int8)
    rolls[pad] = 0
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(card)
                 for x in (vecs, rolls[:, 0], rolls[:, 1], mirror))


# (G, board kind, k1, kd, M, dedup): train4096's non-doubles sub-batch at
# fast() and the default widths, the parity widths (dynamic shared memory
# near 48 KB), the 2-ply reply widths (512 without dedup, 128 with),
# widths small enough to truncate the singles, the raw block and the list,
# and the edge boards with every roll
NONDOUBLES_CASES = [
    (180, "edge", 16, 288, 256, True),
    (3604, "played", 16, 288, 256, True),
    (3604, "played", 16, 384, 256, True),
    (900, "random", 16, 384, 256, True),
    (64, "played", 16, 512, 500, True),
    (300, "random", 16, 512, 500, True),
    (2048, "played", 16, 288, 512, False),
    (500, "random", 16, 288, 512, False),
    (2048, "played", 16, 288, 128, True),
    (400, "random", 4, 16, 4, True),
    (400, "played", 2, 8, 3, True),
    (400, "random", 3, 16, 5, False),
    (7, "random", 16, 0, 0, True),
]


@pytest.mark.parametrize("g,kind,k1,kd,m,dedup", NONDOUBLES_CASES)
def test_nondoubles_matches_plain(card, g, kind, k1, kd, m, dedup):
    args = _nondoubles_inputs(card, g + k1 + kd, g, kind)
    before = TN.nondoubles_batch.launches
    got = TN.nondoubles_batch(*args, k1, kd, m, dedup)
    assert TN.nondoubles_batch.launches == before + 1
    want = TN.nondoubles_batch_plain(*args, k1, kd, m, dedup)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)
    if m:
        assert int(want[1].sum()) > 0
    # uint8 mirror flags and boards at an odd address take the same kernel
    raw = torch.zeros(args[0].numel() + 3, dtype=torch.int8, device=card)
    raw[3:] = args[0].reshape(-1)
    odd = raw[3:].view(args[0].shape)
    got = TN.nondoubles_batch(odd, *args[1:3], args[3].to(torch.uint8), k1,
                              kd, m, dedup)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


# (B, board kind, widths): the in-place form at train4096's B=4096
# (fast() and the default widths), a reset (all rolls non-doubles: the
# slot clamp of the non-doubles capacity), pod's B=16384, the batches the
# league and the arenas run movegen at (256, 512 and 64 games), and widths
# that truncate the singles, the raw block and the list, with the dedup
# and without it
IN_PLACE_CASES = [
    (4096, "played", dict()),
    (4096, "reset", dict()),
    (4096, "played", dict(k2=96, k3=224, dedup_width=384, dbl_div=4,
                          dbl_add=64)),
    (16384, "played", dict(k2=96, k3=224, dedup_width=384, dbl_div=4,
                           dbl_add=64)),
    (256, "played", dict()),
    (512, "reset", dict()),
    (64, "random", dict()),
    (600, "random", dict(max_moves=4, k1=4, dedup_width=12)),
    (600, "random", dict(max_moves=5, k1=3, dedup_width=16, dedup=False)),
    (600, "reset", dict(dedup=False)),
]


def _in_place_args(card, b, kind, mg):
    """The in-place form's arguments as ``legal_afterstates_batch`` makes
    them (the doubles games' rows written in place by the plain final
    level on the plain doubles levels): ``played`` boards
    after random env steps, a fresh ``reset``, or ``random`` roots
    (``_doubles_frontier``'s) with random dice in 0..6."""
    seed = b + len(kind)
    if kind == "random":
        r = np.random.default_rng(seed)
        vecs = torch.from_numpy(_doubles_frontier(seed, b, 1, True)[0][:, 0])
        dice = torch.from_numpy(r.integers(0, 7, (b, 2)).astype(np.int8))
        mirror = torch.from_numpy(r.random(b) < 0.5)
        vecs, dice, mirror = vecs.to(card), dice.to(card), mirror.to(card)
    else:
        cfg = TE.EnvConfig(movegen=mg)
        vecs, dice, mirror = _played(card, b, 12 if kind == "played" else 0,
                                     seed, cfg)
    d0, d1 = dice[:, 0].to(torch.int32), dice[:, 1].to(torch.int32)
    is_double = d0 == d1
    bd, bn = TM.doubles_capacity(b, mg), TM.nondoubles_capacity(b, mg)
    (dv, dd, dm), _ = TM._compact_games((vecs, d0, mirror.to(torch.int8)),
                                        is_double, bd)
    dm = (dm > 0).contiguous()
    levels = TD.doubles_levels_plain(dv.contiguous(), dd, dm, mg.k1, mg.k2,
                                     mg.k3)
    src, fits, _, _, dst = TM._placement(is_double, bd, bn)
    out = torch.full((b, mg.max_moves, 52), -77, dtype=torch.int8,
                     device=card)
    _, db_n, db_of = TD.doubles_final_plain(*levels, dd, dm, mg.max_moves,
                                            out, dst)
    return ((vecs.contiguous(), torch.maximum(d0, d1), torch.minimum(d0, d1),
             mirror.contiguous(), mg.k1, mg.dedup_width, mg.max_moves,
             mg.dedup), (src, fits, dst, db_n, db_of), out)


@pytest.mark.parametrize("b,kind,widths", IN_PLACE_CASES)
def test_nondoubles_in_place_matches_plain(card, b, kind, widths):
    """The in-place form against its plain version, bit for bit: every
    row of the (B, M, 52) output with its zero tail, the counts and the
    flags; then with the boards at an odd address and uint8 flags."""
    mg = TM.MovegenConfig(**{**dataclasses.asdict(
        TM.MovegenConfig.fast(256)), **widths})
    args, place, out = _in_place_args(card, b, kind, mg)
    before = TN.nondoubles_batch.launches
    got = TN.nondoubles_batch(*args, place, out.clone())
    assert TN.nondoubles_batch.launches == before + 1
    want = TN.nondoubles_place_plain(*args, place, out.clone())
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)
    src, fits = place[:2]
    if kind == "reset" and b >= 512:
        assert bool((~fits & (src >= 0)).any())    # the slot clamp
    assert bool((src < 0).any()) or kind == "reset"
    raw = torch.zeros(args[0].numel() + 3, dtype=torch.int8, device=card)
    raw[3:] = args[0].reshape(-1)
    odd = (raw[3:].view(args[0].shape), *args[1:3],
           args[3].to(torch.uint8), *args[4:])
    u8 = (*place[:4], place[4].to(torch.uint8))
    for x, y in zip(TN.nondoubles_batch(*odd, u8, out.clone()), want):
        assert torch.equal(x, y)


def test_movegen_past_the_doubles_capacity(card, monkeypatch):
    """Doubles only at B=600 (``fast()``: 176 fit), on boards after a few
    random env steps: the kernel path equals the plain path and the CPU;
    each game past the doubles capacity carries the row that
    ``doubles_final`` wrote for the last fitting one (the non-doubles
    kernel copies it from the output itself), n = 0 and the flag."""
    mg = TM.MovegenConfig.fast(256)
    vecs, dice, mirror = _played(card, 600, 10, 600, TE.EnvConfig(movegen=mg))
    dice = torch.stack([dice[:, 0], dice[:, 0]], 1).contiguous()
    args = (vecs, dice, mg, mirror)
    before = _launches()
    got = TM.legal_afterstates_batch(*args)
    counted = {k: v - before[k] for k, v in _launches().items()}
    assert counted == {"compact_rows": 1, "doubles_levels": 1,
                       "nondoubles_batch": 1, "doubles_final": 1}
    cpu = TM.legal_afterstates_batch(*(a.cpu() if torch.is_tensor(a) else a
                                       for a in args))
    _plain_wrappers(monkeypatch)
    plain = TM.legal_afterstates_batch(*args)
    torch.cuda.synchronize()
    for g, p, c in zip(got, plain, cpu):
        assert torch.equal(g, p) and torch.equal(g.cpu(), c)
    bd = TM.doubles_capacity(600, mg)
    assert bd == 176
    assert torch.equal(got[0][bd:], got[0][bd - 1].expand(600 - bd, -1, -1))
    assert int(got[1][bd:].abs().sum()) == 0 and bool(got[2][bd:].all())
    assert int(got[1][:bd].sum()) > 0


def test_movegen_in_place_in_a_cuda_graph(card):
    """One movegen call at B=4096 on a reset (the slot clamp binds)
    captured in a CUDA graph and replayed equals the eager call: the
    placement needs no host sync."""
    vecs, dice, mg = _movegen_args(card, 4096)
    want = TM.legal_afterstates_batch(vecs, dice, mg)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        TM.legal_afterstates_batch(vecs, dice, mg)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = TM.legal_afterstates_batch(vecs, dice, mg)
    graph.replay()
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert int(want[1].sum()) > 0 and bool(want[2].any())


def test_nondoubles_rejects_bad_inputs(card):
    vecs = torch.zeros((4, 52), dtype=torch.int8, device=card)
    d = torch.ones((4,), dtype=torch.int32, device=card)
    mirror = torch.zeros((4,), dtype=torch.bool, device=card)
    with pytest.raises(ValueError):
        TN.nondoubles_batch(vecs.int(), d, d, mirror, 16, 288, 256, True)
    with pytest.raises(ValueError):
        TN.nondoubles_batch(vecs, d.cpu(), d, mirror, 16, 288, 256, True)
    with pytest.raises(ValueError):
        TN.nondoubles_batch(vecs, d.long(), d, mirror, 16, 288, 256, True)
    with pytest.raises(ValueError):
        TN.nondoubles_batch(vecs[:, ::2], d, d, mirror, 16, 288, 256, True)
    # more shared memory than a block may have: no fallback
    with pytest.raises(RuntimeError):
        TN.nondoubles_batch(vecs, d, d, mirror, 16, 8000, 256, True)
    with pytest.raises(RuntimeError):
        TN.nondoubles_batch(vecs, d, d, mirror, 16, 288, 60000, False)
    # the in-place form's inputs
    db = (torch.full((3,), -1, dtype=torch.int32, device=card),
          torch.zeros((3,), dtype=torch.int32, device=card),
          torch.zeros((3,), dtype=torch.bool, device=card))
    src = torch.arange(4, dtype=torch.int32, device=card)
    fits = torch.ones((4,), dtype=torch.bool, device=card)
    out = torch.empty((4, 256, 52), dtype=torch.int8, device=card)
    for place, o in (((src.long(), fits, *db), out),
                     ((src, fits[:3], *db), out),
                     ((src, fits, db[0].long(), *db[1:]), out),
                     ((src.cpu(), fits, *db), out),
                     ((src, fits, db[0], db[1].long(), db[2]), out),
                     ((src, fits, *db), None), ((src, fits, *db), out.cpu()),
                     ((src, fits, *db), out[:, :128].contiguous())):
        with pytest.raises(ValueError):
            TN.nondoubles_batch(vecs, d, d, mirror, 16, 288, 256, True,
                                place, o)


def _final_inputs(card, seed, g, kind, widths):
    """The inputs of ``doubles_final``: ``played`` boards' (or the
    ``edge`` boards', ``_edge_roots``) first three doubles levels (plain)
    at ``widths`` (k1, k2, k3), or ``random`` frontiers of those widths
    with random counts (0, within and above each width) and L1/L2 rows
    that the kernel must copy as they are."""
    k1, k2, k3 = widths
    if kind in ("played", "edge"):
        if kind == "edge":
            vecs, die, mirror = _edge_roots(card)
        else:
            vecs, dice, mirror = _played(card, g, 12, seed)
            die = dice[:, 0].to(torch.int32).contiguous()
            mirror = mirror.contiguous()
        level = (vecs[:, None, :].contiguous(), None, None)
        frontiers = []
        for k in widths:
            level = TD.doubles_level_plain(*level, die, mirror, k)
            frontiers.append(level)
        (f1b, _, n1), (f2b, _, n2), (f3b, f3r, n3) = frontiers
        return f1b, n1, f2b, n2, f3b, f3r, n3, die, mirror
    r = np.random.default_rng(seed)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(card)
    f3b, f3r, n3, die, mirror = _doubles_frontier(seed, g, k3, False)
    f1b = r.integers(-2, 16, (g, k1, 52)).astype(np.int8)
    f2b = r.integers(-2, 16, (g, k2, 52)).astype(np.int8)
    n1 = r.integers(0, k1 + 3, g).astype(np.int32)
    n2 = np.where(r.random(g) < 0.3, 0, r.integers(0, k2 + 3, g))
    n3 = np.where(r.random(g) < 0.3, 0, n3)
    return (t(f1b), t(n1), t(f2b), t(n2.astype(np.int32)), t(f3b), t(f3r),
            t(n3.astype(np.int32)), t(die), t(mirror))


# (G, kind, (k1, k2, k3), M): train4096's doubles sub-batch at fast() and
# the default widths, pod's, the 2-ply reply widths (512), the parity
# widths, L3 wider than M, k3 small enough that n3 exceeds it, and the
# edge boards with every die
FINAL_CASES = [
    (875, "played", (16, 80, 192), 256),
    (1088, "played", (16, 96, 224), 256),
    (4160, "played", (16, 96, 224), 256),
    (72, "edge", (16, 80, 192), 256),
    (512, "played", (16, 128, 256), 512),
    (64, "played", (16, 128, 512), 500),
    (300, "random", (16, 80, 192), 256),
    (300, "random", (16, 96, 300), 100),
    (200, "random", (5, 7, 9), 30),
    (200, "played", (16, 4, 3), 8),
    (40, "random", (16, 30, 40), 0),
]


@pytest.mark.parametrize("g,kind,widths,m", FINAL_CASES)
def test_doubles_final_matches_plain(card, g, kind, widths, m):
    args = _final_inputs(card, g + m, g, kind, widths)
    before = TD.doubles_final.launches
    got = TD.doubles_final(*args, m)
    assert TD.doubles_final.launches == before + 1
    want = TD.doubles_final_plain(*args, m)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)
    # L3 at an odd address and uint8 mirror flags take the same kernel
    raw = torch.zeros(args[4].numel() + 3, dtype=torch.int8, device=card)
    raw[3:] = args[4].reshape(-1)
    odd = (*args[:4], raw[3:].view(args[4].shape), *args[5:8],
           args[8].to(torch.uint8))
    for x, y in zip(TD.doubles_final(*odd, m), want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("g,kind,widths,m", FINAL_CASES)
def test_doubles_final_in_place_matches_plain(card, g, kind, widths, m):
    """The in-place form: slot g's list at row dst[g] of a wider (B, M, 52)
    output, dst a random permutation with a fifth of the slots empty (-1);
    kernel == plain bit for bit over the whole output (the rows no slot
    names stay as they were), the counts and the flags (0 at an empty
    slot); then L3 at an odd address, uint8 mirror flags and the output
    at an odd row offset."""
    args = _final_inputs(card, g + m + 1, g, kind, widths)
    r = np.random.default_rng(g + m)
    b = g + g // 3
    rows = r.permutation(b)[:g].astype(np.int32)
    rows[r.random(g) < 0.2] = -1
    dst = torch.from_numpy(rows).to(card)
    base = torch.randint(-128, 128, (b, m, 52), dtype=torch.int8,
                         device=card)
    before = TD.doubles_final.launches
    out = base.clone()
    got = TD.doubles_final(*args, m, out, dst)
    assert TD.doubles_final.launches == before + 1 and got[0] is out
    want = TD.doubles_final_plain(*args, m, base.clone(), dst)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert bool((dst < 0).any())
    raw = torch.zeros(args[4].numel() + 3, dtype=torch.int8, device=card)
    raw[3:] = args[4].reshape(-1)
    odd = (*args[:4], raw[3:].view(args[4].shape), *args[5:8],
           args[8].to(torch.uint8))
    shifted = torch.full((b + 1, m, 52), 7, dtype=torch.int8, device=card)
    shifted[1:] = base
    got = TD.doubles_final(*odd, m, shifted[1:], dst)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert bool((shifted[0] == 7).all())


# A doubles_final call in place whose dst holds a row outside [-1, B): the
# kernel traps, which leaves the CUDA context unusable, so it runs in a
# process of its own, after a call with valid rows
BAD_ROW = r"""
import sys
import torch
from mlp_ppo_2ply_p3_tpu_torch.ops import doubles as TD

dev = torch.device("cuda", 0)
g, m, b = 4, 64, 6


def z(*shape, dtype=torch.int8):
    return torch.zeros(shape, dtype=dtype, device=dev)


args = (z(g, 16, 52), z(g, dtype=torch.int32), z(g, 32, 52),
        z(g, dtype=torch.int32), z(g, 48, 52), z(g, 48),
        z(g, dtype=torch.int32), torch.full((g,), 3, dtype=torch.int32,
                                            device=dev),
        z(g, dtype=torch.bool))
out = torch.full((b, m, 52), 9, dtype=torch.int8, device=dev)
for row, said in ((3, "valid rows: done"), (int(sys.argv[1]), "bad: done")):
    dst = torch.tensor([0, -1, row, 2], dtype=torch.int32, device=dev)
    TD.doubles_final(*args, m, out, dst)
    torch.cuda.synchronize()
    print(said, flush=True)
"""


@pytest.mark.parametrize("row", [6, -2])
def test_doubles_final_in_place_refuses_rows_outside_the_output(card, row):
    """On the card, as on the CPU (``IndexError``), a ``dst`` row outside
    [-1, B) fails: the kernel traps before it writes (B = 6, so row 6
    would land past the output's end), and the error surfaces at the next
    synchronize."""
    proc = subprocess.run([sys.executable, "-c", BAD_ROW, str(row)],
                          cwd=Path(__file__).resolve().parents[1],
                          capture_output=True, text=True, timeout=300)
    assert "valid rows: done" in proc.stdout, proc.stderr[-2000:]
    assert "bad: done" not in proc.stdout
    assert proc.returncode != 0


def test_movegen_kernel_path_matches_plain_and_cpu(card, monkeypatch):
    """B=600 (>= 512: the sub-batch partition is active) on boards from
    a few random-play env steps."""
    cfg = TE.EnvConfig(movegen=TM.MovegenConfig.fast(256))
    gen = torch.Generator(device=card).manual_seed(0)
    es = TE.reset(gen, cfg, 600, device=card)
    for _ in range(8):
        u = torch.rand((600,), generator=gen, device=card)
        es, _ = TE.step(es, (u * es.n_moves.clamp(min=1)).to(torch.int32),
                        gen, cfg)
    from mlp_ppo_2ply_p3_tpu_torch.core import board
    vecs = board.to_canonical(es.points, es.bar, es.off, es.turn)
    args = (vecs, es.dice, cfg.movegen, es.turn == 1)
    before = _launches()
    got = TM.legal_afterstates_batch(*args)
    counted = {k: v - before[k] for k, v in _launches().items()}
    assert counted == {"compact_rows": 1, "doubles_levels": 1,
                       "nondoubles_batch": 1, "doubles_final": 1}
    assert counted == {
        "compact_rows": TM.compactions_per_call(cfg.movegen),
        "doubles_levels": TM.doubles_levels_per_call(cfg.movegen),
        "nondoubles_batch": TM.nondoubles_per_call(cfg.movegen),
        "doubles_final": TM.doubles_finals_per_call(cfg.movegen)}
    cpu = TM.legal_afterstates_batch(*(a.cpu() if torch.is_tensor(a) else a
                                       for a in args))
    _plain_wrappers(monkeypatch)
    plain = TM.legal_afterstates_batch(*args)
    torch.cuda.synchronize()
    for g, p, c in zip(got, plain, cpu):
        assert torch.equal(g, p) and torch.equal(g.cpu(), c)


@pytest.mark.parametrize("width", [512, 128])
def test_twoply_kernel_path_matches_plain(card, monkeypatch, width):
    """One 2-ply decision over 32 games (the twoply preset on frozen_v1,
    positions after 12 random env steps): the kernel path equals the
    plain path bit for bit, with the launches of the formula; width 128
    takes the reply dedup branch."""
    from mlp_ppo_2ply_p3_tpu_torch.agents import frozen, twoply
    from mlp_ppo_2ply_p3_tpu_torch.utils.config import get_preset

    cfg = get_preset("twoply")
    scfg = dataclasses.replace(cfg.search, reply_max_moves=width)
    model, _ = frozen.load_frozen(device=card)
    gen = torch.Generator(device=card).manual_seed(1)
    es = TE.reset(gen, cfg.env, 32, device=card)
    for _ in range(12):
        u = torch.rand((32,), generator=gen, device=card)
        es, _ = TE.step(es, (u * es.n_moves.clamp(min=1)).to(torch.int32),
                        gen, cfg.env)
    before = _launches(WRAPPERS + AFTERSTATE)
    got = twoply.twoply_actions_values(model, es, scfg)
    counted = tuple(v - before[k] for k, v in
                    _launches(WRAPPERS + AFTERSTATE).items())
    assert counted == twoply.launches_per_decision(32, scfg)
    assert counted[2] > 0 and counted[3] > 0 and counted[4] > 0
    _plain_wrappers(monkeypatch)
    plain = twoply.twoply_actions_values(model, es, scfg)
    torch.cuda.synchronize()
    for g, p in zip(got, plain):
        assert torch.equal(g, p)


# --- the afterstate pass (csrc/afterstate.cu) --------------------------------


def afterstate_inputs(card, seed, r, m, hidden, dtype=torch.float32):
    """Random (r, m, 52) int8 boards (sparse small counts on the points,
    bars, borne-off counts, a few negative bytes, a tenth all-zero rows),
    movers 0 and 1 (and one 2), n with 0, m and values between; random
    float32 weights of ``hidden`` units (fc1 and one head); bfloat16
    weights at ``nn.Linear``'s scale, U(-1/sqrt(fan in), 1/sqrt(fan in)),
    as a model that computes in bf16 has them."""
    rng = np.random.default_rng(seed)
    pts = rng.integers(1, 16, (r, m, 48)) * (rng.random((r, m, 48)) < 0.25)
    tail = np.concatenate([rng.integers(0, 4, (r, m, 2)),
                           rng.integers(0, 16, (r, m, 2))], axis=2)
    boards = np.concatenate([pts, tail], axis=2).astype(np.int8)
    boards[rng.random((r, m, 52)) < 0.002] = -3
    boards[rng.random((r, m)) < 0.1] = 0
    mover = rng.integers(0, 2, r).astype(np.int32)
    mover[r // 2:r // 2 + 1] = 2
    n = rng.integers(0, m + 1, r).astype(np.int32)
    n[::7] = 0
    n[1::5] = m
    if dtype == torch.float32:
        w = [rng.standard_normal(shape).astype(np.float32) * scale
             for shape, scale in (((hidden, 198), 0.2), ((hidden,), 0.1),
                                  ((1, hidden), 0.2), ((1,), 0.1))]
    else:
        w = [rng.uniform(-1, 1, shape).astype(np.float32) / np.sqrt(fan_in)
             for shape, fan_in in (((hidden, 198), 198), ((hidden,), 198),
                                   ((1, hidden), hidden), ((1,), hidden))]
    out = [torch.from_numpy(x).to(card) for x in (boards, mover, n, *w)]
    return out[:3] + [x.to(dtype) for x in out[3:]]


# bf16 forms against the plain version (torch's bf16 linear rounds once
# after the bias, the kernels where JAX does): within 1e-2 of the largest
# kept value (at least 1), under test_torch_models.py's bf16 2e-2
BF16_TOL = 1e-2
NUDGE_FACTOR = 4.0


def nudged_up(w):
    """Every weight one ulp up, in its own dtype (bf16 by its bits)."""
    if w.dtype != torch.bfloat16:
        return torch.nextafter(w, torch.full_like(w, np.inf))
    b = w.view(torch.int16)
    up = torch.where(w > 0, b + 1, torch.where(w < 0, b - 1,
                                                torch.ones_like(b)))
    return up.view(torch.bfloat16)


def forward_tol(args, want):
    """The forward's gate against the plain version: float32 1e-5 up to
    256 units; past 256, 4 times the largest drift that a one-ulp nudge of
    the weights makes of the plain version's kept values; bf16 BF16_TOL
    of the largest kept value (at least 1)."""
    special = (want == TAS.FLOOR) | (want == TAS.POS_INF)
    kept = want[~special]
    if args[3].dtype == torch.bfloat16:
        scale = max(1.0, float(kept.abs().max())) if kept.numel() else 1.0
        return BF16_TOL * scale
    if args[3].shape[0] <= 256:
        return 1e-5
    nudged = TAS.afterstate_eval_plain(
        *args[:3], *(nudged_up(w) for w in args[3:7]), *args[7:])
    drift = (nudged - want)[~special]
    return NUDGE_FACTOR * (float(drift.abs().max()) if drift.numel() else 0)


def backward_within(args, grad, got, want):
    """The backward's gate: float32 up to 256 units, each gradient within
    1e-5 of its norm; past 256 and in bf16 the four gradients' distance
    from the plain ones at most 4 times the distance that a one-ulp nudge
    of the weights (in their dtype) moves the plain ones."""
    if args[3].dtype == torch.float32 and args[3].shape[0] <= 256:
        return all(float((g - w).abs().max())
                   <= 1e-5 * max(float(w.norm()), 1e-30)
                   for g, w in zip(got, want))
    nudged = TAS.afterstate_eval_backward_plain(
        *args[:3], *(nudged_up(w) for w in args[3:7]), *args[7:], grad)

    def dist(xs, ys):
        return sum(float(((x.double() - y.double()) ** 2).sum())
                   for x, y in zip(xs, ys)) ** 0.5

    return dist(got, want) <= NUDGE_FACTOR * dist(nudged, want)


# (R, M, hidden, epilogue, opponent view, sign): odd shapes, both widths,
# every epilogue and view, empty batches; then every path's shape: the
# rollout's (4096, 256) at both widths, a minibatch's (8192, 256), the
# league's and the arenas' 1-ply (256 and 512 games), the score-head
# policy, the dances (top-k 8), and the 2-ply replies at a B=256
# decision's candidate chunk (2048) at both reply widths and at a B=4096
# decision's (8192)
AFTERSTATE_CASES = [
    (37, 29, 128, "logits", False, 1.0),
    (37, 29, 256, "masked", True, -1.0),
    (300, 256, 128, "logits", False, 1.0),
    (301, 255, 256, "masked", False, 1.0),
    (257, 256, 128, "masked", True, -1.0),
    (1, 1, 128, "min", True, 1.0),
    (513, 512, 128, "min", True, 1.0),
    (64, 8, 256, "min", False, 1.0),
    (0, 5, 128, "logits", False, 1.0),
    (5, 0, 128, "min", True, 1.0),
    (301, 255, 256, "logits", False, 1.0),
    (513, 511, 256, "min", False, 1.0),
    (4096, 256, 128, "logits", False, 1.0),
    (4096, 256, 256, "logits", False, 1.0),
    (8192, 256, 128, "logits", False, 1.0),
    (256, 256, 128, "masked", True, -1.0),
    (512, 256, 128, "masked", True, -1.0),
    (256, 256, 256, "masked", False, 1.0),
    (256, 8, 128, "masked", False, 1.0),
    (2048, 512, 128, "min", True, 1.0),
    (2048, 128, 128, "min", True, 1.0),
    (8192, 512, 128, "min", True, 1.0),
]
# every other width (a part of a group, a pair with padding, 3 to 8
# groups) and bf16, with every epilogue and view and odd shapes; the
# rollout and a minibatch at hidden 512 (run_learning --hidden 512) and in
# bf16, the league's 1-ply and the replies at 512 and in bf16, the dances
# at 64 and a reply chunk at 100: (R, M, hidden, epilogue, opponent view,
# sign, dtype)
F32, BF16 = torch.float32, torch.bfloat16
AFTERSTATE_WIDTH_CASES = [
    (37, 29, 1, "logits", False, 1.0, F32),
    (301, 255, 32, "masked", True, -1.0, F32),
    (64, 8, 64, "min", False, 1.0, F32),
    (257, 256, 100, "min", True, 1.0, F32),
    (300, 256, 200, "logits", False, 1.0, F32),
    (37, 29, 384, "masked", True, -1.0, F32),
    (513, 511, 512, "min", True, 1.0, F32),
    (301, 255, 512, "logits", False, 1.0, F32),
    (1, 1, 512, "min", True, 1.0, F32),
    (0, 5, 512, "logits", False, 1.0, F32),
    (5, 0, 1024, "min", True, 1.0, F32),
    (130, 77, 1024, "masked", False, 1.0, F32),
    (513, 255, 1024, "min", True, 1.0, F32),
    (37, 29, 1024, "logits", False, 1.0, F32),
    (256, 8, 64, "masked", False, 1.0, F32),
    (2048, 128, 100, "min", True, 1.0, F32),
    (513, 511, 200, "min", False, 1.0, F32),
    (4096, 256, 512, "logits", False, 1.0, F32),
    (8192, 256, 512, "logits", False, 1.0, F32),
    (256, 256, 512, "masked", True, -1.0, F32),
    (2048, 512, 512, "min", True, 1.0, F32),
    (37, 29, 32, "logits", False, 1.0, BF16),
    (300, 256, 128, "logits", False, 1.0, BF16),
    (257, 256, 128, "min", True, 1.0, BF16),
    (301, 255, 256, "masked", True, -1.0, BF16),
    (513, 511, 512, "min", False, 1.0, BF16),
    (130, 77, 512, "logits", False, 1.0, BF16),
    (4096, 256, 128, "logits", False, 1.0, BF16),
    (8192, 256, 128, "logits", False, 1.0, BF16),
    (2048, 512, 128, "min", True, 1.0, BF16),
    (4096, 256, 512, "logits", False, 1.0, BF16),
]
AFTERSTATE_ALL = [(*c, F32) for c in AFTERSTATE_CASES] + \
    AFTERSTATE_WIDTH_CASES


def afterstate_id(case):
    """The case's values joined, float32's without its dtype."""
    return "-".join(str(x) for x in case[:6]) + (
        "" if case[6] == F32 else "-bf16")


@pytest.mark.parametrize("r,m,hidden,epilogue,opponent,sign,dtype",
                         AFTERSTATE_ALL, ids=map(afterstate_id,
                                                 AFTERSTATE_ALL))
def test_afterstate_eval_matches_plain(card, r, m, hidden, epilogue,
                                       opponent, sign, dtype):
    """Within ``forward_tol`` of the plain version (float32 up to 256
    units: 1e-5, the features exact, the sums of fc1 and the head in
    another order), the floor and the +1e9 of an empty min exact; the same
    bits on a second launch; one launch counted."""
    args = (*afterstate_inputs(card, r * 31 + m, r, m, hidden, dtype),
            opponent, epilogue, sign)
    before = TAS.afterstate_eval.launches
    got = TAS.afterstate_eval(*args)
    again = TAS.afterstate_eval(*args)
    want = TAS.afterstate_eval_plain(*args)
    torch.cuda.synchronize()
    assert TAS.afterstate_eval.launches == before + 2
    assert got.shape == want.shape and torch.equal(got, again)
    tol = forward_tol(args, want)
    assert torch.allclose(got, want, rtol=0, atol=tol), (float(
        (got - want).abs().max()), tol)
    special = (want == TAS.FLOOR) | (want == TAS.POS_INF)
    assert torch.equal(got[special], want[special])


# the backward at odd shapes, every width and bf16, and a minibatch's
# (8192, 256) at hidden 512 and in bf16 (in float32 up to 256 units:
# test_afterstate_backward_at_a_minibatch)
AFTERSTATE_BACKWARD_ALL = [
    (37, 29, 128, "logits", False, 1.0, F32),
    (8192, 256, 512, "logits", False, 1.0, F32),
    (8192, 256, 128, "logits", False, 1.0, BF16),
    (300, 256, 256, "masked", True, -1.0, F32),
    (2049, 256, 128, "logits", False, 1.0, F32),
    (0, 7, 128, "logits", False, 1.0, F32),
    (37, 29, 1, "logits", False, 1.0, F32),
    (301, 255, 100, "masked", True, -1.0, F32),
    (300, 256, 200, "logits", False, 1.0, F32),
    (300, 256, 384, "masked", False, 1.0, F32),
    (2049, 256, 512, "logits", False, 1.0, F32),
    (130, 77, 1024, "logits", False, 1.0, F32),
    (0, 7, 512, "logits", False, 1.0, F32),
    (37, 29, 32, "logits", False, 1.0, BF16),
    (2049, 256, 128, "logits", False, 1.0, BF16),
    (300, 256, 256, "masked", True, -1.0, BF16),
    (301, 255, 512, "logits", False, 1.0, BF16),
]


@pytest.mark.parametrize("r,m,hidden,epilogue,opponent,sign,dtype",
                         AFTERSTATE_BACKWARD_ALL,
                         ids=map(afterstate_id, AFTERSTATE_BACKWARD_ALL))
def test_afterstate_backward_matches_plain(card, r, m, hidden, epilogue,
                                           opponent, sign, dtype):
    """The four weights' gradients within ``backward_within`` of the
    plain ones (float32 up to 256 units: 1e-5 of each one's norm; block
    partials summed in block order, against torch's autograd), float32
    tensors (of bf16 numbers for bf16 weights); the same bits on a second
    launch."""
    args = (*afterstate_inputs(card, r + m, r, m, hidden, dtype), opponent,
            epilogue, sign)
    grad = torch.randn((r, m), device=card,
                       generator=torch.Generator(device=card).manual_seed(r))
    before = TAS.afterstate_eval_backward.launches
    got = TAS.afterstate_eval_backward(*args, grad)
    again = TAS.afterstate_eval_backward(*args, grad)
    want = TAS.afterstate_eval_backward_plain(*args, grad)
    torch.cuda.synchronize()
    assert TAS.afterstate_eval_backward.launches == before + 2
    for g, a, w in zip(got, again, want):
        assert g.shape == w.shape and torch.equal(g, a)
        assert g.dtype == torch.float32
        assert torch.equal(g, g.to(dtype).float())
    assert backward_within(args, grad, got, want)


@pytest.mark.parametrize("r,hidden", [(8192, 128), (8192, 256), (1024, 128)])
def test_afterstate_backward_at_a_minibatch(card, r, hidden):
    """The backward at a minibatch's shape, (8192, 256), and at
    distillation's, (1024, 256), against the plain version: over many
    boards a float32 sum flips the ReLU's kink of some boards whose
    pre-activation is near 0 (the plain version in float32 and this
    kernel alike, against the plain one in float64), so the four gradients
    are held as past 256 units, their distance from the plain ones at most
    4 times the distance that a one-ulp nudge of the parameters moves the
    plain ones; the same bits on a second launch, one launch counted
    each."""
    args = (*afterstate_inputs(card, r + hidden, r, 256, hidden),
            False, "logits", 1.0)
    grad = torch.randn((r, 256), device=card,
                       generator=torch.Generator(device=card).manual_seed(8))
    before = TAS.afterstate_eval_backward.launches
    got = TAS.afterstate_eval_backward(*args, grad)
    again = TAS.afterstate_eval_backward(*args, grad)
    torch.cuda.synchronize()
    assert TAS.afterstate_eval_backward.launches == before + 2
    want = TAS.afterstate_eval_backward_plain(*args, grad)
    nudged = TAS.afterstate_eval_backward_plain(
        *args[:3], *(torch.nextafter(p, torch.full_like(p, np.inf))
                     for p in args[3:7]), *args[7:], grad)

    def dist(xs, ys):
        return sum(float(((x - y).double() ** 2).sum())
                   for x, y in zip(xs, ys)) ** 0.5

    for g, a, w in zip(got, again, want):
        assert g.shape == w.shape and torch.equal(g, a)
    assert dist(got, want) <= 4 * dist(nudged, want)


def _tile_edge_inputs(card, seed, r, m, hidden, dtype=torch.float32):
    """``afterstate_inputs`` with the kernels' tile edges in them: the rows'
    n cycle through 63, 64, 65 (around a 64-board tile), m, 0 (every slot
    of a ``logits`` row kept, none of a ``min`` row), 1 and 129, so that
    tiles and blocks start and end inside rows and a row of m kept boards
    spans several tiles; one byte in fifty anywhere in [-128, 127]."""
    boards, mover, n, *w = afterstate_inputs(card, seed, r, m, hidden, dtype)
    rng = np.random.default_rng(seed + 1)
    b = boards.cpu().numpy()
    pick = rng.random(b.shape) < 0.02
    b[pick] = rng.integers(-128, 128, int(pick.sum()))
    b[::3, :, 5] = 127
    b[1::3, :, 50] = -128
    cycle = np.array([63, 64, 65, m, 0, 1, 129], dtype=np.int32)
    n = np.resize(cycle, r)
    return [torch.from_numpy(b).to(card), mover,
            torch.from_numpy(n).to(card), *w]


TILE_EDGE_WIDTHS = [(128, F32), (256, F32), (1, F32), (200, F32),
                    (512, F32), (128, BF16), (512, BF16)]


@pytest.mark.parametrize("hidden,dtype", TILE_EDGE_WIDTHS, ids=[
    f"{h}" if d == F32 else f"{h}-bf16" for h, d in TILE_EDGE_WIDTHS])
@pytest.mark.parametrize("epilogue,opponent,sign", [
    ("logits", False, 1.0), ("masked", True, -1.0), ("min", True, 1.0)])
def test_afterstate_tile_edges(card, hidden, dtype, epilogue, opponent,
                               sign):
    """Kept boards straddling the 64-board tiles and the blocks (rows of
    n = 63, 64, 65 and M; ``logits`` rows with n = 0; ``min`` rows split
    across tiles), extreme and negative bytes: the forward against the
    plain version and, but for the min, the backward; two launches give
    the same bits.  Bytes of 127 make values in the tens, whose float32
    sums differ in more than 1e-5: the float32 forward up to 256 units is
    held to 1e-5 of the largest kept value (at least 1e-5), past 256 to 4
    one-ulp nudges' drift scaled the same way, bf16 to ``forward_tol``;
    the floor and +1e9 exactly."""
    r, m = 173, 200
    args = (*_tile_edge_inputs(card, 7 * hidden + len(epilogue), r, m,
                               hidden, dtype), opponent, epilogue, sign)
    got = TAS.afterstate_eval(*args)
    again = TAS.afterstate_eval(*args)
    want = TAS.afterstate_eval_plain(*args)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.equal(got, again)
    special = (want == TAS.FLOOR) | (want == TAS.POS_INF)
    assert torch.equal(got[special], want[special])
    scale = max(1.0, float(want[~special].abs().max()))
    if dtype == F32 and hidden <= 256:
        assert float((got - want).abs().max()) <= 1e-5 * scale
    else:
        assert float((got - want).abs().max()) <= forward_tol(args, want)
    if epilogue == "min":
        return
    grad = torch.randn((r, m), device=card,
                       generator=torch.Generator(device=card).manual_seed(9))
    got = TAS.afterstate_eval_backward(*args, grad)
    again = TAS.afterstate_eval_backward(*args, grad)
    want = TAS.afterstate_eval_backward_plain(*args, grad)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert g.shape == w.shape and torch.equal(g, a)
    assert backward_within(args, grad, got, want)


def test_afterstate_boards_at_an_odd_address(card):
    """Contiguous boards that start at an odd byte (a view one byte into a
    buffer), which the kernels copy byte by byte instead of by 4-byte
    ``cp.async``: the forward and the backward equal their results on the
    same boards at an aligned address, bit for bit."""
    args = afterstate_inputs(card, 11, 77, 40, 128)
    boards = args[0]
    shifted = torch.empty(boards.numel() + 1, dtype=torch.int8,
                          device=card)[1:].view(boards.shape)
    shifted.copy_(boards)
    assert shifted.data_ptr() % 4 and shifted.is_contiguous()
    grad = torch.randn((77, 40), device=card,
                       generator=torch.Generator(device=card).manual_seed(4))
    for b in (boards, shifted):
        b_args = (b, *args[1:], False, "logits", 1.0)
        out = TAS.afterstate_eval(*b_args)
        back = TAS.afterstate_eval_backward(*b_args, grad)
        if b is boards:
            want, want_back = out, back
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert all(torch.equal(g, w) for g, w in zip(back, want_back))


def test_afterstate_autograd_on_card(card):
    """A loss through ``evaluate`` on the card backpropagates through the
    backward kernel: the model's gradients equal the CPU's (the plain
    path) within 1e-5 of their norm, one launch each way."""
    from mlp_ppo_2ply_p3_tpu_torch.models import mlp as TMLP

    boards, mover, n, *_ = afterstate_inputs(card, 5, 96, 64, 128)
    coef = torch.randn((96, 64), generator=torch.Generator().manual_seed(0))
    grads = []
    start = TMLP.MLP(TMLP.ModelConfig(), device="cpu",
                     generator=torch.Generator().manual_seed(1))
    for dev in (card, torch.device("cpu")):
        model = copy.deepcopy(start).to(dev)
        before = _launches(AFTERSTATE)
        out = TAS.evaluate(model, boards.to(dev), mover.to(dev), n.to(dev),
                           "score")
        torch.sum(coef.to(dev) * torch.log_softmax(out, -1)).backward()
        counted = {k: v - before[k] for k, v in _launches(AFTERSTATE).items()}
        assert counted == ({"afterstate_eval": 1,
                            "afterstate_eval_backward": 1} if dev == card
                           else {"afterstate_eval": 0,
                                 "afterstate_eval_backward": 0})
        grads.append([p.grad.cpu() for p in (
            model.layers["fc1"].weight, model.layers["fc1"].bias,
            model.layers["score"].weight, model.layers["score"].bias)])
    for g, w in zip(*grads):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.norm())


def test_afterstate_rejects_what_the_kernels_do_not_take(card):
    """On the card float16, float64 and mixed weights raise (naming the
    ROADMAP item that lists them), and so do non-contiguous inputs; no
    fallback."""
    boards, mover, n, *w = afterstate_inputs(card, 3, 4, 6, 64)
    for weights in ([x.half() for x in w], [x.double() for x in w],
                    [w[0].bfloat16(), *w[1:]]):
        with pytest.raises(ValueError, match="item 20"):
            TAS.afterstate_eval(boards, mover, n, *weights, False, "logits",
                                1.0)
    with pytest.raises(ValueError):
        TAS.afterstate_eval(boards[:, ::2], mover[:], n, *w, False,
                            "logits", 1.0)


def test_exact_order_movegen_card_equals_cpu(card):
    """``legal_afterstates_batch`` at ``MovegenConfig.parity()`` (the
    reference-order doubles path, whose list goes into the output with one
    ``index_copy_``: every empty doubles slot onto one spare row): the card
    equals the CPU bit for bit on played boards with empty doubles slots
    and a tenth of the games over, and on doubles only, where the doubles
    capacity binds."""
    mg = TM.MovegenConfig.parity()
    vecs, dice, mirror = _played(card, 600, 10, 31,
                                 TE.EnvConfig(movegen=mg))
    over = torch.arange(600, device=card) % 10 == 3
    vecs[over, :24] = 0
    vecs[over, 48] = 0
    vecs[over, 50] = 15
    doubles = torch.stack([dice[:, 0], dice[:, 0]], 1).contiguous()
    for d in (dice, doubles):
        got = TM.legal_afterstates_batch(vecs, d, mg, mirror)
        cpu = TM.legal_afterstates_batch(vecs.cpu(), d.cpu(), mg,
                                         mirror.cpu())
        torch.cuda.synchronize()
        for g, c in zip(got, cpu):
            assert torch.equal(g.cpu(), c)
    n_dbl = int((dice[:, 0] == dice[:, 1]).sum())
    assert 0 < n_dbl < TM.doubles_capacity(600, mg) < 600


def test_device_busy_against_graph_replay(card):
    """``device_busy`` of one captured movegen call (B=4096, ``fast``)
    replayed from a CUDA graph lies between half and 1.1 times the call's
    ``timed_scan`` time (the graph's replay time a call: the union of its
    kernels cannot be longer, and they fill most of it), and its traces
    agree."""
    from mlp_ppo_2ply_p3_tpu_torch.utils import profiling

    vecs, dice, mg = _movegen_args(card, 4096)
    scan_s = profiling.timed_scan(
        lambda v, d: TM.legal_afterstates_batch(v, d, mg), vecs, dice)
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        TM.legal_afterstates_batch(vecs, dice, mg)
    torch.cuda.current_stream(card).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        TM.legal_afterstates_batch(vecs, dice, mg)
    graph.replay()
    busy_s = profiling.device_busy(graph.replay, card)
    traces = profiling.device_busy.traces
    assert 0.5 * scan_s <= busy_s <= 1.1 * scan_s, (busy_s, scan_s, traces)
    a, b = traces[-2][0], traces[-1][0]
    assert abs(a - b) <= profiling.AGREE * max(a, b), traces


# --- the optimizer step (ops/adam.py, csrc/adam.cu) --------------------------

# (case, max_grad_norm, the gradients' global norm): the clip not engaged,
# engaged, and off (distillation's max_grad_norm = 0)
ADAM_CASES = [("unclipped", 0.5, 0.2), ("clipped", 0.5, 3.0),
              ("off", 0.0, 3.0)]
ADAM_NORM_ULPS = 8


def adam_inputs(card, hidden, norm, count, seed=0):
    """An MLP's leaves on the card: its parameters, gradients of global norm
    ``norm`` with the score head's zero (the unused head's), moments and a
    step count."""
    from mlp_ppo_2ply_p3_tpu_torch.models.mlp import MLP, ModelConfig

    gen = torch.Generator(device=card).manual_seed(seed)
    params = list(MLP(ModelConfig(hidden_size=hidden), device=card,
                      generator=gen).parameters())
    grads = [torch.randn(p.shape, generator=gen, device=card)
             for p in params]
    grads[-2:] = [torch.zeros_like(g) for g in grads[-2:]]
    total = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    grads = [g * (norm / total) for g in grads]
    mu = [0.01 * torch.randn(p.shape, generator=gen, device=card)
          for p in params]
    nu = [1e-4 * torch.rand(p.shape, generator=gen, device=card)
          for p in params]
    return (params, grads, torch.tensor(count, dtype=torch.int32,
                                        device=card), mu, nu)


def adam_at_norm(params, grads, count, mu, nu, max_grad_norm, norm):
    """The plain version with the global norm given: the clip written as
    the plain version writes it, then its step with clipping off."""
    from mlp_ppo_2ply_p3_tpu_torch.ops import adam as TA

    keep = norm < max_grad_norm
    grads = [torch.where(keep, g, (g / norm) * max_grad_norm) for g in grads]
    params = [p.clone() for p in params]
    out = TA.adam_update_plain(params, grads, count, mu, nu, 1e-3, 0.0)
    return params, out


def same_step(a, b):
    (pa, (ca, ma, va)), (pb, (cb, mb, vb)) = a, b
    return torch.equal(ca, cb) and all(
        torch.equal(x, y) for x, y in zip([*pa, *ma, *va], [*pb, *mb, *vb]))


@pytest.mark.parametrize("count", [0, 999])
@pytest.mark.parametrize("case,max_grad_norm,norm", ADAM_CASES,
                         ids=[c[0] for c in ADAM_CASES])
@pytest.mark.parametrize("hidden", [128, 512])
def test_adam_matches_plain(card, hidden, case, max_grad_norm, norm, count):
    """The kernel pair against the plain version at the MLP's leaves, the
    unused head's gradient zero.  Where the clip does not engage (or is
    off) the parameters, moments and count are the same bits.  Where it
    engages, the kernels' outputs are the plain version's at a global norm
    within ``ADAM_NORM_ULPS`` ulps of its own (the norm summed in another
    order), the same bits on a second launch.  The old state and the
    gradients are left as they were; one launch is counted a call."""
    from mlp_ppo_2ply_p3_tpu_torch.ops import adam as TA

    params, grads, cnt, mu, nu = adam_inputs(card, hidden, norm, count)
    kept = [t.clone() for t in (cnt, *grads, *mu, *nu)]
    want_p = [p.clone() for p in params]
    want = TA.adam_update_plain(want_p, grads, cnt, mu, nu, 1e-3,
                                max_grad_norm)
    start = [p.clone() for p in params]
    before = TA.adam_update.launches
    got = TA.adam_update(params, grads, cnt, mu, nu, 1e-3, max_grad_norm)
    again = [p.clone() for p in start]
    got2 = TA.adam_update(again, grads, cnt, mu, nu, 1e-3, max_grad_norm)
    torch.cuda.synchronize()
    assert TA.adam_update.launches == before + 2
    for a, b in zip((cnt, *grads, *mu, *nu), kept):
        assert torch.equal(a, b)
    assert int(got[0]) == count + 1
    assert same_step((params, got), (again, got2))
    if case != "clipped":
        assert same_step((params, got), (want_p, want))
        return
    plain_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    assert bool(plain_norm >= max_grad_norm)
    up, down = plain_norm.clone(), plain_norm.clone()
    inf = torch.tensor(float("inf"), device=card)
    for ulps in range(ADAM_NORM_ULPS + 1):
        if any(same_step((params, got), adam_at_norm(
                start, grads, cnt, mu, nu, max_grad_norm, n))
               for n in (up, down)):
            print(f"adam clipped at hidden {hidden}, count {count}: the "
                  f"kernels' norm {ulps} ulps from the plain version's")
            return
        up, down = torch.nextafter(up, inf), torch.nextafter(down, -inf)
    raise AssertionError(f"no norm within {ADAM_NORM_ULPS} ulps of the "
                         f"plain version's gives the kernels' step")


def test_adam_bias_corrections_match_torch_pow(card):
    """At every count the kernels' powf bias corrections are torch.pow's:
    clipping off, the step is the plain version's bits at counts 0-511 and
    at large ones up to float32's last exact integer."""
    from mlp_ppo_2ply_p3_tpu_torch.ops import adam as TA

    params, grads, _, mu, nu = adam_inputs(card, 4, 1.0, 0, seed=3)
    counts = list(range(512)) + [999, 4095, 12_799, 10**5, 10**6, 2**24 - 2]
    for count in counts:
        cnt = torch.tensor(count, dtype=torch.int32, device=card)
        got_p, want_p = ([p.clone() for p in params] for _ in range(2))
        got = TA.adam_update(got_p, grads, cnt, mu, nu, 1e-3, 0.0)
        want = TA.adam_update_plain(want_p, grads, cnt, mu, nu, 1e-3, 0.0)
        assert same_step((got_p, got), (want_p, want)), count


def test_adam_rejects_what_the_kernels_do_not_take(card):
    """float64, non-contiguous, CPU and mixed-device inputs raise before any
    launch."""
    from mlp_ppo_2ply_p3_tpu_torch.ops import adam as TA

    def inputs():
        return adam_inputs(card, 16, 0.2, 0)

    bad = []
    p, g, c, m, v = inputs()
    bad.append((p, [g[0].double(), *g[1:]], c, m, v))
    p, g, c, m, v = inputs()
    bad.append((p, g, c, [m[0].t().contiguous().t(), *m[1:]], v))
    p, g, c, m, v = inputs()
    bad.append((p, g, c.cpu(), m, v))
    p, g, c, m, v = inputs()
    bad.append((p, [g[0].cpu(), *g[1:]], c, m, v))
    p, g, c, m, v = inputs()
    bad.append(([t.cpu() for t in p], g, c, m, v))
    before = TA.adam_update.launches
    for args in bad:
        with pytest.raises((TypeError, ValueError)):
            TA.adam_update(*args, 1e-3, 0.5)
    assert TA.adam_update.launches == before


def _train_state_tensors(ts, env, gen=True):
    """Every tensor of a train state and env state, and the generator's
    state, in a fixed order."""
    return ([*ts.model.parameters(), *ts.opt_state.mu, *ts.opt_state.nu,
             ts.opt_state.count, ts.update_idx, ts.episodes] + list(env)
            + ([ts.gen.get_state()] if gen else []))


def test_checkpoint_roundtrip_and_resumed_train_step(card, tmp_path,
                                                     capsys):
    """At train4096's widths and B=64, T=8 on the card: a checkpoint
    restores every tensor and the 16-byte generator state (seed and
    Philox offset) exactly, and the next ``train_step`` from the restored
    state equals the one from the saved state bit for bit.  Restored on
    the CPU, every tensor is still exact and the generator is reseeded."""
    from mlp_ppo_2ply_p3_tpu_torch.ppo import learner as TL
    from mlp_ppo_2ply_p3_tpu_torch.utils import checkpoint as ckpt
    from mlp_ppo_2ply_p3_tpu_torch.utils.config import get_preset

    cfg = get_preset("train4096")
    ppo = dataclasses.replace(cfg.ppo, num_envs=64, t_horizon=8,
                              num_minibatches=4)

    def fresh(seed, dev):
        ts = TL.init_train_state(seed, cfg.model, ppo, device=dev)
        return ts, TE.reset(ts.gen, cfg.env, 64, device=dev)

    ts, env = fresh(0, card)
    ts, env, _ = TL.train_step(ts, env, cfg.env, cfg.model, ppo)
    assert ts.gen.get_state().numel() == 16
    path = ckpt.save(str(tmp_path / "ckpt_1"), (ts, env))
    ts2, env2 = ckpt.restore(path, fresh(1, card))
    for a, b in zip(_train_state_tensors(ts, env),
                    _train_state_tensors(ts2, env2)):
        assert a.device == b.device and torch.equal(a, b)
    # the model is stepped in place below: hold the CPU restore first
    ts_cpu, env_cpu = ckpt.restore(path, fresh(1, "cpu"))
    assert "reseeded" in capsys.readouterr().out
    for a, b in zip(_train_state_tensors(ts_cpu, env_cpu, gen=False),
                    _train_state_tensors(ts2, env2, gen=False)):
        assert a.device.type == "cpu" and torch.equal(a, b.cpu())

    out_a = TL.train_step(ts, env, cfg.env, cfg.model, ppo)
    out_b = TL.train_step(ts2, env2, cfg.env, cfg.model, ppo)
    for a, b in zip(_train_state_tensors(*out_a[:2]),
                    _train_state_tensors(*out_b[:2])):
        assert torch.equal(a, b)
    for k, v in out_a[2].items():
        assert torch.equal(v, out_b[2][k]), k


def test_profiling_timeit_on_card(card):
    """``utils.profiling.timeit``: CUDA events around back-to-back calls;
    a ~1 ms device sleep reads about 1 ms."""
    from mlp_ppo_2ply_p3_tpu_torch.utils import profiling

    seconds = profiling.timeit(lambda: torch.cuda._sleep(2_000_000), n=5,
                               device=card)
    assert 2e-4 < seconds < 2e-2


def _movegen_args(card, batch):
    """train4096's movegen on the boards of a fresh reset of ``batch``
    games."""
    from mlp_ppo_2ply_p3_tpu_torch.core import board

    cfg = TE.EnvConfig(movegen=TM.MovegenConfig.fast(256))
    gen = torch.Generator(device=card).manual_seed(3)
    es = TE.reset(gen, cfg, batch, device=card)
    vecs = board.to_canonical(es.points, es.bar, es.off, es.turn)
    return vecs, es.dice, cfg.movegen


def test_timed_scan_is_graph_time(card):
    """``utils.profiling.timed_scan`` replays a CUDA graph of the calls:
    at most 1.05 times the eager calls' time (which adds the host's
    launches), and every captured call's output equals the eager call's
    after the replays."""
    from mlp_ppo_2ply_p3_tpu_torch.utils import profiling

    vecs, dice, mg = _movegen_args(card, 4096)
    outs = []

    def call(v, d):
        outs.append(TM.legal_afterstates_batch(v, d, mg))

    graph_s = profiling.timed_scan(call, vecs, dice, iters=5)
    captured = outs[1:]
    eager_s = profiling.timed_eager(call, vecs, dice, iters=5)
    assert len(captured) == 5 and 0 < graph_s <= 1.05 * eager_s
    want = TM.legal_afterstates_batch(vecs, dice, mg)
    torch.cuda.synchronize()
    for got in captured:
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_timed_scan_counts_launches_at_capture(card):
    """The wrappers count when Python calls them: the warm-up and the
    capture count, the graph's replays do not."""
    from mlp_ppo_2ply_p3_tpu_torch.utils import profiling

    gen = torch.Generator(device=card).manual_seed(4)
    payload = torch.randint(-128, 128, (300, 896, 52), generator=gen,
                            device=card, dtype=torch.int8)
    valid = torch.rand((300, 896), generator=gen, device=card) < 0.2
    before = TC.compact_rows.launches
    profiling.timed_scan(TC.compact_rows, payload, valid, 288, iters=7)
    assert TC.compact_rows.launches - before == 1 + 7
    profiling.timed_scan(TC.compact_rows, payload, valid, 256, iters=3)
    assert TC.compact_rows.launches - before == 1 + 7 + 1 + 3


def test_device_busy_reads_the_kernels(card):
    """``device_busy`` of a ~10 ms device sleep reads about 10 ms, and of
    two sleeps about twice that."""
    from mlp_ppo_2ply_p3_tpu_torch.utils import profiling

    one = profiling.device_busy(lambda: torch.cuda._sleep(20_000_000), card)
    one_traces = profiling.device_busy.traces
    two = profiling.device_busy(lambda: [torch.cuda._sleep(20_000_000)
                                         for _ in range(2)], card)
    readings = (one_traces, profiling.device_busy.traces)
    assert 2e-3 < one < 5e-2, readings
    assert 1.6 * one < two < 2.4 * one, readings


def test_breakdown_device_keys_on_card(card, capsys):
    """``scripts/perf_breakdown.py`` at B=512, T=4 on the card: every
    device key is a number, idle shares lie in [0, 1], each movegen
    piece's graph time is at most 1.05 times its eager time."""
    from mlp_ppo_2ply_p3_tpu_torch.scripts import perf_breakdown

    (row,) = perf_breakdown.main(["512", "--t", "4"])
    assert row["device"] != "cpu"
    for width in ("default", "fast"):
        cell = row[width]
        for k, v in cell.items():
            assert v is not None and v > 0 or k.endswith("idle_share"), k
        for k in ("rollout_idle_share", "train_step_idle_share"):
            assert 0 <= cell[k] <= 1, k
        for k in ("movegen", "movegen_nondoubles",
                  "movegen_doubles_subbatch", "movegen_dedup"):
            assert cell[f"{k}_ms"] <= 1.05 * cell[f"{k}_eager_ms"], k


# --- the deep pass (csrc/afterstate.cu's deep forms, csrc/dense.cu) ----------


def deep_weights(card, seed, widths, heads):
    """float32 weights of fc1, the dense layers and a head of ``heads``
    outputs, drawn as ``nn.Linear`` draws them (U(-1/sqrt(fan in), ...))."""
    rng = np.random.default_rng(seed)
    dims = [198, *widths, heads]
    out = []
    for k, n in zip(dims[:-1], dims[1:]):
        bound = 1 / np.sqrt(k)
        out += [rng.uniform(-bound, bound, (n, k)),
                rng.uniform(-bound, bound, (n,))]
    return [torch.tensor(w, dtype=torch.float32, device=card) for w in out]


# the deep pass's gradients against the plain version's: 8 times the
# distance a one-ulp nudge of the weights moves them.  Three ReLU layers'
# masks flip where a pre-activation is within rounding of 0, in the kernels
# (their sums run in another order) as under the nudge, each flip a whole
# term of a gradient; one case read 4.2 nudges (301 x 255 boards, random
# cotangents).  The plain version with TF32 products reads past the gate
# (``deep_within`` measures it beside every case).
DEEP_GRAD_FACTOR = 8.0


def _plain_tf32(fn):
    """``fn()`` with TF32 products allowed (the nearest precision below
    float32), then restored."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def deep_within(args, got, want, grads=None,
                plain=TAS.afterstate_deep_plain):
    """The deep pass's gate against the plain version, as (within, what
    was read): the forward within 4 times the largest drift that a one-ulp
    nudge of every weight makes of the plain version's kept values (at
    least 1e-6); the gradients' distance from the plain ones within
    DEEP_GRAD_FACTOR times the distance that the nudge moves them.  Beside
    each, what the plain version with TF32 products reads: past the gate,
    or the gate would not tell TF32 from float32 (``tf32_outside``)."""
    boards, mover, n, weights, *rest = args
    kept = want != TAS.FLOOR
    floors = (got == TAS.FLOOR) != ~kept
    if floors.any():
        return False, {"floors_differ": int(floors.sum())}
    nudged = [nudged_up(w) for w in weights]
    drift = (plain(boards, mover, n, nudged, *rest) - want)[kept]
    tol = max(NUDGE_FACTOR * float(drift.abs().max()) if drift.numel()
              else 0.0, 1e-6)
    gap = float((got - want)[kept].abs().max()) if kept.any() else 0.0
    tf32 = _plain_tf32(lambda: plain(*args))
    read = {"value_gap": gap, "value_gate": tol, "kept": int(kept.sum()),
            "tf32_value_gap": float((tf32 - want)[kept].abs().max())
            if kept.any() else 0.0}
    read["tf32_outside"] = read["tf32_value_gap"] > tol
    if gap > tol:
        return False, read
    if grads is None:
        return True, read
    grad, got_g = grads
    want_g = _deep_grads(plain, args, weights, grad)
    nudge_g = _deep_grads(plain, args, nudged, grad)

    def dist(xs, ys):
        return sum(float(((x.double() - y.double()) ** 2).sum())
                   for x, y in zip(xs, ys)) ** 0.5

    tf32_g = _plain_tf32(lambda: _deep_grads(plain, args, weights, grad))
    read["grad_dist"] = dist(got_g, want_g)
    read["grad_gate"] = max(DEEP_GRAD_FACTOR * dist(nudge_g, want_g), 1e-9)
    read["tf32_grad_dist"] = dist(tf32_g, want_g)
    read["tf32_outside"] &= read["tf32_grad_dist"] > read["grad_gate"]
    return read["grad_dist"] <= read["grad_gate"], read


def _deep_grads(fn, args, weights, grad):
    boards, mover, n, _, *rest = args
    w = [x.detach().clone().requires_grad_() for x in weights]
    y = fn(boards, mover, n, w, *rest)
    got = torch.autograd.grad(y, w, grad, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for x, g in zip(w, got)]


# (R, M, trunk, heads, epilogue, opponent, sign, kept): wildbg's widths
# with the outcome head and a score head, every epilogue and view, a
# count of 0 and the capacity (every slot), odd shapes, the narrowest and
# widest layers and a deeper trunk; then the tensor-core tiles' edges:
# widths either side of 8 and 16 (wgmma's N and K steps), 136, 256 and 257
# (a warpgroup's chunks of 64 columns), 320, and kept counts either side of
# a 64-row tile (an int: the first rows keep every slot until that many);
# last the weight gradient's units: outputs 127, 128 and 129 (its tiles of
# up to 128), inputs with a bias column K + 1 of 63, 64, 65 and 127, 128,
# 129 (its 64-input units in pairs, an odd count's last alone or with two
# output tiles), and 5 kept rows over its 132 row slices
DEEP_CASES = [
    (37, 29, (300, 250, 200), 6, "logits", False, 1.0, "random"),
    (301, 255, (300, 250, 200), 1, "masked", True, -1.0, "random"),
    (300, 256, (300, 250, 200), 6, "masked", True, -1.0, "capacity"),
    (257, 256, (300, 250, 200), 1, "masked", False, 1.0, "none"),
    (5, 3, (40, 24, 10), 6, "logits", False, 1.0, "random"),
    (64, 8, (1, 1), 1, "masked", False, 1.0, "random"),
    (130, 77, (128, 320, 17, 64), 6, "logits", True, -1.0, "random"),
    (0, 5, (300, 250, 200), 6, "logits", False, 1.0, "random"),
    (40, 8, (136, 256, 257), 6, "masked", False, 1.0, 65),
    (16, 8, (257, 320, 8), 1, "masked", True, -1.0, 64),
    (16, 8, (9, 17, 16, 320), 6, "masked", False, 1.0, 63),
    (8, 4, (320, 9, 136), 1, "masked", False, 1.0, 1),
    (33, 16, (16, 8, 256, 17), 6, "masked", True, -1.0, "capacity"),
    (40, 8, (62, 127, 64, 129), 6, "masked", False, 1.0, "random"),
    (40, 8, (126, 128, 63, 8), 1, "masked", True, -1.0, 65),
    (16, 8, (300, 250, 200), 6, "masked", False, 1.0, 5),
]


def _deep_case(card, case, seed=0):
    from mlp_ppo_2ply_p3_tpu_torch.models.mlp import OUTCOME_REWARDS

    r, m, trunk, heads, epilogue, opponent, sign, kept = case
    boards, mover, n, *_ = afterstate_inputs(card, seed, r, m, 1)
    mover = mover.clamp(max=1)
    if kept == "capacity":
        n = torch.full_like(n, m)
    elif kept == "none":
        n = torch.zeros_like(n)
    elif isinstance(kept, int):
        n = torch.clamp(kept - m * torch.arange(r, device=card), 0, m).to(
            n.dtype)
    weights = deep_weights(card, seed + 1, trunk, heads)
    rewards = OUTCOME_REWARDS if heads == 6 else None
    return (boards, mover, n, weights, rewards, opponent, epilogue, sign)


@pytest.mark.parametrize("case", DEEP_CASES,
                         ids=lambda c: "-".join(map(str, c[:2])) + "-"
                         + "x".join(map(str, c[2])) + "-" + "-".join(
                             map(str, c[3:])))
def test_deep_pass_matches_plain(card, case):
    """``afterstate_deep`` on the card (``afterstate_hidden``, then
    ``dense_layers``) against its plain version, and its backward
    (``dense_layers_backward``, then ``afterstate_hidden_backward``)
    against the plain version's autograd, one launch of each wrapper."""
    args = _deep_case(card, case)
    boards, mover, n, weights, *rest = args
    want = TAS.afterstate_deep_plain(*args)
    before = _launches(DEEP)
    w = [x.clone().requires_grad_() for x in weights]
    got = TAS.afterstate_deep(boards, mover, n, w, *rest)
    grad = torch.randn(got.shape, generator=torch.Generator().manual_seed(
        3)).to(card)
    got_g = torch.autograd.grad(got, w, grad) if got.numel() else \
        [torch.zeros_like(x) for x in w]
    counted = {k: v - before[k] for k, v in _launches(DEEP).items()}
    back = int(got.numel() > 0)
    assert counted == {"afterstate_hidden": 1, "dense_layers": 1,
                       "afterstate_hidden_backward": back,
                       "dense_layers_backward": back}
    within, read = deep_within(args, got.detach(), want, (grad, got_g))
    assert within, read
    # where values are kept past the width-1 layers, TF32 fails the gate
    assert read["tf32_outside"] or read["kept"] == 0 or min(case[2]) < 8, \
        read


def test_deep_pass_at_wildbg4096_shapes(card):
    """The deep pass of ``wildbg4096``'s model at its first rollout step
    (4096 x 256 boards of a reset) and at a minibatch's 8192 x 256 with
    every slot kept where the games allow: kernel == plain within the
    gate, forward and gradients."""
    from mlp_ppo_2ply_p3_tpu_torch.ppo import learner
    from mlp_ppo_2ply_p3_tpu_torch.utils.config import get_preset

    cfg = get_preset("wildbg4096")
    ts = learner.init_train_state(4, cfg.model, cfg.ppo, device=card)
    es = TE.reset(ts.gen, cfg.env, 4096, device=card)
    weights, _ = ts.model.deep_weights("score")
    weights = [w.detach() for w in weights]
    turn, n = es.turn.to(torch.int32), es.n_moves.to(torch.int32)
    args = (es.after, turn, n, weights, None, False, "logits", 1.0)
    with torch.no_grad():
        got = TAS.afterstate_deep(*args[:4])
    within, read = deep_within(args, got, TAS.afterstate_deep_plain(*args))
    assert within and read["tf32_outside"], read
    after = torch.cat([es.after, es.after.flip(0)])
    args = (after, torch.cat([turn, 1 - turn]), torch.cat([n, n.flip(0)]),
            weights, None, False, "logits", 1.0)
    w = [x.clone().requires_grad_() for x in weights]
    got = TAS.afterstate_deep(*args[:3], w)
    grad = torch.randn(got.shape, generator=torch.Generator().manual_seed(
        5)).to(card) * (got > TAS.FLOOR)
    got_g = torch.autograd.grad(got, w, grad)
    within, read = deep_within(args, got.detach(),
                               TAS.afterstate_deep_plain(*args),
                               (grad, got_g))
    assert within and read["tf32_outside"], read


@pytest.mark.parametrize("trunk", [(300, 250, 200), (62, 127, 64, 129)])
def test_deep_backward_gives_the_same_bits_twice(card, trunk):
    """Two calls of ``dense_layers_backward`` on the same inputs give the
    same bits in fc1's dpre and in every gradient leaf: the weight
    gradient's row slices are summed in their order and no float sum uses
    an atomic, whichever block runs first."""
    args = _deep_case(card, (301, 255, trunk, 6, "masked", True, -1.0,
                             "random"), seed=11)
    boards, mover, n, weights, rewards, opponent, epilogue, sign = args
    (w1, b1), layers, head = TAS._split(weights)
    with torch.no_grad():
        out, h1, elem, count = TAS.afterstate_hidden(
            boards, mover, n, w1, b1, opponent, epilogue)
        acts = TDN.dense_layers(h1, elem, count, out, layers, head, rewards,
                                sign, save=True)
        grad = torch.randn(out.shape, generator=torch.Generator().manual_seed(
            13)).to(card)
        first = TDN.dense_layers_backward(h1, acts, elem, count, grad,
                                          layers, head, rewards, sign)
        second = TDN.dense_layers_backward(h1, acts, elem, count, grad,
                                           layers, head, rewards, sign)
    kept = int(count)
    assert kept > 0
    # fc1's dpre on the kept rows (its row stride's padding is unspecified)
    width = trunk[0]
    assert torch.equal(first[0][:kept, :width], second[0][:kept, :width])
    assert len(first[1]) == 2 * len(trunk)
    for a, b in zip(first[1], second[1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kept", ["random", "none", "capacity"])
def test_deep_pass_in_a_cuda_graph(card, kept):
    """The deep pass's forward is captured into a CUDA graph (the kept
    count stays on the card: no host sync, static shapes) and its replay
    gives the eager call's bits, at counts of 0 and at capacity too."""
    case = (257, 256, (300, 250, 200), 6, "masked", True, -1.0, kept)
    args = _deep_case(card, case, seed=7)
    with torch.no_grad():
        eager = TAS.afterstate_deep(*args)
        side = torch.cuda.Stream(card)
        side.wait_stream(torch.cuda.current_stream(card))
        with torch.cuda.stream(side):
            TAS.afterstate_deep(*args)
        torch.cuda.current_stream(card).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = TAS.afterstate_deep(*args)
        graph.replay()
        torch.cuda.synchronize(card)
    assert torch.equal(captured, eager)


def test_deep_pass_rejects_what_the_kernels_do_not_take(card):
    """On the card a layer wider than the kernels' 320 units raises, as do
    the min epilogue and bf16 weights (naming their ROADMAP items)."""
    args = _deep_case(card, (4, 6, (300, 321, 8), 1, "logits", False, 1.0,
                             "random"))
    with pytest.raises(ValueError, match="widths 1 to 320"):
        TAS.afterstate_deep(*args)
    args = _deep_case(card, DEEP_CASES[0])
    with pytest.raises(NotImplementedError, match="item C9"):
        TAS.afterstate_deep(*args[:6], "min", 1.0)
    with pytest.raises(NotImplementedError, match="item C10"):
        TAS.afterstate_deep(*args[:3], [w.bfloat16() for w in args[3]],
                            *args[4:])
    assert TDN.MAX_WIDTH == 320


# --- the routed pass (wildbg's contact and race networks) -------------------


def _routed_case(card, case, seed=0):
    """``_deep_case``'s inputs with two networks of the trunk (contact
    first) and a share ``race`` of the boards made races (each side's
    checkers on its own half: the mover's on points 12-23, the opponent's
    on 0-11, no bar); -1: every board a race, bars emptied on all."""
    *deep, race = case
    boards, mover, n, weights, *rest = _deep_case(card, tuple(deep), seed)
    second = deep_weights(card, seed + 2, deep[2], deep[3])
    g = torch.Generator(device=card)
    g.manual_seed(seed + 3)
    if boards.numel():
        pick = torch.rand(boards.shape[:2], generator=g, device=card) < (
            1.0 if race < 0 else race)
        raced = boards.clone()
        raced[..., 0:12] = 0
        raced[..., 36:48] = 0
        raced[..., 48:50] = 0
        boards = torch.where(pick[..., None], raced, boards).contiguous()
    return (boards, mover, n, weights + second, *rest)


def kept_counts(lim):
    """The kept boards of each entry of a route's ``lim`` (one for a whole
    row's ``WHOLE``)."""
    return torch.where(lim == TAS.WHOLE, 1, lim)


def _routed_on_card(boards, mover, n, weights, *rest):
    k = len(weights) // 2
    return TAS.afterstate_routed(boards, mover, n, weights[:k], weights[k:],
                                 *rest)


# (R, M, trunk, heads, epilogue, opponent, sign, kept, race share): odd
# counts in both groups, no race board, only race boards, every slot and
# none kept, no row, and kept counts either side of a 64-board tile
ROUTED_CASES = [
    (37, 29, (300, 250, 200), 6, "logits", False, 1.0, "random", 0.3),
    (301, 255, (300, 250, 200), 1, "masked", True, -1.0, "random", 0.1),
    (63, 17, (300, 250, 200), 6, "masked", False, 1.0, "random", 0.0),
    (65, 19, (300, 250, 200), 6, "logits", True, 1.0, "random", -1),
    (300, 256, (300, 250, 200), 6, "masked", True, -1.0, "capacity", 0.5),
    (257, 256, (300, 250, 200), 1, "masked", False, 1.0, "none", 0.5),
    (0, 5, (300, 250, 200), 6, "logits", False, 1.0, "random", 0.5),
    (40, 8, (136, 256, 257), 6, "masked", False, 1.0, 65, 0.5),
    (5, 3, (40, 24, 10), 6, "logits", False, 1.0, "random", 0.5),
]


def _routed_id(case):
    return "-".join(map(str, case[:2])) + "-" + "x".join(
        map(str, case[2])) + "-" + "-".join(map(str, case[3:]))


@pytest.mark.parametrize("case", ROUTED_CASES, ids=_routed_id)
def test_routed_route_matches_plain(card, case):
    """``afterstate_route`` (the class split) against its plain version:
    the floors, each row's count of each class and its slots of each class
    in order, exactly."""
    boards, _, n, _, _, _, epilogue, _ = _routed_case(card, case)
    out, lim, slots = TAS.afterstate_route(boards, n, epilogue)
    want_out, want_lim, want_slots = TAS.afterstate_route_plain(boards, n,
                                                                epilogue)
    kept = TAS._valid(n, boards.shape[1], epilogue)
    assert bool((out[~kept] == TAS.FLOOR).all())
    assert bool((want_out[~kept] == TAS.FLOOR).all())
    assert torch.equal(lim, want_lim)
    m = boards.shape[1]
    kept = kept_counts(want_lim)
    for c in range(2):
        for r in range(boards.shape[0]):
            k = int(kept[c, r])
            assert torch.equal(slots[c, r * m:r * m + k],
                               want_slots[c, r * m:r * m + k])


@pytest.mark.parametrize("case", ROUTED_CASES, ids=_routed_id)
def test_routed_pass_matches_plain(card, case):
    """``afterstate_routed`` on the card (the route, then each group's
    ``afterstate_hidden`` and ``dense_layers``) against its plain version
    (every slot through both networks, each slot's value from its class's),
    forward and gradients of both networks, with the launches of each
    wrapper counted and the tally of kept boards by group."""
    from mlp_ppo_2ply_p3_tpu_torch import ops

    args = _routed_case(card, case)
    boards, mover, n, weights, *rest = args
    want = TAS.afterstate_routed_plain(*args)
    ops.zero_launches()
    w = [x.clone().requires_grad_() for x in weights]
    got = _routed_on_card(boards, mover, n, w, *rest)
    grad = torch.randn(got.shape, generator=torch.Generator().manual_seed(
        3)).to(card)
    got_g = torch.autograd.grad(got, w, grad) if got.numel() else \
        [torch.zeros_like(x) for x in w]
    back = 2 * int(got.numel() > 0)
    assert _launches(ROUTED) == {"afterstate_route": 1,
                                 "afterstate_hidden": 2, "dense_layers": 2,
                                 "afterstate_hidden_backward": back,
                                 "dense_layers_backward": back}
    _, lim, _ = TAS.afterstate_route_plain(boards, n, rest[2])
    lim = kept_counts(lim)
    assert TAS.routed_rows() == {"contact": int(lim[0].sum()),
                                 "race": int(lim[1].sum())}
    within, read = deep_within(args, got.detach(), want, (grad, got_g),
                               plain=TAS.afterstate_routed_plain)
    assert within, read
    assert read["tf32_outside"] or read["kept"] == 0, read
    if int(lim[1].sum()) == 0 and got.numel():   # no race board: no gradient
        k = len(w) // 2
        assert all(not bool(g.any()) for g in got_g[k:])


def test_routed_pass_with_equal_networks_is_the_deep_pass(card):
    """With the race network's weights equal to the contact network's, the
    routed pass gives the deep pass's values within the deep gate."""
    args = _routed_case(card, ROUTED_CASES[1])
    boards, mover, n, weights, *rest = args
    k = len(weights) // 2
    same = weights[:k] + weights[:k]
    with torch.no_grad():
        got = _routed_on_card(boards, mover, n, same, *rest)
    deep = (boards, mover, n, weights[:k], *rest)
    within, read = deep_within(deep, got, TAS.afterstate_deep_plain(*deep))
    assert within, read


def test_routed_pass_in_a_cuda_graph(card):
    """The routed forward is captured into a CUDA graph (both groups'
    counts stay on the card: no host sync) and its replay gives the eager
    call's bits."""
    args = _routed_case(card, ROUTED_CASES[4], seed=7)
    with torch.no_grad():
        eager = _routed_on_card(*args)
        side = torch.cuda.Stream(card)
        side.wait_stream(torch.cuda.current_stream(card))
        with torch.cuda.stream(side):
            _routed_on_card(*args)
        torch.cuda.current_stream(card).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = _routed_on_card(*args)
        graph.replay()
        torch.cuda.synchronize(card)
    assert torch.equal(captured, eager)


def test_routed_pass_makes_no_host_sync(card):
    """The routed pass, forward and backward, under CUDA's sync debug mode
    set to raise: both groups' counts stay on the card, so nothing waits
    for it."""
    args = _routed_case(card, ROUTED_CASES[1], seed=9)
    boards, mover, n, weights, *rest = args
    w = [x.clone().requires_grad_() for x in weights]
    grad = torch.randn((boards.shape[0], boards.shape[1]),
                       generator=torch.Generator().manual_seed(4)).to(card)
    torch.cuda.synchronize(card)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = _routed_on_card(boards, mover, n, w, *rest)
        grads = torch.autograd.grad(got, w, grad)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(grads) == len(w)


def test_routed_train_step_on_card(card):
    """``wildbg2net4096``'s model through ``learner.train_step`` on the card
    at a small batch: both groups' kernels run, every leaf but the unused
    action heads' moves, and the optimizer takes the 24 leaves."""
    from mlp_ppo_2ply_p3_tpu_torch import ops
    from mlp_ppo_2ply_p3_tpu_torch.ppo import learner
    from mlp_ppo_2ply_p3_tpu_torch.utils.config import get_preset

    cfg = get_preset("wildbg2net4096")
    ppo = dataclasses.replace(cfg.ppo, num_envs=64, t_horizon=16,
                              num_minibatches=2, num_epochs=1)
    ts = learner.init_train_state(5, cfg.model, ppo, device=card)
    es = TE.reset(ts.gen, cfg.env, 64, device=card)
    # a quarter of the games raced from the start: each side's checkers on
    # its own half of the board
    pts = es.points.clone()
    pts[:16] = 0
    pts[:16, 0, 20:24] = torch.tensor([4, 4, 4, 3], dtype=pts.dtype,
                                      device=card)
    pts[:16, 1, 0:4] = torch.tensor([3, 4, 4, 4], dtype=pts.dtype,
                                    device=card)
    es = TE.make_state(pts, es.bar, es.off, es.turn, es.dice, cfg.env)
    before = [p.detach().clone() for p in ts.model.parameters()]
    ops.zero_launches()
    ts, es, metrics = learner.train_step(ts, es, cfg.env, cfg.model, ppo)
    assert all(bool(torch.isfinite(v).all()) for v in metrics.values())
    assert ops.launches()["adam_update"] == 2
    rows = TAS.routed_rows()
    assert rows["contact"] > 0 and rows["race"] > 0, rows
    moved = {n: not torch.equal(a, b) for a, (n, b) in
             zip(before, ts.model.named_parameters())}
    assert moved == {n: "action" not in n for n in moved}


# --- whole rows: a row with n <= 0 whose M boards are one board -------------


def whole_row_inputs(card, seed, r, m, hidden, dtype=torch.float32):
    """``afterstate_inputs`` with rows of five kinds in turn: n = 0 and M
    zero boards (a row with no legal move, as movegen leaves it), n = 0 and
    M copies of one non-zero board, n = 0 and boards that differ (slot 1
    from slot 0 in one byte at least), n = M with M copies, and the rows as
    drawn; and the (R,) bool of the rows that are whole (the first two
    kinds)."""
    boards, mover, n, *w = afterstate_inputs(card, seed, r, m, hidden, dtype)
    kind = torch.arange(r, device=card) % 5
    b = boards.clone()
    b[kind == 0] = 0
    one = b[:, :1].clone()
    one[..., 5] = 3
    copies = one.expand(-1, m, -1)
    b = torch.where(((kind == 1) | (kind == 3))[:, None, None], copies, b)
    b[kind == 2, 1, 7] = b[kind == 2, 0, 7] + 1
    n = torch.where(kind <= 2, 0, torch.where(kind == 3, m, n)).to(n.dtype)
    whole = kind <= 1
    assert torch.equal(TAS.collapsed_plain(b, n, "logits"), whole)
    return [b.contiguous(), mover, n, *w], whole


def alone(n, whole):
    """``n`` with each whole row's n = 1: its slot 0 evaluated alone."""
    return torch.where(whole, 1, n).to(n.dtype)


# (hidden, dtype, opponent view): one block, a cluster of two, unit groups
# with the finish kernel, bf16 in one block and in unit groups
WHOLE_SHALLOW = [(128, F32, False), (256, F32, True), (512, F32, False),
                 (128, BF16, True), (512, BF16, False)]


@pytest.mark.parametrize("hidden,dtype,opponent", WHOLE_SHALLOW,
                         ids=[f"{h}-{'bf16' if d == BF16 else 'f32'}-{o}"
                              for h, d, o in WHOLE_SHALLOW])
def test_whole_rows_in_the_shallow_pass(card, hidden, dtype, opponent):
    """The shallow kernels over whole rows: every slot of a whole row has
    the bits the same kernel gives its board in a row with n = 1; values
    and gradients against the plain version (every slot evaluated) under
    ``forward_tol`` and ``backward_within``, the floors exact; the same
    bits on a second launch; ``collapsed_rows`` counts the whole rows once
    a forward call (its backward takes the forward's entries)."""
    from mlp_ppo_2ply_p3_tpu_torch import ops

    r, m = 301, 200
    (boards, mover, n, *w), whole = whole_row_inputs(card, 17 + hidden, r,
                                                      m, hidden, dtype)
    args = (boards, mover, n, *w, opponent, "logits", 1.0)
    ops.zero_launches()
    got = TAS.afterstate_eval(*args)
    assert TAS.collapsed_rows() == int(whole.sum())
    again = TAS.afterstate_eval(*args)
    single = TAS.afterstate_eval(boards, mover, alone(n, whole), *w,
                                 opponent, "logits", 1.0)
    want = TAS.afterstate_eval_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got[whole], single[whole, :1].expand(-1, m))
    special = want == TAS.FLOOR
    assert torch.equal(got[special], want[special])
    assert float((got - want).abs().max()) <= forward_tol(args, want)
    grad = torch.randn((r, m), device=card,
                       generator=torch.Generator(device=card).manual_seed(6))
    grad = grad * (want > TAS.FLOOR)
    model_w = [x.clone().requires_grad_() for x in w]
    out = TAS.afterstate_eval(boards, mover, n, *model_w, opponent, "logits",
                              1.0)
    got_g = torch.autograd.grad(out, model_w, grad)
    again_g = TAS.afterstate_eval_backward(*args, grad)
    want_g = TAS.afterstate_eval_backward_plain(*args, grad)
    torch.cuda.synchronize()
    for g, a, x in zip(got_g, again_g, want_g):
        assert g.shape == x.shape and torch.equal(g, a)
    assert backward_within(args, grad, got_g, want_g)


def _whole_deep_case(card, seed, r, m, trunk, race=None):
    """``whole_row_inputs`` as a deep (or, with ``race`` weights drawn,
    routed) case: wildbg's outcome head, movers 0 and 1."""
    from mlp_ppo_2ply_p3_tpu_torch.models.mlp import OUTCOME_REWARDS

    (boards, mover, n, *_), whole = whole_row_inputs(card, seed, r, m, 1)
    weights = deep_weights(card, seed + 1, trunk, 6)
    if race:
        weights += deep_weights(card, seed + 2, trunk, 6)
    return (boards, mover.clamp(max=1), n, weights, OUTCOME_REWARDS, False,
            "logits", 1.0), whole


@pytest.mark.parametrize("form", ["deep", "routed"])
def test_whole_rows_in_the_deep_and_routed_passes(card, form):
    """The deep pass (the emit, the dense layers at wildbg's widths, their
    backwards) and the routed pass (the route, each group's) over whole
    rows: every slot of a whole row has the bits of its board in a row
    with n = 1; values and gradients against the plain version under
    ``deep_within``; the same bits on a second launch; the route's layout
    against its plain version exactly; ``collapsed_rows`` counts the whole
    rows once a forward call, and each group's tally counts its class's
    kept boards, a whole row's one."""
    from mlp_ppo_2ply_p3_tpu_torch import ops

    args, whole = _whole_deep_case(card, 23, 301, 200, (300, 250, 200),
                                   race=form == "routed")
    boards, mover, n, weights, *rest = args
    run = _routed_on_card if form == "routed" else TAS.afterstate_deep
    plain = (TAS.afterstate_routed_plain if form == "routed"
             else TAS.afterstate_deep_plain)
    if form == "routed":
        _, lim, slots = TAS.afterstate_route(boards, n, "logits")
        _, want_lim, want_slots = TAS.afterstate_route_plain(boards, n,
                                                             "logits")
        assert torch.equal(lim, want_lim)
        assert bool((lim == TAS.WHOLE).sum(0).bool().eq(whole).all())
        m = boards.shape[1]
        used = torch.arange(m, device=card) < kept_counts(lim)[..., None]
        assert torch.equal(slots.view(2, -1, m)[used],
                           want_slots.view(2, -1, m)[used])
    ops.zero_launches()
    w = [x.clone().requires_grad_() for x in weights]
    got = run(boards, mover, n, w, *rest)
    assert TAS.collapsed_rows() == int(whole.sum())
    if form == "routed":
        kept = kept_counts(TAS.afterstate_route_plain(boards, n,
                                                      "logits")[1])
        assert TAS.routed_rows() == {"contact": int(kept[0].sum()),
                                     "race": int(kept[1].sum())}
    grad = torch.randn(got.shape, generator=torch.Generator().manual_seed(
        7)).to(card)
    got_g = torch.autograd.grad(got, w, grad)
    with torch.no_grad():
        again = run(boards, mover, n, weights, *rest)
        single = run(boards, mover, alone(n, whole), weights, *rest)
    again_g = torch.autograd.grad(run(boards, mover, n, w, *rest), w, grad)
    torch.cuda.synchronize()
    assert torch.equal(got.detach(), again)
    assert all(torch.equal(a, b) for a, b in zip(got_g, again_g))
    m = boards.shape[1]
    assert torch.equal(got.detach()[whole], single[whole, :1].expand(-1, m))
    within, read = deep_within(args, got.detach(), plain(*args),
                               (grad, got_g), plain=plain)
    assert within and read["tf32_outside"], read


# last: a failed capture must leave the card usable, but if it did not,
# no other test would be hit
def test_timed_scan_refuses_what_cannot_be_captured(card):
    """A host synchronisation inside the timed function raises: there is
    no eager fallback under the device's name."""
    from mlp_ppo_2ply_p3_tpu_torch.utils import profiling

    x = torch.arange(1000, device=card)
    with pytest.raises(RuntimeError):
        profiling.timed_scan(lambda a: int(a.sum()), x, iters=2)
    torch.cuda.synchronize()
    assert int(x.sum()) == 499500          # the card still works
