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
from mlp_ppo_2ply_p3_tpu_torch.ops import doubles as TD
from mlp_ppo_2ply_p3_tpu_torch.ops import nondoubles as TN

from .test_movegen import abs_to_canonical_np, canonical_to_abs_np
from .test_torch_doubles import EDGE_BOARDS
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


@pytest.mark.parametrize("name,kind", [("fast", "doubles"),
                                       ("wide", "doubles"),
                                       ("wide", "uniform")])
def test_partitioned_batch_doubles_capacity(name, kind):
    """B = 600 with doubles only (the doubles capacity binds: the games
    past it carry the last fitting doubles game's list, which the
    non-doubles kernel copies from that game's row of the output) or
    uniform dice, positions of every stage, game-over boards and both
    movers: equal to JAX bit for bit."""
    b = 600
    _, tcfg = _cfgs(name)
    rng = np.random.default_rng(601 + len(name) + len(kind))
    boards, players = zip(*(random_positions(rng, b // 3, stage)
                            for stage in STAGES))
    players = np.concatenate(players)
    vecs = canonical(np.concatenate(boards), players)
    vecs[::50] = EDGE_BOARDS["game_over"]
    dice = rng.integers(1, 7, (b, 2)).astype(np.int8)
    if kind == "doubles":
        dice[:, 1] = dice[:, 0]
    got = _batch(vecs, dice, players == 1, name)
    bd = TM.doubles_capacity(b, tcfg)
    is_double = dice[:, 0] == dice[:, 1]
    past = is_double & (np.cumsum(is_double) > bd)
    if kind == "doubles":
        last = np.flatnonzero(is_double)[bd - 1]
        assert past.sum() == b - bd
        assert torch.equal(got[0][tt(past)],
                           got[0][last].expand(int(past.sum()), -1, -1))
        assert int(got[1][tt(past)].abs().sum()) == 0
        assert bool(got[2][tt(past)].all())
    assert int(got[1][::50].abs().sum()) == 0 and int(got[1].sum()) > 0
    assert players.any() and not players.all()


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
    numbers of compactions, doubles levels, final levels and non-doubles
    batches per call are what compactions_per_call,
    doubles_levels_per_call, doubles_finals_per_call and
    nondoubles_per_call say.
    (16 games: the JAX Pallas kernels run in interpret mode here.)"""
    b = 16
    rng = np.random.default_rng(17)
    boards, players = random_positions(rng, b, "any")
    dice = rng.integers(1, 7, (b, 2)).astype(np.int8)
    calls = {"compact_rows": [], "doubles_levels": [], "doubles_final": [],
             "nondoubles_batch": []}

    def counting(module, name, keep):
        real = getattr(module, name)

        def wrapper(*args):
            calls[name].append(keep(args))
            return real(*args)
        monkeypatch.setattr(module, name, wrapper)

    counting(TC, "compact_rows", lambda a: a[-1])
    counting(TD, "doubles_levels", lambda a: a[3:])
    # (M, the in-place form's out and dst given)
    counting(TD, "doubles_final",
             lambda a: (a[9], len(a) == 12
                       and all(x is not None for x in a[10:])))
    # (dedup, the in-place form's placement and out given)
    counting(TN, "nondoubles_batch",
             lambda a: (a[7], len(a) == 10
                       and all(x is not None for x in a[8:])))
    _batch(canonical(boards, players), dice, players == 1, "fast", **over)
    _, tcfg = _cfgs("fast", **over)
    assert len(calls["compact_rows"]) == TM.compactions_per_call(tcfg) == 1
    assert (calls["doubles_levels"]
            == [(tcfg.k1, tcfg.k2, tcfg.k3)]
            * TM.doubles_levels_per_call(tcfg))
    assert TM.doubles_levels_per_call(tcfg) == 1
    assert (len(calls["doubles_final"])
            == TM.doubles_finals_per_call(tcfg) == 1)
    assert calls["doubles_final"] == [(tcfg.max_moves, True)]
    assert (calls["nondoubles_batch"]
            == [(tcfg.dedup, True)] * TM.nondoubles_per_call(tcfg))


def test_no_batch_wide_assembly_around_the_kernels(monkeypatch):
    """Unsharded, ``legal_afterstates_batch`` builds nothing of the
    (B, M, 52) output's size outside its four kernel calls (no gather, no
    ``where``, no non-doubles split): every torch op it and the kernels'
    wrappers run outside the kernels' plain versions is counted, and the
    largest tensor any makes is a (B,)-sized placement or the doubles
    sub-batch's inputs, but for the one output, which it allocates for
    the kernels to write.  Every tensor with an (M, 52) tail that those
    ops or a kernel make (what a wrapper allocates on the card) is that
    output: no doubles list of its own is allocated."""
    from torch.overrides import TorchFunctionMode

    b = 600
    _, tcfg = _cfgs("fast")
    m = tcfg.max_moves
    rng = np.random.default_rng(61)
    boards, players = random_positions(rng, b, "any")
    dice = rng.integers(1, 7, (b, 2)).astype(np.int8)
    inside, seen, lists = [0], [], []

    def tensors(out):
        return [x for x in (out if isinstance(out, tuple) else (out,))
                if isinstance(x, torch.Tensor)]

    class Record(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not inside[0]:
                for x in tensors(out):
                    seen.append((getattr(func, "__name__", str(func)),
                                 x.numel()))
                    if x.dim() == 3 and tuple(x.shape[1:]) == (m, 52):
                        lists.append(x)
            return out

    def kernel(module, name):
        real = getattr(module, name)

        def call(*args):
            inside[0] += 1
            try:
                out = real(*args)
            finally:
                inside[0] -= 1
            if not inside[0]:    # what the kernel writes
                lists.extend(x for x in tensors(out)
                             if x.dim() == 3 and tuple(x.shape[1:]) == (m, 52))
            return out
        monkeypatch.setattr(module, name, call)

    for module, name in ((TC, "compact_rows_plain"),
                         (TD, "doubles_levels_plain"),
                         (TD, "doubles_final_plain"),
                         (TN, "nondoubles_batch_plain")):
        kernel(module, name)
    vecs, mirror = tt(canonical(boards, players)), tt(players == 1)
    with Record():
        got = TM.legal_afterstates_batch(vecs, tt(dice), tcfg, mirror=mirror)
    kept = len(lists)
    want = TM.legal_afterstates_batch(vecs, tt(dice), tcfg, mirror=mirror)
    del lists[kept:]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    store = got[0].untyped_storage().data_ptr()
    assert {x.untyped_storage().data_ptr() for x in lists} == {store}
    assert len(lists) >= 3
    allocs = [(f, n) for f, n in seen if n == got[0].numel()]
    assert allocs == [("empty", b * m * 52)]
    assert seen and max(n for f, n in seen if (f, n) not in allocs) <= b * 54
    assert not [f for f, n in seen if f in ("gather", "where") and n > b]
