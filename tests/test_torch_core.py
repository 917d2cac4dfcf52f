"""Port parity: board primitives, features and dice against the JAX
package.  Integer outputs must match bit for bit; features are small
integers over 1, 2 or 15 computed by the same float32 operations, so
they must match exactly too (tolerance 0)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlp_ppo_2ply_p3_tpu.core import board as JB
from mlp_ppo_2ply_p3_tpu.core import dice as JD
from mlp_ppo_2ply_p3_tpu.core import features as JF
from mlp_ppo_2ply_p3_tpu_torch.core import board as TB
from mlp_ppo_2ply_p3_tpu_torch.core import dice as TD
from mlp_ppo_2ply_p3_tpu_torch.core import features as TF

from .test_torch_utils import canonical, nn_, random_positions, split_abs, tt

STAGES = ["any", "bar", "bearoff"]


def _positions(stage, n=40):
    rng = np.random.default_rng(1000 + STAGES.index(stage))
    boards, players = random_positions(rng, n, stage)
    return boards, players, canonical(boards, players)


def _eq(got, want):
    np.testing.assert_array_equal(nn_(got), np.asarray(want))


@pytest.mark.parametrize("stage", STAGES)
def test_to_from_canonical_and_opponent_view(stage):
    boards, players, vecs = _positions(stage)
    points, bar, off = split_abs(boards)
    want = jax.vmap(JB.to_canonical)(
        jnp.asarray(points), jnp.asarray(bar), jnp.asarray(off),
        jnp.asarray(players))
    got = TB.to_canonical(tt(points), tt(bar), tt(off), tt(players))
    _eq(got, want)
    _eq(got, vecs)

    want_abs = jax.vmap(JB.from_canonical)(jnp.asarray(vecs),
                                           jnp.asarray(players))
    got_abs = TB.from_canonical(tt(vecs), tt(players))
    for g, w in zip(got_abs, want_abs):
        _eq(g, w)

    _eq(TB.opponent_view(tt(vecs)), JB.opponent_view(jnp.asarray(vecs)))


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("die", [1, 2, 3, 4, 5, 6])
def test_submoves_and_apply_every_slot(stage, die):
    """submoves_one_die for one die, then apply_submove on all 27 slots
    (valid or not) of every board."""
    _, _, vecs = _positions(stage)
    n = len(vecs)
    dies = np.full((n,), die, np.int32)
    want = jax.vmap(JB.submoves_one_die)(jnp.asarray(vecs), jnp.asarray(dies))
    got = TB.submoves_one_die(tt(vecs), tt(dies))
    for g, w in zip(got, want):
        assert g.dtype in (torch.bool, torch.int32)
        _eq(g, w)

    v, o, d, h = (np.asarray(x) for x in want)
    apply_j = jax.vmap(jax.vmap(JB.apply_submove, (None, 0, 0, 0)))
    want_after = apply_j(jnp.asarray(vecs), jnp.asarray(o), jnp.asarray(d),
                         jnp.asarray(h))
    got_after = TB.apply_submove(tt(vecs)[:, None, :], tt(o), tt(d), tt(h))
    assert got_after.dtype == torch.int8
    _eq(got_after, want_after)


@pytest.mark.parametrize("stage", STAGES)
def test_pack_key(stage):
    _, _, vecs = _positions(stage)
    # the full 0..15 nibble range, where the top word's shift wraps int32
    rng = np.random.default_rng(5)
    extra = rng.integers(0, 16, (20, 52)).astype(np.int8)
    both = np.concatenate([vecs, extra])
    _eq(TB.pack_key(tt(both)), jax.vmap(JB.pack_key)(jnp.asarray(both)))


@pytest.mark.parametrize("stage", STAGES)
def test_features_exact(stage):
    """Against the JAX package's compiled encoders, which is how its env
    and learner run them (XLA turns ``off / 15`` into a multiplication by
    the reciprocal; the port does the same)."""
    boards, players, vecs = _positions(stage)
    points, bar, off = split_abs(boards)
    # every borne-off count 0..15 appears
    off[:16, 0] = np.arange(16)
    want = jax.jit(JF.encode)(jnp.asarray(points), jnp.asarray(bar),
                              jnp.asarray(off), jnp.asarray(players))
    got = TF.encode(tt(points), tt(bar), tt(off), tt(players))
    assert got.dtype == torch.float32
    _eq(got, want)

    enc_c = jax.jit(jax.vmap(JF.encode_canonical))
    want_c = enc_c(jnp.asarray(vecs), jnp.asarray(players))
    got_c = TF.encode_canonical(tt(vecs), tt(players))
    _eq(got_c, want_c)
    # a (B, M, 52) block with one mover per game, as the learner uses it
    block = np.stack([vecs, vecs[::-1]], axis=1)
    want_b = enc_c(jnp.asarray(block), jnp.asarray(players))
    _eq(TF.encode_canonical(tt(block), tt(players)[:, None]), want_b)


def test_roll_tables():
    _eq(TD.ROLLS_21, JD.ROLLS_21)
    _eq(TD.ROLL_PROBS_21, JD.ROLL_PROBS_21)
    assert abs(float(TD.ROLL_PROBS_21.sum()) - 1.0) < 1e-6


def _chi2(counts, expected):
    return float(((counts - expected) ** 2 / expected).sum())


def test_roll_distribution_36():
    """Counts over 36 ordered outcomes at a fixed seed.  99.9% chi-square
    quantile for 35 dof is 66.6."""
    gen = torch.Generator().manual_seed(0)
    d = nn_(TD.roll(gen, (72_000,))).astype(np.int64)
    assert d.dtype == np.int64 and d.min() == 1 and d.max() == 6
    counts = np.bincount((d[:, 0] - 1) * 6 + d[:, 1] - 1, minlength=36)
    assert counts.min() > 0
    assert _chi2(counts, 72_000 / 36) < 66.6


def test_roll_nondouble_distribution_30():
    """Counts over the 30 ordered non-doubles at a fixed seed (99.9%
    chi-square quantile for 29 dof: 58.3); the index map is the JAX
    package's (every index 0..29 maps to a distinct non-double)."""
    gen = torch.Generator().manual_seed(1)
    d = nn_(TD.roll_nondouble(gen, (60_000,))).astype(np.int64)
    assert (d[:, 0] != d[:, 1]).all()
    counts = np.bincount((d[:, 0] - 1) * 6 + d[:, 1] - 1, minlength=36)
    off_diag = counts[np.arange(36) % 7 != 0]
    assert counts[np.arange(36) % 7 == 0].sum() == 0
    assert _chi2(off_diag, 60_000 / 30) < 58.3

    pairs = nn_(TD.nondouble_from_index(torch.arange(30)))
    i = np.arange(30)
    d0 = i // 5
    r = i % 5
    want = np.stack([d0 + 1, r + (r >= d0) + 1], axis=-1)
    np.testing.assert_array_equal(pairs, want)
    assert len({tuple(p) for p in pairs}) == 30
