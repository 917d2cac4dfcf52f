"""Port parity: first-occurrence dedup + compaction
(``ops/compaction.py::dedup_compact_rows_plain``).

The port's plain dedup and compaction, the plain version of the
non-doubles kernel's dedup (``ops/nondoubles.py``), is held bit for bit
against the JAX package's non-doubles dedup:
``jax.vmap(core.movegen._dedup_pairwise)`` for the flags, then the
Pallas ``compact_rows`` (interpreter mode on the CPU) and the vmapped jnp
``_compact``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlp_ppo_2ply_p3_tpu.core import movegen as JM
from mlp_ppo_2ply_p3_tpu.ops import compaction as JC
from mlp_ppo_2ply_p3_tpu_torch.core import movegen as TM
from mlp_ppo_2ply_p3_tpu_torch.ops import compaction as TC

from .test_torch_utils import canonical, nn_, random_positions, tt

J_DEDUP = jax.jit(jax.vmap(JM._dedup_pairwise))


def _case(g, k, seed, frac=0.8, planted=0.4, nibble=False):
    """(G, K, 52) int8 rows with counts 0..15, a share ``planted`` of
    them copies of an earlier row; with ``nibble`` the copies differ in
    the high nibble of every byte, which ``pack_key`` ignores."""
    rng = np.random.default_rng(seed)
    boards = rng.integers(0, 16, (g, k, 52)).astype(np.int8)
    for gi in range(g):
        for i in np.flatnonzero(rng.random(k) < planted):
            if i == 0:
                continue
            row = boards[gi, rng.integers(0, i)].view(np.uint8)
            if nibble:
                high = rng.integers(0, 16, 52).astype(np.uint8) << 4
                row = (row & 0x0F) | high
            boards[gi, i] = row.view(np.int8)
    valid = rng.random((g, k)) < frac
    return boards, valid


def _jax_dedup_compact(boards, valid, k_out):
    """The JAX package's path: vmapped _dedup_pairwise flags, then both
    compactions (Pallas in interpreter mode, and jnp _compact)."""
    jb = jnp.asarray(boards)
    keep = J_DEDUP(jb, jnp.asarray(valid))
    out, count = JC.compact_rows(jb, keep, k_out)
    (j_out,), j_n = jax.vmap(lambda v, p: JM._compact((p,), v, k_out))(
        keep, jb)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(j_out))
    np.testing.assert_array_equal(np.asarray(count), np.asarray(j_n))
    return np.asarray(keep), np.asarray(out), np.asarray(count)


def _check_against_jax(boards, valid, k_out):
    keep, want_out, want_count = _jax_dedup_compact(boards, valid, k_out)
    flags = TM._dedup_pairwise(tt(boards), tt(valid))
    np.testing.assert_array_equal(nn_(flags), keep)
    out, count = TC.dedup_compact_rows_plain(tt(boards), tt(valid), k_out)
    assert out.dtype == torch.int8 and count.dtype == torch.int32
    assert out.shape == (len(boards), k_out, 52)
    np.testing.assert_array_equal(nn_(out), want_out)
    np.testing.assert_array_equal(nn_(count), want_count)
    return keep, nn_(count)


# (G, K, k_out, fraction valid, planted share, high-nibble copies)
CASES = [
    (3, 40, 16, 0.8, 0.4, False),     # planted duplicates, counts > k_out
    (5, 37, 64, 0.7, 0.5, False),     # K not a multiple of 32, counts < k_out
    (4, 70, 30, 0.9, 0.5, True),      # copies equal only in the low nibble
    (2, 288, 256, 0.9, 0.6, False),   # the train4096 shape, small G
    (3, 288, 256, 0.5, 0.2, True),
    (6, 33, 8, 1.0, 0.7, False),      # every row valid
]


@pytest.mark.parametrize("g,k,k_out,frac,planted,nibble", CASES)
def test_plain_matches_jax_dedup_and_compactions(g, k, k_out, frac, planted,
                                                 nibble):
    boards, valid = _case(g, k, seed=g * 1000 + k, frac=frac,
                          planted=planted, nibble=nibble)
    keep, _ = _check_against_jax(boards, valid, k_out)
    assert (keep.sum(1) < valid.sum(1)).any(), "no duplicate was planted"


def test_counts_cross_k_out():
    """Counts above and below k_out in one batch."""
    boards, valid = _case(8, 60, seed=5, frac=0.6, planted=0.3)
    valid[0] = False
    valid[1] = True
    keep, count = _check_against_jax(boards, valid, 24)
    assert (count > 24).any() and (count < 24).any() and count[0] == 0


def test_duplicates_of_invalid_rows_do_not_suppress():
    """A valid row whose only earlier copies are invalid is kept."""
    boards, valid = _case(4, 50, seed=8, planted=0.0)
    valid[:] = True
    for g in range(4):
        boards[g, 30] = boards[g, 3]          # copy of an invalid row
        valid[g, 3] = False
        boards[g, 40] = boards[g, 10]         # copy of a valid row
    keep, _ = _check_against_jax(boards, valid, 50)
    assert keep[:, 30].all() and not keep[:, 40].any()


def test_k_out_zero():
    boards, valid = _case(3, 45, seed=2)
    keep = np.asarray(J_DEDUP(jnp.asarray(boards), jnp.asarray(valid)))
    out, count = TC.dedup_compact_rows_plain(tt(boards), tt(valid), 0)
    assert out.shape == (3, 0, 52)
    np.testing.assert_array_equal(nn_(count), keep.sum(1))


def test_numpy_loop_and_uint8_flags():
    """Against a direct loop over the rows, with uint8 flags too."""
    boards, valid = _case(5, 41, seed=13, planted=0.5, nibble=True)
    for flags in (valid, valid.astype(np.uint8)):
        out, count = TC.dedup_compact_rows_plain(tt(boards), tt(flags), 20)
        for g in range(5):
            seen, rows = set(), []
            for i in range(41):
                key = (boards[g, i].view(np.uint8) & 0xF).tobytes()
                if valid[g, i] and key not in seen:
                    seen.add(key)
                    rows.append(boards[g, i])
            want = np.zeros((20, 52), np.int8)
            want[:min(len(rows), 20)] = np.array(rows[:20]).reshape(-1, 52)
            np.testing.assert_array_equal(nn_(out[g]), want)
            assert int(count[g]) == len(rows)


def test_nondoubles_movegen_still_matches_jax():
    """Non-doubles rolls only, so every game goes through the dedup:
    ``legal_afterstates_batch`` under ``fast()`` against JAX."""
    b = 48
    rng = np.random.default_rng(77)
    boards, players = random_positions(rng, b, "any")
    d = rng.integers(1, 7, (4 * b, 2))
    dice = d[d[:, 0] != d[:, 1]][:b].astype(np.int8)
    kw = dict(max_moves=256, k2=80, k3=192, dedup_width=288, dbl_div=5,
              dbl_add=56)
    vecs, mirror = canonical(boards, players), players == 1
    want = JM.legal_afterstates_batch(jnp.asarray(vecs), jnp.asarray(dice),
                                      JM.MovegenConfig(**kw),
                                      mirror=jnp.asarray(mirror))
    got = TM.legal_afterstates_batch(tt(vecs), tt(dice),
                                     TM.MovegenConfig(**kw),
                                     mirror=tt(mirror))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(nn_(g), np.asarray(w))
