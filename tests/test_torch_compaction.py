"""Port parity: stable compaction (``ops/compaction.py``).

On the CPU the port's ``compact_rows`` runs its plain PyTorch version;
it is held bit for bit against both JAX Pallas kernels (interpreter mode
on the CPU) and against the vmapped jnp ``_compact`` of the JAX movegen.
The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py`` (skipped without a card) and by
``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlp_ppo_2ply_p3_tpu.core import movegen as JM
from mlp_ppo_2ply_p3_tpu.ops import compaction as JC
from mlp_ppo_2ply_p3_tpu_torch.core import movegen as TM
from mlp_ppo_2ply_p3_tpu_torch.ops import compaction as TC

from .test_torch_utils import nn_, tt

# (B, N, C, k_out, fraction valid): N not a multiple of 8 / 32 / 128,
# B not a multiple of 8, counts above and below k_out, B = 1
CASES = [
    (1, 5, 3, 4, 0.7),
    (1, 130, 52, 16, 0.5),
    (3, 37, 52, 16, 0.5),
    (9, 130, 53, 40, 0.5),
    (5, 300, 7, 400, 0.4),
    (7, 27, 52, 16, 0.9),
    (6, 257, 1, 33, 0.2),
]


def _case(b, n, c, frac, seed):
    rng = np.random.default_rng(seed)
    payload = rng.integers(-128, 128, (b, n, c)).astype(np.int8)
    valid = rng.random((b, n)) < frac
    if b > 2:
        valid[1] = False   # an all-invalid row
        valid[2] = True    # an all-valid row
    return payload, valid


@pytest.mark.parametrize("b,n,c,k_out,frac", CASES)
def test_plain_matches_both_pallas_kernels_and_jnp(b, n, c, k_out, frac):
    payload, valid = _case(b, n, c, frac, seed=b * 1000 + n)
    out, count = TC.compact_rows(tt(payload), tt(valid), k_out)
    assert out.dtype == torch.int8 and count.dtype == torch.int32
    assert out.shape == (b, k_out, c) and count.shape == (b,)
    np.testing.assert_array_equal(nn_(count), valid.sum(1))
    for kernel in (JC.compact_rows, JC.compact_rows_segmented):
        j_out, j_count = kernel(jnp.asarray(payload), jnp.asarray(valid),
                                k_out)
        np.testing.assert_array_equal(nn_(out), np.asarray(j_out))
        np.testing.assert_array_equal(nn_(count), np.asarray(j_count))
    (j_out,), j_n = jax.vmap(lambda v, p: JM._compact((p,), v, k_out))(
        jnp.asarray(valid), jnp.asarray(payload))
    np.testing.assert_array_equal(nn_(out), np.asarray(j_out))
    np.testing.assert_array_equal(nn_(count), np.asarray(j_n))


def test_plain_against_numpy_loop():
    payload, valid = _case(11, 97, 4, 0.3, seed=7)
    for k_out in (0, 1, 5, 30, 120):
        out, count = TC.compact_rows(tt(payload), tt(valid), k_out)
        for g in range(11):
            rows = payload[g][valid[g]][:k_out]
            want = np.zeros((k_out, 4), np.int8)
            want[:len(rows)] = rows
            np.testing.assert_array_equal(nn_(out[g]), want)
            assert int(count[g]) == valid[g].sum()


def test_uint8_flags_and_cpu_launch_count():
    payload, valid = _case(4, 40, 3, 0.5, seed=3)
    before = TC.compact_rows.launches
    a = TC.compact_rows(tt(payload), tt(valid), 10)
    b = TC.compact_rows(tt(payload), tt(valid.astype(np.uint8)), 10)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(nn_(x), nn_(y))
    assert TC.compact_rows.launches == before, "CPU tensors launch nothing"


@pytest.mark.parametrize("bad", ["dtype", "flags", "shape", "contiguous"])
def test_wrapper_rejects(bad):
    payload = torch.zeros((2, 8, 3), dtype=torch.int8)
    valid = torch.zeros((2, 8), dtype=torch.bool)
    if bad == "dtype":
        payload = payload.to(torch.int32)
    elif bad == "flags":
        valid = valid.to(torch.int32)
    elif bad == "shape":
        valid = valid[:, :7]
    else:
        payload = torch.zeros((2, 3, 8), dtype=torch.int8).transpose(1, 2)
    with pytest.raises((TypeError, ValueError)):
        TC.compact_rows(payload, valid, 4)


def test_compact_batch_mixed_payloads():
    """movegen's _compact_batch: boards (int8, C=52) and ranks (int8
    scalars per row) and int32 dice come back split and in their dtypes,
    equal to the JAX jnp path."""
    rng = np.random.default_rng(9)
    b, n = 5, 27
    boards = rng.integers(0, 16, (b, n, 52)).astype(np.int8)
    ranks = rng.integers(-1, 25, (b, n)).astype(np.int8)
    dice = rng.integers(1, 7, (b, n)).astype(np.int32)
    valid = rng.random((b, n)) < 0.4
    (gb, gr, gd), gn = TM._compact_batch((tt(boards), tt(ranks), tt(dice)),
                                         tt(valid), 16)
    assert gd.dtype == torch.int32
    (wb, wr, wd), wn = JM._compact_batch(
        (jnp.asarray(boards), jnp.asarray(ranks), jnp.asarray(dice)),
        jnp.asarray(valid), 16, False)
    for g, w in zip((gb, gr, gd, gn), (wb, wr, wd, wn)):
        np.testing.assert_array_equal(nn_(g), np.asarray(w))
