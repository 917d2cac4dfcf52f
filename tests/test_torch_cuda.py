"""The port's CUDA kernel on the card (``csrc/compaction.cu``).

Every test here needs an NVIDIA card and skips without one: a CUDA
kernel has no CPU mode.  The file imports neither JAX nor the JAX
package, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` configures JAX).  The CPU
parity of the plain version with the JAX Pallas kernels is in
``tests/test_torch_compaction.py``."""

import numpy as np
import pytest
import torch

from mlp_ppo_2ply_p3_tpu_torch.core import movegen as TM
from mlp_ppo_2ply_p3_tpu_torch.env import bg_env as TE
from mlp_ppo_2ply_p3_tpu_torch.ops import compaction as TC

pytestmark = pytest.mark.cuda

# (B, N, C, k_out, fraction valid): N not a multiple of 8 / 32 / 128 /
# 256, B = 1, counts above and below k_out, k_out = 0
CASES = [
    (1, 5, 3, 4, 0.7),
    (1, 4096, 55, 3604, 0.8),
    (3, 37, 52, 16, 0.5),
    (9, 130, 53, 40, 0.5),
    (5, 300, 7, 400, 0.4),
    (6, 257, 1, 33, 0.2),
    (4, 50, 2, 0, 0.5),
    (875, 5184, 53, 256, 0.03),
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
    before = TC.compact_rows.launches
    got = TM.legal_afterstates_batch(*args)
    assert (TC.compact_rows.launches - before
            == TM.compactions_per_call(cfg.movegen))
    cpu = TM.legal_afterstates_batch(*(a.cpu() if torch.is_tensor(a) else a
                                       for a in args))
    monkeypatch.setattr(TC, "compact_rows", TC.compact_rows_plain)
    plain = TM.legal_afterstates_batch(*args)
    torch.cuda.synchronize()
    for g, p, c in zip(got, plain, cpu):
        assert torch.equal(g, p) and torch.equal(g.cpu(), c)
