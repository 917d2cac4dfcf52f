"""The port's CUDA kernels on the card (``csrc/compaction.cu``).

Every test here needs an NVIDIA card and skips without one: a CUDA
kernel has no CPU mode.  The file imports neither JAX nor the JAX
package, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` configures JAX).  The CPU
parity of the plain version with the JAX Pallas kernels is in
``tests/test_torch_compaction.py`` and ``tests/test_torch_dedup.py``."""

import numpy as np
import pytest
import torch

from mlp_ppo_2ply_p3_tpu_torch.core import movegen as TM
from mlp_ppo_2ply_p3_tpu_torch.env import bg_env as TE
from mlp_ppo_2ply_p3_tpu_torch.ops import compaction as TC

pytestmark = pytest.mark.cuda

# (B, N, C, k_out, fraction valid): N not a multiple of 8 / 32 / 128 /
# 256, B = 1, counts above and below k_out, k_out = 0, every main-path
# call shape of train4096, and the split-N layout (B small, N large: B = 1
# with N in the tens of thousands, counts crossing k_out inside a tile)
CASES = [
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


# (G, K, k_out, fraction valid, planted share, high-nibble copies): the CPU
# cases of tests/test_torch_dedup.py, the main-path call, and the parity
# width (dynamic shared memory above 48 KB)
DEDUP_CASES = [
    (3, 40, 16, 0.8, 0.4, False),
    (5, 37, 64, 0.7, 0.5, False),
    (4, 70, 30, 0.9, 0.5, True),
    (2, 288, 256, 0.9, 0.6, False),
    (3, 288, 256, 0.5, 0.2, True),
    (6, 33, 8, 1.0, 0.7, False),
    (8, 60, 0, 0.6, 0.3, False),
    (3604, 288, 256, 0.3, 0.3, False),
    (64, 512, 500, 0.9, 0.5, True),
    (2048, 288, 128, 0.3, 0.3, False),   # 2-ply reply dedup, width 128
]


def _dedup_case(g, k, seed, frac, planted, nibble):
    rng = np.random.default_rng(seed)
    boards = rng.integers(0, 16, (g, k, 52)).astype(np.int8)
    src = (rng.random((g, k)) * np.arange(k)[None, :]).astype(np.int64)
    copy = rng.random((g, k)) < planted
    copy[:, 0] = False
    for i in range(1, k):   # in order, so copies of copies chain
        rows = boards[np.arange(g), src[:, i]].view(np.uint8)
        if nibble:
            rows = (rows & 0x0F) | (rng.integers(0, 16, rows.shape)
                                    .astype(np.uint8) << 4)
        boards[copy[:, i], i] = rows[copy[:, i]].view(np.int8)
    valid = rng.random((g, k)) < frac
    return boards, valid


@pytest.mark.parametrize("g,k,k_out,frac,planted,nibble", DEDUP_CASES)
def test_dedup_kernel_matches_plain(card, g, k, k_out, frac, planted,
                                    nibble):
    boards, flags = _dedup_case(g, k, g * 7 + k, frac, planted, nibble)
    boards = torch.from_numpy(boards).to(card)
    valid = torch.from_numpy(flags).to(card)
    before = TC.dedup_compact_rows.launches
    out, count = TC.dedup_compact_rows(boards, valid, k_out)
    assert TC.dedup_compact_rows.launches == before + 1
    want_out, want_count = TC.dedup_compact_rows_plain(boards, valid, k_out)
    torch.cuda.synchronize()
    assert torch.equal(out, want_out) and torch.equal(count, want_count)
    assert bool((want_count < valid.sum(1)).any()) or planted == 0
    out8, count8 = TC.dedup_compact_rows(boards, valid.to(torch.uint8), k_out)
    assert torch.equal(out8, want_out) and torch.equal(count8, want_count)


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
    before_dedup = TC.dedup_compact_rows.launches
    got = TM.legal_afterstates_batch(*args)
    assert (TC.compact_rows.launches - before
            == TM.compactions_per_call(cfg.movegen))
    assert (TC.dedup_compact_rows.launches - before_dedup
            == TM.dedups_per_call(cfg.movegen) == 1)
    cpu = TM.legal_afterstates_batch(*(a.cpu() if torch.is_tensor(a) else a
                                       for a in args))
    monkeypatch.setattr(TC, "compact_rows", TC.compact_rows_plain)
    monkeypatch.setattr(TC, "dedup_compact_rows", TC.dedup_compact_rows_plain)
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
    import dataclasses

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
    before = (TC.compact_rows.launches, TC.dedup_compact_rows.launches)
    got = twoply.twoply_actions_values(model, es, scfg)
    counted = (TC.compact_rows.launches - before[0],
               TC.dedup_compact_rows.launches - before[1])
    assert counted == twoply.launches_per_decision(32, scfg)
    monkeypatch.setattr(TC, "compact_rows", TC.compact_rows_plain)
    monkeypatch.setattr(TC, "dedup_compact_rows", TC.dedup_compact_rows_plain)
    plain = twoply.twoply_actions_values(model, es, scfg)
    torch.cuda.synchronize()
    for g, p in zip(got, plain):
        assert torch.equal(g, p)
