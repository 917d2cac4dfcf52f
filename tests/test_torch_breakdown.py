"""The port's step breakdown (``scripts/perf_breakdown.py``) on the CPU.

- At B=8, T=4: every key of the JAX script under both widths, with its
  eager twin; ``update_ms`` = train - rollout and the sps relations;
  every device-time key null, since there is no card.
- ``movegen_dedup_ms`` times the kernel that holds the dedup,
  ``nondoubles_batch`` with the dedup on, over all B games at
  (``k1``, ``dedup_width``, ``max_moves``).
- The non-doubles and doubles-sub-batch callables that the script times
  give the JAX script's callables' boards, counts and overflow flags bit
  for bit, on the same numpy-seeded positions and dice; the dedup piece
  gives the non-doubles batch's output."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlp_ppo_2ply_p3_tpu.core import movegen as JM
from mlp_ppo_2ply_p3_tpu_torch.core import movegen as TM
from mlp_ppo_2ply_p3_tpu_torch.ops import nondoubles as TN
from mlp_ppo_2ply_p3_tpu_torch.scripts import perf_breakdown
from mlp_ppo_2ply_p3_tpu_torch.utils import profiling

from .test_torch_utils import canonical, nn_, random_positions, tt

B, T = 8, 4
# the JAX script's keys under each width (scripts/perf_breakdown.py)
JAX_KEYS = {"movegen_ms", "movegen_nondoubles_ms",
            "movegen_doubles_subbatch_ms", "movegen_dedup_ms", "env_step_ms",
            "rollout_ms", "train_step_ms", "update_ms", "rollout_sps",
            "train_sps", "movegen_share_of_step"}
SCANS = ("movegen", "movegen_nondoubles", "movegen_doubles_subbatch",
         "movegen_dedup")
DEVICE_KEYS = {"env_step_device_ms", "rollout_device_ms",
               "train_step_device_ms", "update_device_ms",
               "rollout_idle_share", "train_step_idle_share",
               "movegen_device_share_of_step"}


@pytest.fixture(scope="module")
def line():
    """One run at B=8, T=4 on the CPU, with every ``nondoubles_batch``
    call and every ``timed_scan`` call recorded."""
    mp = pytest.MonkeyPatch()
    dedups, scans = [], []
    inner_dedup, inner_scan = TN.nondoubles_batch, perf_breakdown.timed_scan

    def counted_dedup(*args):
        dedups.append((tuple(args[0].shape), args[4:]))
        return inner_dedup(*args)

    def recorded_scan(fn, *args, **kw):
        before = len(dedups)
        out = inner_scan(fn, *args, **kw)
        scans.append((fn, args, len(dedups) - before))
        return out

    mp.setattr(TN, "nondoubles_batch", counted_dedup)
    mp.setattr(perf_breakdown, "timed_scan", recorded_scan)
    try:
        (row,) = perf_breakdown.main([str(B), "--t", str(T), "--device",
                                      "cpu"])
    finally:
        mp.undo()
    return row, scans, counted_dedup


def test_keys_and_relations(line):
    row, _, _ = line
    assert row["B"] == B and row["T"] == T and row["device"] == "cpu"
    assert set(row) == {"B", "T", "device", "default", "fast"}
    for width in ("default", "fast"):
        cell = row[width]
        twins = {f"{k}_eager_ms" for k in SCANS}
        assert set(cell) == JAX_KEYS | twins | DEVICE_KEYS
        for k in JAX_KEYS | twins:
            assert cell[k] > 0, (width, k)
        assert cell["update_ms"] == pytest.approx(
            cell["train_step_ms"] - cell["rollout_ms"])
        assert cell["rollout_sps"] == pytest.approx(
            B * T / (cell["rollout_ms"] / 1e3))
        assert cell["train_sps"] == pytest.approx(
            B * T / (cell["train_step_ms"] / 1e3))
        assert cell["movegen_share_of_step"] == pytest.approx(
            cell["movegen_ms"] / cell["env_step_ms"])
        for k in DEVICE_KEYS:          # no card: no device number
            assert cell[k] is None, (width, k)
    assert json.loads(json.dumps(row)) == row


def test_dedup_key_times_the_kernel_wrapper(line):
    """The dedup piece's timer calls ``nondoubles_batch`` (warm-up + 20
    calls) over the B games at (k1, dedup_width, max_moves), dedup on, for
    each width."""
    _, scans, counted_dedup = line
    dedup_scans = [(args, n) for fn, args, n in scans if fn is counted_dedup]
    assert len(scans) == 2 * len(SCANS) and len(dedup_scans) == 2
    for (args, n), (_, cfg) in zip(dedup_scans, perf_breakdown.widths()):
        vecs, d_hi, d_lo, mirror, *widths = args
        assert tuple(vecs.shape) == (B, 52)
        assert d_hi.shape == d_lo.shape == mirror.shape == (B,)
        assert widths == [cfg.k1, cfg.dedup_width, cfg.max_moves, True]
        assert n == 1 + profiling.SCAN_ITERS


@functools.lru_cache(maxsize=None)
def _jax_pieces(cfg):
    """The JAX script's two movegen callables (perf_breakdown.py:26-50),
    compiled."""
    nondoubles = jax.jit(lambda v, h, lo, mir: JM._nondoubles_batch(
        v, h, lo, cfg, mir))
    doubles = jax.jit(lambda v, d, mir: JM._doubles_batch(v, d, cfg, mir))
    return nondoubles, doubles


@pytest.mark.parametrize("width", ["default", "fast"])
def test_pieces_match_jax(width):
    bsz = 48
    rng = np.random.default_rng(11)
    boards, players = random_positions(rng, bsz, "any")
    vecs = canonical(boards, players)
    dice = rng.integers(1, 7, (bsz, 2)).astype(np.int8)
    dice[::5, 1] = dice[::5, 0]                   # some doubles
    tcfg = dict(perf_breakdown.widths())[width]
    jcfg = {"default": JM.MovegenConfig(max_moves=256),
            "fast": JM.MovegenConfig.fast(256)}[width]
    pieces = perf_breakdown.movegen_pieces(tt(vecs), tt(dice), tcfg)

    d0 = dice[:, 0].astype(np.int32)
    d1 = dice[:, 1].astype(np.int32)
    mir = jnp.zeros((bsz,), bool)
    bd = JM.doubles_capacity(bsz, jcfg)
    assert bd == TM.doubles_capacity(bsz, tcfg)
    nondoubles, doubles = _jax_pieces(jcfg)
    want = {
        "movegen_nondoubles": nondoubles(
            jnp.asarray(vecs), jnp.maximum(d0, d1), jnp.minimum(d0, d1),
            mir),
        "movegen_doubles_subbatch": doubles(
            jnp.asarray(vecs[:bd]), jnp.asarray(d0[:bd]), mir[:bd]),
    }
    for key, jout in want.items():
        fn, args = pieces[key]
        got = fn(*args)
        for g, w, what in zip(got, jout, ("boards", "n_moves", "overflow")):
            np.testing.assert_array_equal(nn_(g), np.asarray(w),
                                          err_msg=f"{key} {what}")
    assert int(np.asarray(want["movegen_nondoubles"][1]).sum()) > 0

    # the dedup piece is the kernel of the non-doubles batch
    fn, args = pieces["movegen_dedup"]
    for g, w in zip(fn(*args), pieces["movegen_nondoubles"][0](
            *pieces["movegen_nondoubles"][1])):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
