"""The port's remaining tools: ``tools/render.py``,
``utils/profiling.timed_scan`` with ``scripts/perf_movegen.py``, and
``scripts/save_frozen.py``.

- ``render_state`` / ``board_to_ascii`` give the JAX package's strings
  on fresh and mid-game boards (bars and borne-off checkers included).
- ``timed_scan``, ``timed_eager`` and ``wall_time`` return positive
  means on the CPU; ``busy_seconds`` is the length of a union of
  intervals.
- ``perf_movegen`` at ``--device cpu`` and B=32 prints one JSON line
  with the JAX script's section keys, each with its eager twin, and
  ``dedup384_ms`` times ``dedup_compact_rows_plain``.
- ``save_frozen`` turns a driver checkpoint into an asset that both
  packages load."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlp_ppo_2ply_p3_tpu.agents import frozen as JF
from mlp_ppo_2ply_p3_tpu.core.movegen import MovegenConfig as JMovegenConfig
from mlp_ppo_2ply_p3_tpu.env import bg_env as JE
from mlp_ppo_2ply_p3_tpu.tools import render as JR
from mlp_ppo_2ply_p3_tpu_torch.agents import frozen
from mlp_ppo_2ply_p3_tpu_torch.core.movegen import MovegenConfig
from mlp_ppo_2ply_p3_tpu_torch.env import bg_env as TE
from mlp_ppo_2ply_p3_tpu_torch.ops import compaction as OC
from mlp_ppo_2ply_p3_tpu_torch.ppo import train as train_mod
from mlp_ppo_2ply_p3_tpu_torch.scripts import perf_movegen, save_frozen
from mlp_ppo_2ply_p3_tpu_torch.tools import render
from mlp_ppo_2ply_p3_tpu_torch.utils import convert, profiling

from .test_torch_train import tiny_cfg
from .test_torch_utils import jax_reset_draws, random_positions, split_abs, tt

M = 64
JENV = JE.EnvConfig(movegen=JMovegenConfig(max_moves=M))
TENV = TE.EnvConfig(movegen=MovegenConfig(max_moves=M))
# the JAX script's keys (scripts/perf_movegen.py)
SECTION_KEYS = {"B", "full_ms", "nondoubles_ms", "doubles_ms",
                "nd_one_order_ms", "compact832to384_ms", "dedup384_ms",
                "compact384to256_ms", "dbl_compact5600to256_ms",
                "dbl_expand_L4_ms"}


def test_render_matches_jax():
    import jax

    turn, dice = jax_reset_draws(jax.random.PRNGKey(0), 4)
    fresh = TE.reset_with_draws(turn, dice, TENV)
    rng = np.random.default_rng(3)
    boards, players = random_positions(rng, 6, "any")
    arrays = (*split_abs(boards), players.astype(np.int8),
              rng.integers(1, 7, (6, 2)).astype(np.int8))
    mid = TE.make_state(*(tt(x) for x in arrays), TENV)
    jmid = JE.make_state(*(jnp.asarray(x) for x in arrays), JENV)
    assert int(mid.off.sum()) > 0 and int(mid.bar.sum()) > 0
    for i in range(4):
        want = JR.board_to_ascii(np.asarray(fresh.points[i]),
                                 np.asarray(fresh.bar[i]),
                                 np.asarray(fresh.off[i]),
                                 int(fresh.turn[i]), np.asarray(fresh.dice[i]))
        assert render.render_state(fresh, i) == want
    for i in range(6):
        assert render.render_state(mid, i) == JR.render_state(jmid, i)
        assert render.board_to_ascii(arrays[0][i], arrays[1][i],
                                     arrays[2][i]) == JR.board_to_ascii(
            arrays[0][i], arrays[1][i], arrays[2][i])
    both = np.zeros((2, 24), np.int8)
    both[:, 5] = 1                               # an impossible board
    assert "!?" in render.board_to_ascii(both, np.zeros(2), np.zeros(2))


def test_timed_scan_on_cpu():
    calls = []
    x = torch.arange(8)
    got = profiling.timed_scan(lambda a: calls.append(a.sum()), x, iters=5)
    assert isinstance(got, float) and got > 0
    assert len(calls) == 6                       # one warm-up call
    got = profiling.timed_eager(lambda a: calls.append(a.sum()), x, iters=3)
    assert isinstance(got, float) and got > 0 and len(calls) == 10
    got = profiling.wall_time(lambda: calls.append(1), n=2, warmup=2)
    assert isinstance(got, float) and got > 0 and len(calls) == 14


def test_busy_seconds_is_a_union():
    assert profiling.busy_seconds([]) == 0
    assert profiling.busy_seconds([(5, 7), (0, 2), (1, 3), (6, 9),
                                   (3, 3.5), (10, 11)]) == 8.5
    assert profiling.device_label("cpu") == "cpu"


@pytest.mark.parametrize("readings,want,traces", [
    ([5, 10, 10], 10, 3),           # a dropped record shortens the first
    ([30, 10, 10.1], 10.1, 3),      # the clocks still rising at first
    ([10, 9.9], 10, 2),
    ([1, 2, 3, 4, 5, 6], 6, 6),     # no two agree: the largest
])
def test_device_busy_traces_until_two_agree(monkeypatch, readings, want,
                                            traces):
    """``device_busy`` with scripted traces in the profiler's place (one
    CUDA record of each reading's length, in ms): it traces until two in a
    row agree within ``AGREE`` and keeps the larger of the two."""
    import torch.profiler

    script = iter(readings)

    class Event:
        def __init__(self, ms):
            self.ms = ms

        def start_ns(self):
            return 0

        def end_ns(self):
            return int(self.ms * 1e6)

        def device_type(self):
            return torch.autograd.DeviceType.CUDA

    class Trace:
        def __init__(self, **kw):
            self.profiler = self

        def __enter__(self):
            self.kineto_results = self
            self.ms = next(script)
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return [Event(self.ms)]

    monkeypatch.setattr(torch.profiler, "profile", Trace)
    monkeypatch.setattr(profiling, "resolve_device",
                        lambda d: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    got = profiling.device_busy(lambda: None, "cuda")
    assert got == pytest.approx(want * 1e-3)
    assert [t for t, _ in profiling.device_busy.traces] == pytest.approx(
        [r * 1e-3 for r in readings[:traces]])


def test_perf_step_on_cpu(capsys):
    """``scripts/perf_step.py`` at afterstate4096's flags, 8 games and
    T=8 (2 states a minibatch) on the CPU: one JSON line with every key,
    the device keys null."""
    from mlp_ppo_2ply_p3_tpu_torch.scripts import perf_step

    row = perf_step.main(["--envs", "8", "--t", "8", "--device", "cpu"])
    (line,) = capsys.readouterr().out.splitlines()
    assert json.loads(line) == row
    assert (row["preset"], row["B"], row["T"], row["policy_mode"],
            row["device"]) == ("afterstate4096", 8, 8, "afterstate", "cpu")
    for k in ("warmup_s", "train_step_s", "env_steps_per_s", "rollout_s",
              "update_s"):
        assert row[k] > 0, k
    for k in ("peak_gb", "rollout_device_s", "update_device_s",
              "rollout_idle_share", "update_idle_share"):
        assert row[k] is None, k
    assert np.isfinite(row["loss"])


def test_perf_movegen_on_cpu(capsys, monkeypatch):
    torch.manual_seed(0)
    res = perf_movegen.main(["32", "--device", "cpu"])
    (line,) = capsys.readouterr().out.splitlines()
    assert json.loads(line) == res
    assert SECTION_KEYS <= set(res) and res["B"] == 32
    assert res["device"] == "cpu"
    for k in SECTION_KEYS - {"B"}:
        assert res[k] > 0, k
        assert res[k[:-len("_ms")] + "_eager_ms"] > 0, k
    for shape in ("ndblock", "ndfinal", "dblL3", "dblL4"):
        assert res[f"{shape}_plain_ms"] > 0
        assert res[f"{shape}_plain_eager_ms"] > 0
        assert res[f"{shape}_kernel_ms"] is None   # the kernel needs a card
        assert res[f"{shape}_kernel_eager_ms"] is None
    calls = []
    inner = OC.dedup_compact_rows_plain

    def counted(boards, valid, k_out):
        calls.append((tuple(boards.shape), k_out))
        return inner(boards, valid, k_out)

    monkeypatch.setattr(OC, "dedup_compact_rows_plain", counted)
    res = perf_movegen.main(["32", "dedup,c384", "--device", "cpu"])
    assert set(res) == {"B", "device", "dedup384_ms", "dedup384_eager_ms",
                        "compact384to256_ms", "compact384to256_eager_ms"}
    # the reset's movegen dedups once through it (the non-doubles batch's
    # plain version, on the CPU); then dedup384 times it: warm-up + 20
    # calls, twice
    want = 1 + 2 * (1 + profiling.SCAN_ITERS)
    assert calls == [((32, 384, 52), 256)] * want


def test_save_frozen_round_trip(tmp_path, monkeypatch, capsys):
    """A one-update afterstate run's checkpoint -> an asset holding its
    network, which both packages load."""
    cfg = tiny_cfg(tmp_path, num_updates=1, ppo=dataclasses.replace(
        tiny_cfg(tmp_path).ppo, policy_mode="afterstate"))
    ts, _, _, _ = train_mod.train(dataclasses.replace(cfg, name="run7"),
                                  resume=False, device="cpu")
    monkeypatch.setattr(save_frozen, "get_preset", lambda name: cfg)
    out = str(tmp_path / "asset.npz")
    assert save_frozen.main(["run7", "--out", out, "--device", "cpu"]) == out
    assert "(update 1, hidden 32)" in capsys.readouterr().out
    model, mcfg = frozen.load_frozen(out, device="cpu")
    assert mcfg == cfg.model
    want = convert.params_to_numpy(ts.model)
    for layer, p in convert.params_to_numpy(model).items():
        for k in ("w", "b"):
            np.testing.assert_array_equal(p[k], want[layer][k])
    jparams, jcfg = JF.load_frozen(out)
    assert jcfg.hidden_size == 32 and jcfg.action_size == M
    np.testing.assert_array_equal(np.asarray(jparams["score"]["w"]),
                                  want["score"]["w"])
    monkeypatch.setattr(save_frozen, "get_preset", lambda name: (
        dataclasses.replace(cfg, checkpoint_dir=str(tmp_path / "none"))))
    with pytest.raises(SystemExit, match="no checkpoint"):
        save_frozen.main(["run7", "--out", out, "--device", "cpu"])
