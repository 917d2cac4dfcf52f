"""The port's training driver (``ppo/train.py``) and its support modules
(``utils/{remote,metrics,profiling}.py``) on the CPU, at the tiny
configurations of ``tests/test_remote.py`` and ``tests/test_overflow.py``.

- The remote store: put/get/list, and failures that return False.
- The driver uploads checkpoints and metrics; resumes from the store
  after a local wipe (local first, then remote); starts fresh with
  neither; writes TensorBoard event files; applies the overflow policy.
- A run resumed from a checkpoint ends bit for bit where an
  uninterrupted run ends.
- The league eval has JAX's keys; the layout of a run's files against
  JAX's ``train()`` is in ``tests/test_torch_train_layout.py``."""

import dataclasses
import json
import os
import shutil

import pytest
import torch

from mlp_ppo_2ply_p3_tpu_torch.agents import arena
from mlp_ppo_2ply_p3_tpu_torch.core.movegen import MovegenConfig
from mlp_ppo_2ply_p3_tpu_torch.env import bg_env
from mlp_ppo_2ply_p3_tpu_torch.models.mlp import ModelConfig
from mlp_ppo_2ply_p3_tpu_torch.ppo import learner
from mlp_ppo_2ply_p3_tpu_torch.ppo import train as train_mod
from mlp_ppo_2ply_p3_tpu_torch.utils import metrics, profiling
from mlp_ppo_2ply_p3_tpu_torch.utils.config import RunConfig
from mlp_ppo_2ply_p3_tpu_torch.utils.remote import RemoteStore, maybe_store

from .test_torch_checkpoint import assert_equal_states

torch.set_num_threads(1)

# the JAX driver's league keys (ppo/train.py::_arena_stats, league_eval)
LEAGUE_KEYS = {
    f"league/{stat}_vs_{tag}"
    for stat in ("win_rate", "finished", "points_a", "points_b",
                 "point_margin", "avg_plies")
    for tag in ("heuristic", "frozen_v1")
} | {"league/win_rate_vs_baseline"}


def tiny_cfg(tmp_path, **kw):
    """``tests/test_remote.py``'s configuration."""
    base = dict(
        name="remotetest",
        env=bg_env.EnvConfig(movegen=MovegenConfig(max_moves=64, k2=64,
                                                   k3=64)),
        model=ModelConfig(action_size=64, hidden_size=32),
        ppo=learner.PPOConfig(num_envs=8, t_horizon=4, num_epochs=1,
                              num_minibatches=2),
        num_updates=2,
        checkpoint_every=1,
        eval_every=0,
        overflow_policy="none",
        checkpoint_dir=str(tmp_path / "ckpts"),
        metrics_path=str(tmp_path / "metrics.jsonl"),
    )
    base.update(kw)
    return RunConfig(**base)


def train(cfg, **kw):
    return train_mod.train(cfg, device="cpu", **kw)


# --- the remote store --------------------------------------------------------


def test_put_get_list_file_backend(tmp_path):
    remote = tmp_path / "bucket"
    local = tmp_path / "local"
    local.mkdir()
    store = RemoteStore(f"file://{remote}")
    f = local / "metrics.jsonl"
    f.write_text('{"a": 1}\n')
    assert store.put(str(f), "run1/metrics.jsonl")
    out = tmp_path / "down.jsonl"
    assert store.get("run1/metrics.jsonl", str(out))
    assert out.read_text() == '{"a": 1}\n'
    # a directory uploads recursively
    d = local / "ckpt_10"
    (d / "sub").mkdir(parents=True)
    (d / "meta.json").write_text("{}")
    (d / "sub" / "arr.bin").write_bytes(b"\x00\x01")
    assert store.put(str(d), "run1/ckpt_10")
    assert store.list("run1") == ["run1/ckpt_10/meta.json",
                                  "run1/ckpt_10/sub/arr.bin",
                                  "run1/metrics.jsonl"]


def test_store_failures_are_graceful(tmp_path, capsys):
    store = RemoteStore(f"file://{tmp_path}/bucket")
    assert store.put(str(tmp_path / "missing.bin"), "x") is False
    assert store.get("nope", str(tmp_path / "out")) is False
    assert store.list("nowhere") == []
    assert "failed" in capsys.readouterr().out
    assert maybe_store("") is None and maybe_store(None) is None
    with pytest.raises(ValueError):
        RemoteStore("ftp://nope")
    # the cloud schemes parse without a client (none is contacted here)
    s3, gs = RemoteStore("s3://bucket/pfx/"), RemoteStore("gs://bkt")
    assert (s3.scheme, s3.bucket, s3.prefix) == ("s3", "bucket", "pfx")
    assert (gs.scheme, gs.bucket, gs.prefix) == ("gs", "bkt", "")


# --- the driver --------------------------------------------------------------


def test_train_uploads_checkpoints_and_metrics(tmp_path):
    cfg = tiny_cfg(tmp_path, remote_url=f"file://{tmp_path}/bucket")
    ts, _, last, _ = train(cfg, resume=False)
    assert int(ts.update_idx) == 2
    assert sorted(os.listdir(tmp_path / "ckpts" / "remotetest")) == [
        "ckpt_1.npz", "ckpt_2.npz"]
    assert RemoteStore(cfg.remote_url).list("") == [
        "remotetest/ckpt_1.npz", "remotetest/ckpt_2.npz",
        "remotetest/metrics.jsonl"]
    lines = [json.loads(x) for x in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in lines] == [0, 1]
    assert all(isinstance(v, float) for v in last.values())
    assert lines[-1]["loss"] == last["loss"]


def test_remote_resume_after_local_disk_wipe(tmp_path, capsys):
    """A worker whose local checkpoint dir is gone resumes from the
    newest checkpoint in the store, which lands back on local disk."""
    cfg = tiny_cfg(tmp_path, remote_url=f"file://{tmp_path}/bucket")
    ts, _, _, _ = train(cfg, resume=False)
    shutil.rmtree(tmp_path / "ckpts")
    ts2, _, _, _ = train(dataclasses.replace(cfg, num_updates=3),
                         resume=True)
    assert int(ts2.update_idx) == 3
    out = capsys.readouterr().out
    assert "pulled remote checkpoint remotetest/ckpt_2" in out
    assert "resumed from" in out and "at update 2" in out
    assert (tmp_path / "ckpts" / "remotetest" / "ckpt_2.npz").is_file()


def test_local_checkpoint_wins_over_remote(tmp_path, capsys):
    """Local first, then remote: a local checkpoint is restored even when
    the store holds a newer one."""
    cfg = tiny_cfg(tmp_path, remote_url=f"file://{tmp_path}/bucket")
    train(cfg, resume=False)
    os.remove(tmp_path / "ckpts" / "remotetest" / "ckpt_2.npz")
    ts, _, _, _ = train(dataclasses.replace(cfg, num_updates=2),
                        resume=True)
    out = capsys.readouterr().out
    assert "at update 1" in out and "pulled" not in out
    assert int(ts.update_idx) == 2


def test_remote_resume_without_store_starts_fresh(tmp_path):
    ts, _, _, _ = train(tiny_cfg(tmp_path), resume=True)
    assert int(ts.update_idx) == 2


def test_tb_logdir_writes_event_files(tmp_path):
    pytest.importorskip("torch.utils.tensorboard")
    cfg = tiny_cfg(tmp_path, tb_logdir=str(tmp_path / "tb" / "{name}"),
                   num_updates=1)
    train(cfg, resume=False)
    events = list((tmp_path / "tb" / "remotetest").glob(
        "events.out.tfevents.*"))
    assert events and events[0].stat().st_size > 0


# test_overflow.py's caps: the opening position alone overflows max_moves
TINY = MovegenConfig(max_moves=4, k2=8, k3=8, dedup_width=16)


def overflow_cfg(policy, tmp_path, updates=1):
    return RunConfig(
        name=f"overflow_{policy}",
        env=bg_env.EnvConfig(movegen=TINY),
        model=ModelConfig(action_size=4, hidden_size=16),
        ppo=learner.PPOConfig(num_envs=8, t_horizon=4, num_epochs=1,
                              num_minibatches=2),
        num_updates=updates,
        checkpoint_every=0,
        eval_every=0,
        checkpoint_dir=str(tmp_path),
        overflow_policy=policy,
    )


def test_overflow_abort_raises(tmp_path):
    with pytest.raises(RuntimeError, match="saturation"):
        train(overflow_cfg("abort", tmp_path), resume=False,
              write_metrics=False)


def test_overflow_warn_completes_and_warns_once(tmp_path, capsys):
    ts, _, last, _ = train(overflow_cfg("warn", tmp_path, updates=2),
                           resume=False, write_metrics=False)
    assert int(ts.update_idx) == 2 and last["movegen_overflow"] > 0
    assert capsys.readouterr().out.count("saturation") == 1
    assert os.listdir(tmp_path) == []     # checkpoint_every=0 saves none


def test_resumed_run_equals_uninterrupted(tmp_path):
    """3 updates in one run == 2 updates, then a resume to 3: parameters,
    Adam's state, the generator, the counters and the env state bit for
    bit, and the last update's losses."""
    full = train(tiny_cfg(tmp_path / "a", num_updates=3), resume=False)
    cfg = tiny_cfg(tmp_path / "b")
    train(cfg, resume=False)
    part = train(dataclasses.replace(cfg, num_updates=3), resume=True)
    assert_equal_states(full[:2], part[:2])
    for k in ("loss", "policy_loss", "value_loss", "entropy"):
        assert full[2][k] == part[2][k], k


def test_reset_each_update_and_final_checkpoint(tmp_path):
    """``reset_each_update`` reseeds every update's games from (seed,
    update), so a resumed run draws them again; a run that ends between
    two checkpoints saves none at its end, as the JAX driver does."""
    ppo = dataclasses.replace(tiny_cfg(tmp_path).ppo, reset_each_update=True)
    a = train(tiny_cfg(tmp_path / "a", ppo=ppo, num_updates=3,
                       checkpoint_every=2), resume=False)
    assert os.listdir(tmp_path / "a" / "ckpts" / "remotetest") == [
        "ckpt_2.npz"]
    cfg = tiny_cfg(tmp_path / "b", ppo=ppo, num_updates=1)
    train(cfg, resume=False)
    b = train(dataclasses.replace(cfg, num_updates=3), resume=True)
    assert_equal_states(a[:2], b[:2])
    g1 = train_mod.fold_in(0, 5, "cpu")
    assert torch.equal(g1.get_state(), train_mod.fold_in(0, 5,
                                                         "cpu").get_state())
    assert not torch.equal(g1.get_state(),
                           train_mod.fold_in(7, 5, "cpu").get_state())


def test_debug_nans_raises_at_first_bad_update(tmp_path, monkeypatch):
    inner = learner.train_step

    def bad_step(*args, **kw):
        ts, env, m = inner(*args, **kw)
        if int(ts.update_idx) == 2:
            m["value_loss"] = torch.tensor(float("inf"))
        return ts, env, m

    monkeypatch.setattr(learner, "train_step", bad_step)
    cfg = tiny_cfg(tmp_path, num_updates=3)
    train(dataclasses.replace(cfg, name="clean"), resume=False)
    with pytest.raises(FloatingPointError, match="update 1"):
        train(dataclasses.replace(cfg, debug_nans=True), resume=False)


def test_profile_report_and_trace(tmp_path, capsys, monkeypatch):
    profiling.report()  # sections of earlier runs in this process
    train(tiny_cfg(tmp_path, num_updates=1), resume=False, profile=True)
    out = capsys.readouterr().out
    assert "profile sections:" in out
    assert "train_step: 1 calls" in out and "checkpoint: 1 calls" in out
    with profiling.device_trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert json.load(open(tmp_path / "trace" / "trace.json"))
    with profiling.section("x", sync=True):
        pass
    assert "x: 1 calls" in profiling.report()
    assert profiling.report() == ""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profiling.timeit(lambda: calls.append(1))   # CUDA events only
    assert calls == []


def test_metrics_to_host():
    got = metrics.to_host({"a": torch.tensor(1.5), "n": torch.tensor(
        7, dtype=torch.int32), "x": 2.0, "s": "text"})
    assert got == {"a": 1.5, "n": 7.0, "x": 2.0, "s": "text"}
    assert all(type(got[k]) is float for k in ("a", "n"))


def test_cli_and_league_play_the_drivers_checkpoint(tmp_path, monkeypatch,
                                                     capsys):
    """``python -m ...ppo.train --preset debug --updates 1 --device cpu``,
    the preset's checkpoint cadence cut from 10 updates to 1, writes
    metrics and a checkpoint in the working directory; the league CLI's
    ``--params-from ckpt`` then plays that checkpoint; without
    ``--device`` and without a card the driver raises."""
    from mlp_ppo_2ply_p3_tpu_torch.agents import league
    from mlp_ppo_2ply_p3_tpu_torch.utils.config import get_preset

    assert get_preset("debug").checkpoint_every == 10
    monkeypatch.setattr(train_mod, "get_preset", lambda name: (
        dataclasses.replace(get_preset(name), checkpoint_every=1)))
    monkeypatch.chdir(tmp_path)
    train_mod.main(["--preset", "debug", "--updates", "1", "--device",
                    "cpu"])
    out = capsys.readouterr().out
    assert "update 0: loss=" in out and "done: 1 updates" in out
    assert os.listdir("checkpoints/debug") == ["ckpt_1.npz"]
    assert len(open("metrics/debug.jsonl").readlines()) == 1
    league.main(["--preset", "debug", "--pair", "index:random", "--games",
                 "2", "--max-plies", "2", "--params-from", "ckpt",
                 "--device", "cpu"])
    out = capsys.readouterr().out
    assert "params from checkpoints/debug/ckpt_1.npz (update 1)" in out
    assert json.loads(out.strip().splitlines()[-1])["games"] == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_mod.main(["--preset", "debug", "--updates", "1"])


def test_profile_cli_traces_the_spans(tmp_path, monkeypatch, capsys):
    """``--profile`` with ``PROFILE_TRACE_DIR`` set: the section timers,
    and the Chrome trace holds the program's spans of the update."""
    profiling.report()  # sections of earlier runs in this process
    monkeypatch.setattr(train_mod, "get_preset",
                        lambda name: tiny_cfg(tmp_path))
    monkeypatch.setenv("PROFILE_TRACE_DIR", str(tmp_path / "trace"))
    train_mod.main(["--preset", "tiny", "--updates", "1", "--device", "cpu",
                    "--profile", "--no-resume"])
    assert "train_step: 1 calls" in capsys.readouterr().out
    trace = json.load(open(tmp_path / "trace" / "trace.json"))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"train_step", "rollout", "policy", "env_step", "movegen",
            "ppo_update", "minibatch_step", "adam_step",
            "checkpoint"} <= names


def cap_plies(monkeypatch, module, name, plies):
    """Cut a league arena's 400 plies to ``plies`` (the key set does not
    depend on them)."""
    inner = getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a, **kw: inner(*a[:7], plies, **kw))


def test_league_eval_keys_and_ranges(tmp_path, monkeypatch):
    """The port's league at 2 games, its arenas cut to 30 plies (a CPU
    ply takes about 13 ms here): JAX's key set, win rates in [0, 1], and
    both arenas' games."""
    cap_plies(monkeypatch, arena, "play", 30)
    cfg = tiny_cfg(tmp_path, eval_games=2)
    model = learner.init_train_state(0, cfg.model, cfg.ppo,
                                     device="cpu").model
    ev = train_mod.league_eval(cfg, model, train_mod.fold_in(7, 0, "cpu"))
    assert set(ev) == LEAGUE_KEYS
    for tag in ("heuristic", "frozen_v1", "baseline"):
        assert 0.0 <= ev[f"league/win_rate_vs_{tag}"] <= 1.0
    for tag in ("heuristic", "frozen_v1"):
        assert 0 <= ev[f"league/finished_vs_{tag}"] <= 2
        assert 0 < ev[f"league/avg_plies_vs_{tag}"] <= 30


def test_run_learning_script(tmp_path, monkeypatch, capsys):
    """The port's ``scripts/run_learning.py`` at a tiny size: it names the
    run, sets JAX's cadences (its checkpoint cadence then cut from 50
    updates to 1), streams metrics to ``metrics/learning_<name>.jsonl``,
    and a second call resumes."""
    from mlp_ppo_2ply_p3_tpu_torch.scripts import run_learning

    tiny = tiny_cfg(tmp_path, name="afterstate4096", ppo=dataclasses.replace(
        tiny_cfg(tmp_path).ppo, policy_mode="afterstate"))
    monkeypatch.setattr(run_learning, "get_preset", lambda name: tiny)

    def train_every_update(cfg, **kw):
        assert (cfg.checkpoint_every, cfg.eval_every, cfg.eval_games,
                cfg.log_every) == (50, 20, 1024, 5)
        return train_mod.train(dataclasses.replace(cfg, checkpoint_every=1),
                               **kw)

    monkeypatch.setattr(run_learning, "train", train_every_update)
    monkeypatch.chdir(tmp_path)
    run_learning.main(["1", "--hidden", "32", "--tag", "t", "--device",
                      "cpu"])
    assert "learning run afterstate4096_t done: 1 updates" in (
        capsys.readouterr().out)
    assert os.listdir("checkpoints/afterstate4096_t") == ["ckpt_1.npz"]
    run_learning.main(["2", "--hidden", "32", "--tag", "t", "--device",
                      "cpu"])
    out = capsys.readouterr().out
    assert "at update 1" in out and "done: 2 updates" in out
    assert len(open("metrics/learning_afterstate4096_t.jsonl")
               .readlines()) == 1     # log_every=5: updates 0 and 5, ...
