"""Data-parallel training of the port over real gloo process groups on the
CPU: the twin of ``tests/test_sharding.py`` and
``tests/test_multiprocess.py``, at their sizes (B=16, T=8,
``MovegenConfig(max_moves=64, k2=64, k3=64)``, hidden 32, 1 epoch, 2
minibatches).

Each case starts its ranks as subprocesses of this file (``python
tests/test_torch_sharding.py <case> <rank> <size> <port> <dir>``), which
import no JAX and write their results to ``<dir>``; the test compares
them with an unsharded run in this process.  A sharded run is the
unsharded global computation with its sums in another order, so:

- (a) W=2 and W=4 ``train_step`` == W=1: every env integer and the
  generator exact, parameters, Adam moments and losses within rtol / atol
  2e-5 (``tests/test_sharding.py``'s tolerance); the same at B=1024,
  where a reset overflows movegen's non-doubles sub-batch;
- (b) W=2 ``train_step`` with the JAX package's draws replayed (written
  here to an npz) == JAX's ``train_step``, within
  ``test_torch_learner.check_update``'s tolerances, in index and
  afterstate modes;
- (c) the driver, ``train(..., updates=3)``, at W=2 == ``shard=False``;
- (d) a W=2 checkpoint is array for array a W=1 one (floats within
  2e-5), a W=2 run of 2 updates resumed to 3 == 3 straight updates bit
  for bit (the second rank pulling the checkpoint from the store), and
  a W=1 checkpoint resumes under W=2;
- the CLI under ``torchrun`` (2 ranks) == the CLI in one process;
- (e) B or a minibatch that does not divide by W raises.
"""

import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from mlp_ppo_2ply_p3_tpu_torch.core.movegen import MovegenConfig
from mlp_ppo_2ply_p3_tpu_torch.env import bg_env
from mlp_ppo_2ply_p3_tpu_torch.models.mlp import MLP, ModelConfig
from mlp_ppo_2ply_p3_tpu_torch.parallel import mesh
from mlp_ppo_2ply_p3_tpu_torch.ppo import learner
from mlp_ppo_2ply_p3_tpu_torch.ppo import train as train_mod
from mlp_ppo_2ply_p3_tpu_torch.utils import convert
from mlp_ppo_2ply_p3_tpu_torch.utils.config import RunConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T = 16, 8
ENV = bg_env.EnvConfig(movegen=MovegenConfig(max_moves=64, k2=64, k3=64))
MODEL = ModelConfig(action_size=64, hidden_size=32)
PPO = learner.PPOConfig(num_envs=B, t_horizon=T, num_epochs=1,
                        num_minibatches=2)
TOL = dict(rtol=2e-5, atol=2e-5)
TIMEOUT = 120
# at B >= 512 movegen's sub-batches have capacities below B
WIDE = 1024


def run_cfg(tmp, name, **kw):
    base = dict(name=name, env=ENV, model=MODEL, ppo=PPO, num_updates=3,
                checkpoint_every=0, eval_every=0,
                checkpoint_dir=os.path.join(tmp, "ckpts"),
                metrics_path=os.path.join(tmp, "metrics.jsonl"))
    base.update(kw)
    return RunConfig(**base)


def state_of(ts, env, metrics) -> dict:
    """Everything of a train state and env (shard) and its metrics."""
    return {
        "params": {n: p.detach().clone()
                   for n, p in ts.model.named_parameters()},
        "mu": list(ts.opt_state.mu), "nu": list(ts.opt_state.nu),
        "count": ts.opt_state.count, "update_idx": ts.update_idx,
        "episodes": ts.episodes, "gen": ts.gen.get_state(),
        "env": dict(zip(env._fields, env)),
        "metrics": {k: float(v) for k, v in metrics.items()},
    }


# --- the ranks (this file run as a script) -----------------------------------


class ShardedReplay(learner.Sampler):
    """The JAX run's global draws, each handed to this rank as its rows
    (a permutation is global)."""

    def __init__(self, world, actions, draws, perms):
        super().__init__(torch.Generator(), world)
        self._a, self._d, self._p = iter(actions), iter(draws), iter(perms)

    def actions(self, masked):
        return mesh.shard_batch(next(self._a), self.world)

    def env_draws(self, batch_size):
        return mesh.shard_batch(next(self._d), self.world)

    def permutation(self, n, device):
        return next(self._p)


def _step_case(world, tmp):
    ts = learner.init_train_state(0, MODEL, PPO, device="cpu")
    env = bg_env.reset(torch.Generator().manual_seed(1), ENV, B,
                       device="cpu", world=world)
    return {"step": state_of(*learner.train_step(ts, env, ENV, MODEL, PPO,
                                                 world=world))}


def _wide_case(world, tmp):
    """A reset of WIDE games, whose first rolls (all non-doubles)
    overflow movegen's non-doubles sub-batch, and a T=2 ``train_step``
    from it."""
    ppo = dataclasses.replace(PPO, num_envs=WIDE, t_horizon=2)
    ts = learner.init_train_state(0, MODEL, ppo, device="cpu")
    env = bg_env.reset(torch.Generator().manual_seed(1), ENV, WIDE,
                       device="cpu", world=world)
    out = state_of(*learner.train_step(ts, env, ENV, MODEL, ppo,
                                       world=world))
    out["reset"] = dict(zip(env._fields, env))
    return {"wide": out}


def _jax_case(world, tmp):
    """train_step from the JAX run's weights and start, its draws
    replayed."""
    with np.load(os.path.join(tmp, "jax.npz")) as d:
        data = {k: d[k] for k in d}
    cfg = learner.PPOConfig(**json.loads(str(data["cfg"])))
    tree = {layer: {k: data[f"params/{layer}/{k}"] for k in ("w", "b")}
            for layer in ("fc1", "action", "value", "score")}
    model = convert.params_from_jax(tree, MODEL, device="cpu")
    zero = torch.zeros((), dtype=torch.int32)
    ts = learner.TrainState(model, learner.init_optimizer(model),
                            torch.Generator(), zero, zero.clone())
    env = bg_env.make_state(*(mesh.shard_batch(torch.from_numpy(
        data[f"env0/{k}"]), world) for k in ("points", "bar", "off", "turn",
                                            "dice")), ENV)
    draws = [bg_env.StepDraws(*(torch.from_numpy(data[f"draws/{f}"][t])
                                for f in bg_env.StepDraws._fields))
             for t in range(cfg.t_horizon)]
    sampler = ShardedReplay(world, torch.from_numpy(data["actions"]), draws,
                            torch.from_numpy(data["perms"]).long())
    return {"jax": state_of(*learner.train_step(ts, env, ENV, MODEL, cfg,
                                                sampler, world))}


def _train_case(world, tmp):
    ts, env, m, _ = train_mod.train(run_cfg(tmp, "shardtest"), resume=False,
                                    write_metrics=False, device="cpu",
                                    world=world)
    return {"train": state_of(ts, env, m)}


def _ckpt_case(world, tmp):
    """One update with a checkpoint; 3 straight updates; 2 updates and a
    resume to 3 with the second rank on a disk of its own; a resume from
    the W=1 run's checkpoint in ``tmp/w1``."""
    store = "file://" + os.path.join(tmp, "store")
    w2 = os.path.join(tmp, "w2")
    base = run_cfg(tmp, "one", num_updates=1, checkpoint_every=1,
                   checkpoint_dir=w2, remote_url=store)

    def run(cfg, resume=False):
        ts, env, m, _ = train_mod.train(cfg, resume=resume,
                                        write_metrics=False, device="cpu",
                                        world=world)
        return state_of(ts, env, m)

    run(base)
    out = {"straight": run(dataclasses.replace(base, name="straight",
                                               num_updates=3))}
    own_disk = dataclasses.replace(
        base, name="resumed", num_updates=2,
        checkpoint_dir=os.path.join(tmp, f"rank{world.rank}"))
    run(own_disk)
    out["resumed"] = run(dataclasses.replace(own_disk, num_updates=3),
                         resume=True)
    out["from_w1"] = run(dataclasses.replace(
        base, name="from1", num_updates=2,
        checkpoint_dir=os.path.join(tmp, "w1")), resume=True)
    return out


def _refuse_case(world, tmp):
    """NCCL's rule: two ranks may not claim one device (no card needed:
    only the claims are exchanged)."""
    mesh.refuse_shared_devices(mesh.World(world.rank, world.size,
                                          torch.device("cuda", world.rank),
                                          "nccl"))
    try:
        mesh.refuse_shared_devices(mesh.World(world.rank, world.size,
                                              torch.device("cuda", 0),
                                              "nccl"))
    except ValueError as e:
        return {"refused": str(e)}
    return {"refused": None}


CASES = {"step": _step_case, "wide": _wide_case, "jax": _jax_case, "train": _train_case,
         "ckpt": _ckpt_case, "refuse": _refuse_case}


def worker(case, rank, size, port, tmp):
    torch.set_num_threads(1)
    world = mesh.initialize_distributed(f"localhost:{port}", int(size),
                                        int(rank), device="cpu")
    assert world == mesh.World(int(rank), int(size), torch.device("cpu"),
                               "gloo")
    try:
        out = CASES[case](world, tmp)
    finally:
        mesh.shutdown()
    torch.save(out, os.path.join(tmp, f"{case}_{rank}.pt"))


# --- the tests ---------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def worker_env() -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT", "BG_NO_DIST_AUTODETECT"):
        env.pop(var, None)
    return env


def finish(cmds, cwd, logs) -> list:
    """Run the commands at once, each one's output into its log file
    (a rank blocked on a full pipe would stall the others); every one must
    exit 0 within TIMEOUT.  Returns the outputs."""
    procs = []
    try:
        for cmd, log in zip(cmds, logs):
            with open(log, "w") as f:
                procs.append(subprocess.Popen(
                    cmd, stdout=f, stderr=subprocess.STDOUT,
                    env=worker_env(), cwd=cwd))
        for p in procs:
            p.wait(timeout=TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = [open(log).read() for log in logs]
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out}"
    return outs


def spawn(case, size, tmp) -> tuple:
    """Run ``case`` on ``size`` ranks; (their results, their outputs)."""
    port = free_port()
    outs = finish(
        [[sys.executable, os.path.abspath(__file__), case, str(r), str(size),
          str(port), str(tmp)] for r in range(size)], REPO,
        [os.path.join(tmp, f"{case}_{r}.log") for r in range(size)])
    return [torch.load(os.path.join(tmp, f"{case}_{r}.pt"))
            for r in range(size)], outs


def assert_same(a, b, what):
    assert a.dtype == b.dtype and torch.equal(a, b), what


def assert_ranks_agree(states):
    """The train state is replicated: every rank holds rank 0's, bit for
    bit, and the generators stay in lockstep."""
    for s in states[1:]:
        for n, p in states[0]["params"].items():
            assert_same(p, s["params"][n], n)
        assert_same(states[0]["gen"], s["gen"], "generator")
        for k, v in states[0]["metrics"].items():
            if k not in ("update_time_s", "steps_per_sec"):  # own clocks
                assert s["metrics"][k] == v, k


def assert_matches(shards, want, env_exact=True):
    """Sharded states (one per rank) against an unsharded one: integers
    and the generator exact, floats within TOL."""
    assert_ranks_agree(shards)
    got = shards[0]
    for n, p in want["params"].items():
        torch.testing.assert_close(got["params"][n], p, **TOL, msg=n)
    for k in ("mu", "nu"):
        for a, b in zip(got[k], want[k]):
            torch.testing.assert_close(a, b, **TOL)
    for k in ("count", "update_idx", "episodes", "gen"):
        assert_same(got[k], want[k], k)
    if env_exact:
        for f, x in want["env"].items():
            assert_same(torch.cat([s["env"][f] for s in shards]), x, f)
    for k in ("loss", "policy_loss", "value_loss", "entropy"):
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k],
                                   **TOL, err_msg=k)


@pytest.mark.parametrize("size", [2, 4])
def test_train_step_sharded_equals_unsharded(tmp_path, size):
    shards, _ = spawn("step", size, tmp_path)
    want = _step_case(None, tmp_path)["step"]
    assert_matches([s["step"] for s in shards], want)
    # the episode count, overflow and the means are global statistics
    for k in ("episodes_finished", "movegen_overflow", "mean_reward",
              "entropy_coef"):
        assert shards[0]["step"]["metrics"][k] == want["metrics"][k], k


@pytest.mark.parametrize("size", [2, 4])
def test_capacity_overflow_is_the_global_batchs(tmp_path, size):
    """A reset's first rolls are all non-doubles, so at B >= 512 some
    games overflow the non-doubles sub-batch: the shards overflow exactly
    the unsharded run's games and carry its rows for them."""
    shards, _ = spawn("wide", size, tmp_path)
    want = _wide_case(None, tmp_path)["wide"]
    assert int(want["reset"]["overflow"].sum()) > 0     # the capacity binds
    for f, x in want["reset"].items():
        assert_same(torch.cat([s["wide"]["reset"][f] for s in shards]), x,
                    f)
    assert_matches([s["wide"] for s in shards], want)


@pytest.mark.parametrize("mode", ["index", "afterstate"])
def test_train_step_sharded_equals_jax(tmp_path, mode):
    """W=2 from the JAX run's weights and start, JAX's draws replayed."""
    from .test_torch_learner import (MODES, TMODEL, check_update,
                                     endgame_positions, jax_run)

    run = jax_run(mode)
    arrays = {f"params/{layer}/{k}": v for layer, p in run.params0.items()
              for k, v in p.items()}
    arrays.update({f"env0/{k}": v for k, v in zip(
        ("points", "bar", "off", "turn", "dice"), endgame_positions(1))})
    arrays.update({f"draws/{f}": np.stack([d[i].numpy() for d in run.draws])
                   for i, f in enumerate(bg_env.StepDraws._fields)})
    arrays["actions"] = np.asarray(run.traj.action)
    arrays["perms"] = np.stack([p.numpy() for p in run.perms])
    arrays["cfg"] = np.array(json.dumps(MODES[mode]))
    np.savez(tmp_path / "jax.npz", **arrays)
    shards, _ = spawn("jax", 2, tmp_path)
    shards = [s["jax"] for s in shards]
    assert_ranks_agree(shards)
    for f, x in zip(run.env1._fields, run.env1):
        np.testing.assert_array_equal(
            torch.cat([s["env"][f] for s in shards]).numpy(), np.asarray(x),
            err_msg=f)
    got = shards[0]
    model = MLP(TMODEL, device="cpu")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(got["params"][n])
    ts = learner.TrainState(model, learner.AdamState(got["count"], got["mu"],
                                                     got["nu"]),
                            torch.Generator(), got["update_idx"],
                            got["episodes"])
    check_update(ts, {k: torch.tensor(v) for k, v in got["metrics"].items()},
                 run)


def test_driver_sharded_equals_unsharded(tmp_path):
    """``train(..., updates=3)`` at W=2 against ``shard=False``, the twin
    of test_sharding.py::test_train_cli_path_sharded_matches_unsharded."""
    shards, outs = spawn("train", 2, tmp_path)
    assert "sharded: 16 games over 2 ranks (backend gloo)" in outs[0]
    assert "sharded:" not in outs[1]   # rank 0 alone prints
    ts, env, m, _ = train_mod.train(run_cfg(str(tmp_path), "shardtest"),
                                    resume=False, write_metrics=False,
                                    device="cpu", shard=False)
    assert int(ts.update_idx) == 3
    assert_matches([s["train"] for s in shards], state_of(ts, env, m),
                   env_exact=False)


def test_checkpoints_do_not_depend_on_the_layout(tmp_path):
    tmp = str(tmp_path)
    w1 = os.path.join(tmp, "w1")

    def unsharded(name, updates, resume=False, **kw):
        cfg = run_cfg(tmp, name, num_updates=updates, checkpoint_every=1,
                      checkpoint_dir=w1, **kw)
        return state_of(*train_mod.train(cfg, resume=resume,
                                         write_metrics=False,
                                         device="cpu")[:3])

    unsharded("one", 1)
    unsharded("from1", 1)            # the W=1 checkpoint the ranks resume
    straight2 = unsharded("two", 2)
    shards, _ = spawn("ckpt", 2, tmp_path)

    with np.load(os.path.join(w1, "one", "ckpt_1.npz")) as a, np.load(
            os.path.join(tmp, "w2", "one", "ckpt_1.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
            if a[k].dtype.kind == "f":
                np.testing.assert_allclose(b[k], a[k], **TOL, err_msg=k)
            else:
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    for s in shards:
        for k in ("params", "env"):
            for n, x in s["straight"][k].items():
                assert_same(s["resumed"][k][n], x, f"{k} {n}")
        for k in ("mu", "nu"):
            for x, y in zip(s["straight"][k], s["resumed"][k]):
                assert_same(y, x, k)
        for k in ("count", "update_idx", "episodes", "gen"):
            assert_same(s["resumed"][k], s["straight"][k], k)
    # rank 1 had no checkpoint on its disk: it pulled rank 0's
    assert os.path.exists(os.path.join(tmp, "rank1", "resumed",
                                       "ckpt_2.npz"))
    assert_matches([s["from_w1"] for s in shards], straight2)


def test_cli_under_torchrun_equals_one_process(tmp_path, monkeypatch):
    """``torchrun --nproc-per-node 2 -m ...ppo.train --preset debug``
    (its environment detected, gloo on the CPU) against the same CLI in
    one process: the metrics rank 0 writes agree within TOL."""
    (tmp_path / "two").mkdir()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
           "2", "--master-port", str(free_port()), "-m",
           "mlp_ppo_2ply_p3_tpu_torch.ppo.train", "--preset", "debug",
           "--updates", "1", "--device", "cpu", "--no-resume"]
    (out,) = finish([cmd], tmp_path / "two", [tmp_path / "torchrun.log"])
    assert "sharded: 8 games over 2 ranks (backend gloo)" in out
    assert out.count("done: 1 updates") == 1
    monkeypatch.chdir(tmp_path)
    train_mod.main(["--preset", "debug", "--updates", "1", "--device", "cpu",
                    "--no-resume"])
    (one,) = [json.loads(x) for x in open("metrics/debug.jsonl")]
    (two,) = [json.loads(x) for x in open("two/metrics/debug.jsonl")]
    for k in ("loss", "policy_loss", "value_loss", "entropy",
              "mean_reward", "episodes_finished"):
        np.testing.assert_allclose(two[k], one[k], **TOL, err_msg=k)


def test_shared_device_refused(tmp_path):
    shards, _ = spawn("refuse", 2, tmp_path)
    for s in shards:
        assert "NCCL needs one device per rank" in s["refused"]


def test_indivisible_batch_raises(tmp_path):
    """The port cannot fall back to one device as JAX does: it raises
    before any collective."""
    world = mesh.World(0, 2, torch.device("cpu"), "gloo")
    odd = run_cfg(str(tmp_path), "odd",
                  ppo=dataclasses.replace(PPO, num_envs=15))
    with pytest.raises(ValueError, match="must divide by the 2 ranks"):
        train_mod.train(odd, device="cpu", world=world)
    # B divides, the minibatch (6 x 1 / 2 = 3 rows) does not
    ppo = dataclasses.replace(PPO, num_envs=6, t_horizon=1)
    with pytest.raises(ValueError, match="minibatch 3"):
        train_mod.train(run_cfg(str(tmp_path), "odd", ppo=ppo),
                        device="cpu", world=world)
    ts = learner.init_train_state(0, MODEL, ppo, device="cpu")
    env = bg_env.reset(ts.gen, ENV, 3, device="cpu")
    with pytest.raises(ValueError, match="minibatch 3"):
        learner.train_step(ts, env, ENV, MODEL, ppo, world=world)


if __name__ == "__main__":
    worker(*sys.argv[1:])
