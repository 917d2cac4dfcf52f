"""The port's data-parallel layer (``parallel/mesh.py``) in one process.

- ``initialize_distributed``: the twin of
  ``tests/test_multiprocess.py::test_autodetect_gating``, with
  ``torch.distributed.init_process_group`` replaced by a recorder: no
  flags is a strict no-op, a ``torchrun`` environment is detected, the
  opt-out holds, explicit flags pass through.
- The backend rules: ``nccl`` on the CPU raises, and so do two ranks on
  one card under ``nccl``; the default backend follows the device.
- ``shard_batch`` / ``gather_batch`` / ``all_reduce_sum`` / ``replicate``
  in a real gloo group of one, and a world of one == no world bit for
  bit on a ``train_step`` and on a reset whose movegen overflows.

Multi-process groups (gloo, 2 and 4 ranks) are in
``tests/test_torch_sharding.py``."""

import socket

import pytest
import torch
import torch.distributed as dist

from mlp_ppo_2ply_p3_tpu_torch.core.movegen import MovegenConfig
from mlp_ppo_2ply_p3_tpu_torch.env import bg_env
from mlp_ppo_2ply_p3_tpu_torch.models.mlp import ModelConfig
from mlp_ppo_2ply_p3_tpu_torch.parallel import mesh
from mlp_ppo_2ply_p3_tpu_torch.ppo import learner

torch.set_num_threads(1)

CPU = torch.device("cpu")
ENV_CFG = bg_env.EnvConfig(movegen=MovegenConfig(max_moves=64, k2=64, k3=64))
MODEL_CFG = ModelConfig(action_size=64, hidden_size=32)
LAUNCHER_VARS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                 "MASTER_ADDR", "MASTER_PORT", "BG_NO_DIST_AUTODETECT")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture
def recorder(monkeypatch):
    """init_process_group calls, recorded instead of made."""
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    monkeypatch.setattr(mesh, "_world", None)
    for var in LAUNCHER_VARS:
        monkeypatch.delenv(var, raising=False)
    return calls


def test_autodetect_gating(recorder, monkeypatch):
    assert mesh.initialize_distributed(device="cpu") is None
    assert recorder == []            # one process: strict no-op

    monkeypatch.setenv("WORLD_SIZE", "1")
    assert mesh.initialize_distributed(device="cpu") is None
    assert recorder == []            # a launcher of one rank: still one

    torchrun = {"WORLD_SIZE": "2", "RANK": "1", "LOCAL_RANK": "1",
                "MASTER_ADDR": "localhost", "MASTER_PORT": "29500"}
    for k, v in torchrun.items():
        monkeypatch.setenv(k, v)
    world = mesh.initialize_distributed(device="cpu")
    assert recorder == [(("gloo",), {"init_method": "env://",
                                     "world_size": 2, "rank": 1})]
    assert world == mesh.World(1, 2, CPU, "gloo")

    monkeypatch.setenv("BG_NO_DIST_AUTODETECT", "1")
    assert mesh.initialize_distributed(device="cpu") is None
    assert len(recorder) == 1        # opt-out respected

    # explicit flags always win and pass through
    monkeypatch.delenv("BG_NO_DIST_AUTODETECT")
    world = mesh.initialize_distributed("localhost:1234", 2, 1,
                                        device="cpu")
    assert recorder[-1] == (("gloo",), {"init_method": "tcp://localhost:1234",
                                        "world_size": 2, "rank": 1})
    assert world.rank == 1 and world.size == 2
    # --num-processes 1 is one process: the flags change nothing
    for k in torchrun:
        monkeypatch.delenv(k)
    assert mesh.initialize_distributed("localhost:1234", 1, 0,
                                       device="cpu") is None
    with pytest.raises(ValueError, match="--coordinator"):
        mesh.initialize_distributed(None, 2, 0, device="cpu")
    assert len(recorder) == 2


def test_backend_rules(recorder, monkeypatch):
    with pytest.raises(ValueError, match="nccl' needs CUDA"):
        mesh.initialize_distributed("localhost:1", 2, 0, backend="nccl",
                                    device="cpu")
    with pytest.raises(ValueError, match="choose one of"):
        mesh.initialize_distributed("localhost:1", 2, 0, backend="mpi",
                                    device="cpu")
    assert recorder == []
    # a host with one card and two torchrun ranks on it: NCCL refuses
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda dev: None)
    for k, v in {"WORLD_SIZE": "2", "RANK": "1", "LOCAL_RANK": "1",
                 "LOCAL_WORLD_SIZE": "2"}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="gloo"):
        mesh.initialize_distributed(device="cuda")   # nccl by default
    assert recorder == []
    world = mesh.initialize_distributed(backend="gloo", device="cuda")
    assert world == mesh.World(1, 2, torch.device("cuda", 0), "gloo")
    assert recorder[-1][0] == ("gloo",)


@pytest.fixture
def group_of_one():
    """A real gloo process group of one rank in this process."""
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        yield mesh.World(0, 1, CPU, "gloo")
    finally:
        dist.destroy_process_group()


def test_collectives_in_a_world_of_one(group_of_one):
    world = group_of_one
    assert mesh.current_world("cpu") == world
    gen = torch.Generator().manual_seed(0)
    x = torch.rand((6, 5), generator=gen)
    tree = (x, None, [torch.arange(6, dtype=torch.int32),
                      torch.rand(6, generator=gen) < 0.5],
            bg_env.StepDraws(*(torch.ones(6, 2, dtype=torch.int8)
                               for _ in range(3))))
    for fn in (mesh.shard_batch, mesh.gather_batch):
        out = fn(tree, world)
        assert out[1] is None and isinstance(out[3], bg_env.StepDraws)
        assert torch.equal(out[0], x)
        assert out[2][1].dtype == torch.bool
        assert torch.equal(out[2][1], tree[2][1])
    t2 = mesh.gather_batch(x[None], world, dim=1)
    assert torch.equal(t2, x[None])
    mixed = [x, torch.tensor([3, 4], dtype=torch.int32), x[0]]
    for got, want in zip(mesh.all_reduce_sum(mixed, world), mixed):
        assert got.dtype == want.dtype and torch.equal(got, want)
    mesh.replicate([x, torch.Generator().get_state()], world)
    assert mesh.broadcast_object({"a": 1}, world) == {"a": 1}


def test_gather_stacked_keeps_its_buffer(group_of_one):
    """``gather_stacked`` gives every rank's tensor stacked in rank order in
    a buffer kept for the next gather of the same shape and dtype (host
    and device alike on gloo's CPU): the same storage, the new values."""
    world = group_of_one
    x = torch.arange(12, dtype=torch.int8).reshape(3, 4)
    first = mesh.gather_stacked(x, world)
    assert first.shape == (1, 3, 4) and torch.equal(first[0], x)
    ptr = first.data_ptr()
    second = mesh.gather_stacked(x + 1, world)
    assert second.data_ptr() == ptr and torch.equal(second[0], x + 1)
    other = mesh.gather_stacked(x.float(), world)
    assert other.data_ptr() != ptr and torch.equal(other[0], x.float())


@pytest.mark.parametrize("size", [1, 2, 4])
def test_stacked_rows_find_each_row_of_the_rollout(size):
    """Row t B + j of a (T, B) rollout is, in its shards stacked as
    (size, T, B / size), at ``learner._stacked_rows``'s index."""
    t, b = 3, 8
    full = torch.arange(t * b).reshape(t, b)
    stacked = torch.stack([mesh.shard_batch(full, mesh.World(
        r, size, CPU, "gloo"), dim=1) for r in range(size)])
    rows = learner._stacked_rows(t, b, size, CPU)
    assert torch.equal(stacked.reshape(-1)[rows], full.reshape(-1))


def test_rows_and_shards_without_a_group():
    """The layout itself: rank r of W holds rows [r B / W, (r+1) B / W)."""
    x = torch.arange(16).reshape(8, 2)
    assert mesh.shard_batch(x, None) is x
    w = mesh.World(2, 4, CPU, "gloo")
    assert w.rows(8) == slice(4, 6)
    assert torch.equal(mesh.shard_batch(x, w), x[4:6])
    assert torch.equal(mesh.shard_batch(x.T, w, dim=1), x.T[:, 4:6])
    assert mesh.gather_batch(x, None) is x
    assert mesh.all_reduce_sum([x], None)[0] is x
    with pytest.raises(ValueError, match="does not split"):
        w.rows(10)
    with pytest.raises(ValueError, match="must divide by the 3 ranks"):
        mesh.check_divisible(16, 8, 2, 3)
    mesh.check_divisible(16, 8, 2, 4)


def _train_step(world, mode):
    cfg = learner.PPOConfig(num_envs=16, t_horizon=8, num_epochs=2,
                            num_minibatches=2, policy_mode=mode,
                            normalize_adv=True)
    ts = learner.init_train_state(0, MODEL_CFG, cfg, device="cpu")
    env = bg_env.reset(torch.Generator().manual_seed(1), ENV_CFG, 16,
                       device="cpu", world=world)
    return learner.train_step(ts, env, ENV_CFG, MODEL_CFG, cfg, world=world)


@pytest.mark.parametrize("mode", ["index", "afterstate"])
def test_world_of_one_is_the_plain_path_bit_for_bit(group_of_one, mode):
    (ts_a, env_a, m_a), (ts_b, env_b, m_b) = (
        _train_step(None, mode), _train_step(group_of_one, mode))
    for a, b in zip(ts_a.model.parameters(), ts_b.model.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(ts_a.opt_state.mu + ts_a.opt_state.nu,
                    ts_b.opt_state.mu + ts_b.opt_state.nu):
        assert torch.equal(a, b)
    assert torch.equal(ts_a.gen.get_state(), ts_b.gen.get_state())
    assert int(ts_a.episodes) == int(ts_b.episodes)
    for name, a, b in zip(env_a._fields, env_a, env_b):
        assert torch.equal(a, b), name
    assert m_a.keys() == m_b.keys()
    for k in m_a:
        assert torch.equal(m_a[k], m_b[k]), k


def test_world_of_one_reset_where_the_capacity_binds(group_of_one):
    """At B=1024 a reset overflows movegen's non-doubles sub-batch; the
    sharded movegen of a world of one places every game as the plain
    one does, the overflowed games' rows included."""
    plain, sharded = (bg_env.reset(torch.Generator().manual_seed(3), ENV_CFG,
                                   1024, device="cpu", world=w)
                      for w in (None, group_of_one))
    assert int(plain.overflow.sum()) > 0
    for name, a, b in zip(plain._fields, plain, sharded):
        assert torch.equal(a, b), name
