"""The port's checkpoints (``utils/checkpoint.py``) and the JAX train
state carried across (``utils/convert.py::train_state_from_jax``).

- A port checkpoint restores every tensor and the generator exactly, and
  a ``train_step`` from the restored state equals one from the saved
  state bit for bit.
- A structure that changed raises; an orbax directory and an npz of the
  JAX package are refused by ``restore``; ``latest`` picks the highest
  ``ckpt_<n>``.
- A JAX checkpoint saved as npz after a JAX ``train_step`` converts
  exactly (parameters, Adam's count and moments, counters, all 11 env
  fields), the converter's leaf list is JAX's ``tree_flatten_with_path``
  order, and the next update from the converted state matches JAX's
  within ``test_torch_learner.check_update``'s tolerances, with JAX's
  draws replayed."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from mlp_ppo_2ply_p3_tpu.utils import checkpoint as JC
from mlp_ppo_2ply_p3_tpu_torch.env import bg_env as TE
from mlp_ppo_2ply_p3_tpu_torch.ppo import learner as TL
from mlp_ppo_2ply_p3_tpu_torch.utils import checkpoint as ckpt
from mlp_ppo_2ply_p3_tpu_torch.utils import convert
from mlp_ppo_2ply_p3_tpu_torch.utils.config import RunConfig

from . import test_torch_learner as L
from .test_torch_utils import assert_same_tuple, nn_, tt

CFG = TL.PPOConfig(num_envs=4, t_horizon=8, num_epochs=1, num_minibatches=2)


def fresh(seed, ppo=CFG, model=L.TMODEL):
    """A port (TrainState, EnvState) on the CPU."""
    ts = TL.init_train_state(seed, model, ppo, device="cpu")
    env = TE.reset(torch.Generator().manual_seed(seed + 1), L.TENV,
                   ppo.num_envs, device="cpu")
    return ts, env


def tensors(state):
    """Every tensor of a (TrainState, EnvState), the generator's state
    included, by name."""
    ts, env = state
    out = {f"p{i}": p for i, p in enumerate(ts.model.parameters())}
    out.update({f"mu{i}": m for i, m in enumerate(ts.opt_state.mu)})
    out.update({f"nu{i}": v for i, v in enumerate(ts.opt_state.nu)})
    out.update(count=ts.opt_state.count, update_idx=ts.update_idx,
               episodes=ts.episodes, gen=ts.gen.get_state())
    out.update(zip(TE.EnvState._fields, env))
    return out


def assert_equal_states(a, b):
    ta, tb = tensors(a), tensors(b)
    assert list(ta) == list(tb)
    for k in ta:
        assert ta[k].dtype == tb[k].dtype, k
        assert torch.equal(ta[k].detach(), tb[k].detach()), k


def test_roundtrip_exact(tmp_path):
    ts, env = fresh(0)
    ts, env, _ = TL.train_step(ts, env, L.TENV, L.TMODEL, CFG)
    path = ckpt.save(str(tmp_path / "ckpt_1"), (ts, env))
    assert path.endswith("ckpt_1.npz") and os.listdir(tmp_path) == [
        "ckpt_1.npz"]
    like = fresh(9)
    model = like[0].model
    ts2, env2 = ckpt.restore(str(tmp_path / "ckpt_1"), like)
    assert ts2.model is model and ts2.gen is like[0].gen  # in place
    assert_equal_states((ts, env), (ts2, env2))

    # resumed training continues bit for bit
    out_a = TL.train_step(ts, env, L.TENV, L.TMODEL, CFG)
    out_b = TL.train_step(ts2, env2, L.TENV, L.TMODEL, CFG)
    assert_equal_states(out_a[:2], out_b[:2])
    for k, v in out_a[2].items():
        assert torch.equal(v, out_b[2][k]), k


def test_structure_mismatch_fails_loudly(tmp_path):
    """Another model width, batch or dtype raises before anything is
    written into the target."""
    path = ckpt.save(str(tmp_path / "ckpt_1"), fresh(0))
    narrow = L.TMODEL.__class__(hidden_size=16, action_size=L.M)
    like = fresh(3, model=narrow)
    before = [p.clone() for p in like[0].model.parameters()]
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.restore(path, like)
    assert all(torch.equal(a, b) for a, b in
               zip(before, like[0].model.parameters()))
    wide = TL.PPOConfig(num_envs=6, t_horizon=8)
    with pytest.raises(ValueError, match="env/points"):
        ckpt.restore(path, fresh(3, ppo=wide))
    ts, env = fresh(3)
    ts = ts._replace(update_idx=ts.update_idx.long())
    with pytest.raises(ValueError, match="update_idx"):
        ckpt.restore(path, (ts, env))
    # the matching structure still restores
    ckpt.restore(path, fresh(3))


def test_latest_selection(tmp_path):
    d = str(tmp_path)
    assert ckpt.latest(os.path.join(d, "absent")) is None
    assert ckpt.latest(d) is None
    for step in (3, 12, 7):
        ckpt.save(os.path.join(d, f"ckpt_{step}"), fresh(step))
    (tmp_path / "ckpt_notes.txt").write_text("")
    (tmp_path / "other_99.npz").write_bytes(b"")
    assert ckpt.latest(d) == os.path.join(d, "ckpt_12.npz")
    ts, _ = ckpt.restore(ckpt.latest(d), fresh(0))
    want = fresh(12)[0]
    assert all(torch.equal(a, b) for a, b in
               zip(ts.model.parameters(), want.model.parameters()))


def test_orbax_directory_refused(tmp_path):
    """What the JAX package's ``auto`` backend writes where orbax is
    installed: a ``ckpt_<n>`` directory.  ``latest`` picks it when it is
    the newest, and both readers refuse it loudly."""
    ckpt.save(str(tmp_path / "ckpt_2"), fresh(0))
    orbax = tmp_path / "ckpt_5"
    (orbax / "d").mkdir(parents=True)
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    path = ckpt.latest(str(tmp_path))
    assert path == str(orbax)
    with pytest.raises(ValueError, match="orbax"):
        ckpt.restore(path, fresh(0))
    with pytest.raises(ValueError, match="orbax"):
        convert.train_state_from_jax(path, RunConfig(), device="cpu")


def test_generator_from_another_device_is_reseeded(tmp_path, capsys):
    """A checkpoint whose generator was a CUDA one (16 bytes: seed and
    Philox offset) restores every tensor exactly on the CPU, and reseeds
    the CPU generator deterministically from that state."""
    state = fresh(0)
    path = ckpt.save(str(tmp_path / "ckpt_1"), state)
    with np.load(path) as data:
        arrays = dict(data)
    fp = json.loads(bytes(arrays["__fingerprint__"]).decode())
    fp["generator"] = "cuda"
    arrays["__fingerprint__"] = np.frombuffer(json.dumps(fp).encode(),
                                              dtype=np.uint8)
    arrays["gen/state"] = np.arange(16, dtype=np.uint8)
    np.savez(path, **arrays)
    got = [ckpt.restore(path, fresh(5)) for _ in range(2)]
    assert "reseeded" in capsys.readouterr().out
    for g in got:
        want = tensors(state)
        have = tensors(g)
        del want["gen"], have["gen"]
        for k in want:
            assert torch.equal(want[k].detach(), have[k].detach()), k
    assert torch.equal(got[0][0].gen.get_state(), got[1][0].gen.get_state())
    assert not torch.equal(got[0][0].gen.get_state(),
                           fresh(5)[0].gen.get_state())


# --- a JAX checkpoint carried across -----------------------------------------


def leaf_name(path) -> str:
    """A ``tree_flatten_with_path`` path of ``(ts, env_state)`` as the
    converter names it: the env's fields under ``env/``, sequence
    indices (the tuple, optax's chain) dropped."""
    parts = ["env"] if path[0].idx == 1 else []
    for k in path[1:]:
        if isinstance(k, jax.tree_util.DictKey):
            parts.append(str(k.key))
        elif isinstance(k, jax.tree_util.GetAttrKey):
            parts.append(k.name)
    return "/".join(parts)


def test_jax_checkpoint_converts_and_continues(tmp_path):
    run1 = L.jax_run("index")                 # one JAX update from scratch
    state = (run1.ts1, run1.env1)
    JC.save(str(tmp_path / "ckpt_1"), state, backend="npz")
    run2 = L.jax_run("index", *state)         # JAX's next update
    cfg = RunConfig(env=L.TENV, model=L.TMODEL,
                    ppo=TL.PPOConfig(**L.MODES["index"]))

    # the converter's leaves are JAX's, in JAX's order
    paths, _ = jax.tree_util.tree_flatten_with_path(state)
    leaves = convert.jax_train_state_leaves(cfg)
    assert [leaf_name(p) for p, _ in paths] == [n for n, _, _ in leaves]
    assert [(tuple(np.shape(x)), str(np.asarray(x).dtype))
            for _, x in paths] == [(s, d) for _, s, d in leaves]
    assert len(leaves) == 39

    ts, env = convert.train_state_from_jax(str(tmp_path / "ckpt_1"), cfg,
                                           device="cpu")
    assert_same_tuple(env, run1.env1, TE.EnvState._fields)
    got = convert.params_to_numpy(ts.model)
    for layer, p in got.items():
        for k in ("w", "b"):
            np.testing.assert_array_equal(
                p[k], np.asarray(run1.ts1.params[layer][k]))
    adam = L._adam_state(run1.ts1.opt_state)
    assert ts.opt_state.count.dtype == torch.int32
    assert int(ts.opt_state.count) == int(adam.count) > 0
    by_name = dict(zip([n for n, _ in ts.model.named_parameters()],
                       zip(ts.opt_state.mu, ts.opt_state.nu)))
    for layer in ("fc1", "action", "value", "score"):
        for i, jm in enumerate((adam.mu, adam.nu)):
            np.testing.assert_array_equal(
                nn_(by_name[f"layers.{layer}.weight"][i]).T,
                np.asarray(jm[layer]["w"]))
            np.testing.assert_array_equal(
                nn_(by_name[f"layers.{layer}.bias"][i]),
                np.asarray(jm[layer]["b"]))
    assert int(ts.update_idx) == 1
    assert int(ts.episodes) == int(run1.ts1.episodes) > 0
    key = np.asarray(run1.ts1.key).astype(np.uint64)
    assert ts.gen.initial_seed() == int((key[0] << np.uint64(32)) | key[1])

    # the converted state has the port's structure: its checkpoint
    # restores into a fresh train state of this config
    ckpt.restore(ckpt.save(str(tmp_path / "port_1"), (ts, env)), (
        TL.init_train_state(0, cfg.model, cfg.ppo, device="cpu"),
        TE.reset(torch.Generator(), cfg.env, L.B, device="cpu")))

    # the next update, with JAX's draws replayed
    sampler = L.ReplaySampler([tt(a) for a in np.asarray(run2.traj.action)],
                              run2.draws, run2.perms)
    ts2, env2, metrics = TL.train_step(ts, env, L.TENV, L.TMODEL, cfg.ppo,
                                       sampler)
    assert_same_tuple(env2, run2.env1, TE.EnvState._fields)
    L.check_update(ts2, metrics, run2)

    # the port's reader points a JAX npz to the converter
    like = (ts, env)
    with pytest.raises(ValueError, match="train_state_from_jax"):
        ckpt.restore(str(tmp_path / "ckpt_1"), like)
    # a JAX checkpoint of another config is refused, naming the leaf
    other = RunConfig(env=L.TENV, model=L.TMODEL,
                      ppo=TL.PPOConfig(num_envs=L.B + 1))
    with pytest.raises(ValueError, match="env/points"):
        convert.train_state_from_jax(str(tmp_path / "ckpt_1"), other,
                                     device="cpu")
