"""The program's spans (``utils/profiling.py``: ``span``, ``recording``)
and their sites at the port's layer boundaries, on the CPU at tiny
sizes: what each site records, how spans nest, and that recording
changes no result."""

import collections
import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mlp_ppo_2ply_p3_tpu_torch.agents import twoply
from mlp_ppo_2ply_p3_tpu_torch.core.movegen import MovegenConfig
from mlp_ppo_2ply_p3_tpu_torch.env import bg_env
from mlp_ppo_2ply_p3_tpu_torch.models.mlp import MLP, ModelConfig
from mlp_ppo_2ply_p3_tpu_torch.ppo import learner
from mlp_ppo_2ply_p3_tpu_torch.utils import profiling
from mlp_ppo_2ply_p3_tpu_torch.utils.config import SearchConfig

torch.set_num_threads(1)

B, T, M = 8, 4, 64
ENV = bg_env.EnvConfig(movegen=MovegenConfig(max_moves=M))
MODEL = ModelConfig(action_size=M, hidden_size=16)
PPO = dict(num_envs=B, t_horizon=T, num_epochs=2, num_minibatches=2)


def names(records):
    return collections.Counter(r[0] for r in records)


def test_span_off_is_the_shared_noop():
    a, b = profiling.span("rollout"), profiling.span("adam_step")
    assert a is b
    with a, b:
        pass
    with profiling.recording() as records:
        pass
    assert records == []
    assert profiling.span("x") is a


def test_spans_nest_with_parent_and_root():
    profiling.report()  # sections of earlier tests in this process
    with profiling.recording() as records:
        with profiling.span("train_step"):
            with profiling.span("rollout"):
                with profiling.span("policy"):
                    pass
            with profiling.span("ppo_update"):
                pass
        with profiling.span("decision"):
            with profiling.section("x", sync=False):
                pass
    assert profiling.span("x") is profiling.span("y")
    got = [(n, parent, root) for n, parent, root, _, _ in records]
    assert got == [("train_step", -1, 0), ("rollout", 0, 0),
                   ("policy", 1, 0), ("ppo_update", 0, 0),
                   ("decision", -1, 4), ("x", 4, 4)]
    assert all(start <= end for _, _, _, start, end in records)
    assert records[0][3] <= records[1][3] <= records[2][4] <= records[1][4] \
        <= records[3][3] <= records[0][4] <= records[4][3]
    report = profiling.report()
    assert report.startswith("x: 1 calls, total ") and report.endswith("ms")
    assert "\n" not in report
    with profiling.recording():
        with pytest.raises(RuntimeError, match="recording already"):
            with profiling.recording():
                pass


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_spans_in_a_profiler_trace(on):
    """Recording on, each span is an event of a ``torch.profiler``
    trace; off, none is."""
    with profiling.recording() if on else contextlib.nullcontext():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with profiling.span("rollout"):
                with profiling.span("policy"):
                    torch.ones(4).sum()
    events = {e.name() for e in prof.profiler.kineto_results.events()}
    assert ({"rollout", "policy"} <= events) == on
    assert bool({"rollout", "policy"} & events) == on


def train_once(mode, record):
    """One tiny ``train_step`` from seed 3: (params, metrics, env state,
    the spans' records or None)."""
    cfg = learner.PPOConfig(**PPO, policy_mode=mode)
    ts = learner.init_train_state(3, MODEL, cfg, device="cpu")
    es = bg_env.reset(ts.gen, ENV, B, device="cpu")
    records = None
    if record:
        with profiling.recording() as records:
            ts, es, metrics = learner.train_step(ts, es, ENV, MODEL, cfg)
    else:
        ts, es, metrics = learner.train_step(ts, es, ENV, MODEL, cfg)
    params = [p.detach().clone() for p in ts.model.parameters()]
    return params, metrics, es, records


@pytest.mark.parametrize("mode", ["index", "afterstate"])
def test_train_step_spans(mode):
    records = train_once(mode, True)[3]
    mb = PPO["num_epochs"] * PPO["num_minibatches"]
    assert names(records) == {"train_step": 1, "rollout": 1, "policy": T,
                              "env_step": T, "movegen": T, "ppo_update": 1,
                              "minibatch_step": mb, "adam_step": mb}
    assert records[0][:3] == ("train_step", -1, 0)
    assert all(root == 0 and end is not None
               for _, _, root, _, end in records)
    parent = {n: records[p][0] for n, p, _, _, _ in records[1:]}
    assert parent == {"rollout": "train_step", "policy": "rollout",
                      "env_step": "rollout", "movegen": "env_step",
                      "ppo_update": "train_step",
                      "minibatch_step": "ppo_update",
                      "adam_step": "minibatch_step"}


@pytest.mark.parametrize("mode", ["index", "afterstate"])
def test_train_step_same_with_recording(mode):
    off = train_once(mode, False)
    on = train_once(mode, True)
    for a, b in zip(off[0], on[0]):
        assert torch.equal(a, b)
    assert off[1].keys() == on[1].keys()
    for k in off[1]:
        assert torch.equal(off[1][k], on[1][k]), k
    for a, b in zip(off[2], on[2]):
        assert torch.equal(a, b)


def decide(scfg, record):
    gen = torch.Generator()
    gen.manual_seed(5)
    model = MLP(MODEL, device="cpu", generator=gen)
    state = bg_env.reset(gen, ENV, 2, device="cpu")
    if not record:
        return twoply.twoply_actions_values(model, state, scfg), None
    with profiling.recording() as records:
        out = twoply.twoply_actions_values(model, state, scfg)
    return out, records


@pytest.mark.parametrize("chunks", [1, 2])
def test_decision_spans(chunks):
    """One decision over 2 games at top_k 2: its 4 candidates in one
    chunk of each leg, or in two; the 15 non-doubles rolls and the 6
    doubles dies each a reply movegen and a reply min pass a chunk."""
    c = 4 // chunks
    scfg = SearchConfig(top_k=2, reply_max_moves=M, game_chunk=c,
                        dbl_game_chunk=c, eval_slot_chunk=32)
    out, records = decide(scfg, True)
    legs = (15 + 6) * chunks
    assert names(records) == {"decision": 1, "one_ply": 1,
                              "reply_movegen": legs, "reply_eval": legs}
    assert all(root == 0 for _, _, root, _, _ in records)
    assert {records[p][0] for _, p, _, _, _ in records[1:]} == {"decision"}
    off, _ = decide(scfg, False)
    for a, b in zip(off, out):
        assert torch.equal(a, b)
