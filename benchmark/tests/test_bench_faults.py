"""``correct`` comes out false when the timed path is broken underneath:
the harness runs on the CPU at the cells' test sizes (its look for a
chip skipped by ``--device cpu``) with one fault planted in the program
at a time, and the control (the reference computed in TF32 in the
program's place) reads past at least one of the cell's limits.

    python -m pytest benchmark/tests -q
"""

import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import run  # noqa: E402
from benchmark.drivers import ppo as ppo_driver  # noqa: E402
from benchmark.drivers import twoply as twoply_driver  # noqa: E402

PPO_CELLS = ("afterstate4096-ppo", "train4096-ppo")
TWOPLY = "afterstate4096-twoply256"


def _line(capsys, cell, seed=21):
    assert run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                     "0.3", "--device", "cpu", "--tiny"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _state_unchanged(monkeypatch):
    """The optimizer's step returns its state unchanged and leaves the
    parameters as they were."""
    from mlp_ppo_2ply_p3_tpu_torch.ppo import learner

    monkeypatch.setattr(learner, "adam_step",
                        lambda params, grads, state, cfg: state)


def _half_batch(monkeypatch):
    """Each minibatch's loss is the mean over its first half alone."""
    from mlp_ppo_2ply_p3_tpu_torch.ppo import learner

    loss_fn = learner._loss_fn

    def half(model, batch, ent, m, cfg):
        k = batch[0].shape[0] // 2
        return loss_fn(model, tuple(x[:k] for x in batch), ent, m, cfg)

    monkeypatch.setattr(learner, "_loss_fn", half)


def _ppo_action_altered(monkeypatch):
    """Game 0's sampled move is moved on by one where it is drawn."""
    from mlp_ppo_2ply_p3_tpu_torch.ppo import learner

    draw = learner.categorical

    def altered(rand, logits):
        a = draw(rand, logits)
        a[0] = (a[0] + 1) % logits.shape[1]
        return a

    monkeypatch.setattr(learner, "categorical", altered)


@pytest.mark.parametrize("cell", PPO_CELLS)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _ppo_action_altered])
def test_ppo_fault_is_caught(cell, fault, monkeypatch, capsys):
    assert _line(capsys, cell)["correct"] is True
    fault(monkeypatch)
    assert _line(capsys, cell)["correct"] is False


def _twoply_state_unchanged(monkeypatch):
    from mlp_ppo_2ply_p3_tpu_torch.env import bg_env

    step = bg_env.step_with_draws
    monkeypatch.setattr(bg_env, "step_with_draws",
                        lambda s, a, d, c, w=None: (s, step(s, a, d, c)[1]))


def _twoply_half_batch(monkeypatch):
    """The chance node's mean over half of the 21 rolls."""
    from mlp_ppo_2ply_p3_tpu_torch.core import dice

    p = dice.ROLL_PROBS_21.clone()
    p[1::2] = 0
    monkeypatch.setattr(dice, "ROLL_PROBS_21", p / p.sum())


def _twoply_action_altered(monkeypatch):
    from mlp_ppo_2ply_p3_tpu_torch.agents import twoply

    decide = twoply.twoply_actions_values

    def altered(model, state, scfg):
        action, backup, of = decide(model, state, scfg)
        action = action.clone()
        action[0] = (action[0] + 1) % state.n_moves[0].clamp(min=2)
        return action, backup, of

    monkeypatch.setattr(twoply, "twoply_actions_values", altered)


@pytest.mark.parametrize("fault", [_twoply_state_unchanged,
                                   _twoply_half_batch,
                                   _twoply_action_altered])
def test_twoply_fault_is_caught(fault, monkeypatch, capsys):
    fault(monkeypatch)
    assert _line(capsys, TWOPLY, seed=5)["correct"] is False


def _cell(cell):
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    wl = {w["name"]: w for w in bench["workloads"]}[cell]
    here = os.path.join(ROOT, "benchmark")
    spec = run.load_json(here, "workloads", f"{cell}.json")
    cfg = run.merge(run.load_json(here, "configs", f"{wl['config']}.json"),
                    spec["cpu_test"].get("config", {}))
    traffic = run.merge(run.load_json(here, "traffic",
                                      f"{wl['traffic']}.json"),
                        spec["cpu_test"].get("traffic", {}))
    return cfg, traffic, spec["limits"]


@pytest.mark.parametrize("cell", PPO_CELLS)
def test_ppo_control_fails(cell):
    cfg, traffic, limits = _cell(cell)
    dev = torch.device("cpu")
    n = traffic["checked_updates"]
    for seed in (1, 2, 3):
        rec = ppo_driver.control_record(cfg, seed, dev, n, "tf32")
        numbers = ppo_driver.reference_numbers(cfg, seed, dev, rec, n)
        assert any(v > limits[k] for k, v in numbers.items()), numbers


def test_twoply_control_fails():
    cfg, traffic, limits = _cell(TWOPLY)
    dev = torch.device("cpu")
    for seed in (1, 2, 3):
        kept = twoply_driver.control_kept(cfg, traffic, seed, dev,
                                          traffic["checked_plies"] + 1,
                                          "tf32")
        numbers = twoply_driver.reference_numbers(cfg, traffic, seed, dev,
                                                  kept)
        assert any(v > limits[k] for k, v in numbers.items()), numbers
