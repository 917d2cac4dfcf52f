"""League runner CLI: pit any two agents over a batch of lockstep games.

Port of ``mlp_ppo_2ply_p3_tpu/agents/league.py``, with the same agent
names and the same JSON line:

    python -m mlp_ppo_2ply_p3_tpu_torch.agents.league --preset twoply \
        --pair twoply:oneply --games 64 --params-from frozen [--device cuda]

Agents:

- ``random``:     uniform over the legal prefix
- ``pubeval``:    fixed linear baseline (agents.pubeval; true weights via
                  the PUBEVAL_WEIGHTS environment variable)
- ``oneply``:     greedy argmax of the value head over afterstates
- ``index``:      reference-style blind-index policy head (argmax)
- ``afterstate``: score-head afterstate policy (argmax)
- ``twoply``:     2-ply expectimax over the same value head as ``oneply``
- ``frozen``:     the committed ``frozen_v1`` net (agents.frozen) played
                  greedy 1-ply

The network agents play ``--params-from frozen`` (the committed asset) or
``ckpt``: the newest checkpoint that the port's training driver
(``ppo/train.py``) wrote under ``checkpoint_dir/<preset>``, or a fresh
net from ``--seed`` when there is none.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from .. import resolve_device
from ..env import bg_env
from ..ppo import learner
from ..utils import checkpoint as ckpt
from ..utils.config import get_preset
from . import arena, basic, frozen, pubeval, twoply


def _agent_fn(name: str, cfg, device="cuda"):
    """Returns (policy(params, state, rand), params) for an agent name;
    params "params" means the network under evaluation."""
    if name == "random":
        return (lambda p, s, r: basic.random_actions(s, r)), None
    if name == "pubeval":
        return pubeval.pubeval_actions, pubeval.default_weights(device)
    if name == "oneply":
        return (lambda p, s, r: basic.greedy_1ply(p, s)), "params"
    if name == "index":
        return (lambda p, s, r: basic.index_policy(p, s, r, sample=False)
                ), "params"
    if name == "afterstate":
        return (lambda p, s, r: basic.afterstate_policy(p, s, r,
                                                        sample=False)
                ), "params"
    if name == "twoply":
        return (lambda p, s, r: twoply.twoply_actions(p, s, cfg.search)
                ), "params"
    if name == "frozen":
        asset = frozen.load_frozen(device=device)
        if asset is None:
            raise SystemExit("no frozen benchmark asset "
                             "(agents/assets/frozen_benchmark_v1.npz)")
        return (lambda p, s, r: basic.greedy_1ply(p, s)), asset[0]
    raise SystemExit(f"unknown agent {name!r}")


def _network(cfg, seed: int, params_from: str, device):
    if params_from == "frozen":
        asset = frozen.load_frozen(device=device)
        if asset is None:
            raise SystemExit("--params-from frozen: no committed asset")
        model, f_cfg = asset
        if f_cfg != cfg.model:
            raise SystemExit(
                f"--params-from frozen: asset model {f_cfg} != preset "
                f"model {cfg.model}; pick a matching --preset")
        print("params from the committed frozen_v1 asset")
        return model
    path = ckpt.latest(os.path.join(cfg.checkpoint_dir, cfg.name))
    ts = learner.init_train_state(seed, cfg.model, cfg.ppo, device=device)
    if path:
        env0 = bg_env.reset(torch.Generator(device=device).manual_seed(1),
                            cfg.env, cfg.ppo.num_envs, device=device)
        ts, _ = ckpt.restore(path, (ts, env0))
        print(f"params from {path} (update {int(ts.update_idx)})")
    else:
        print("no checkpoint found; fresh-initialized params")
    return ts.model


def run_pair(cfg, pair: str, games: int, max_plies: int, seed: int,
             params=None, params_from: str = "ckpt", device="cuda") -> dict:
    dev = resolve_device(device)
    name_a, name_b = pair.split(":")
    if params is None:
        params = _network(cfg, seed, params_from, dev)

    pol_a, par_a = _agent_fn(name_a, cfg, dev)
    pol_b, par_b = _agent_fn(name_b, cfg, dev)
    par_a = params if par_a == "params" else par_a
    par_b = params if par_b == "params" else par_b

    t0 = time.time()
    # search agents stop as soon as every game is finished
    runner = (arena.play_hostloop if "twoply" in (name_a, name_b)
              else arena.play)
    gen = torch.Generator(device=dev).manual_seed(seed)
    res = runner(pol_a, par_a, pol_b, par_b, gen, cfg.env, games, max_plies,
                 device=dev)
    out = {
        "pair": pair,
        "games": games,
        "finished": int(res.finished),
        "wins_a": int(res.wins_a),
        "wins_b": int(res.wins_b),
        "win_rate_a": arena.win_rate(res),
        "points_a": int(res.points_a),
        "points_b": int(res.points_b),
    }
    out["seconds"] = round(time.time() - t0, 2)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="twoply")
    ap.add_argument("--pair", default="twoply:oneply",
                    help="agentA:agentB (random|pubeval|oneply|index|"
                         "afterstate|twoply|frozen)")
    ap.add_argument("--games", type=int, default=64)
    ap.add_argument("--max-plies", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--params-from", default="ckpt",
                    choices=("ckpt", "frozen"),
                    help="weights for the network agents: the latest "
                         "preset checkpoint, or the committed frozen_v1 "
                         "asset")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_preset(args.preset)
    out = run_pair(cfg, args.pair, args.games, args.max_plies, args.seed,
                   params_from=args.params_from, device=args.device)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
