"""2-ply-assisted learning (expert iteration): distil the 2-ply
expectimax backup into the 1-ply net.

Port of ``scripts/run_distill.py`` (its docstring has the method and
the committed outcome).  Self-play games are driven by the 2-ply agent
(argmax; the dice give the diversity), and each visited state
contributes two supervised targets:

- policy: cross-entropy of the afterstate score head toward the 2-ply
  choice;
- value: MSE of the value head toward the 2-ply backup
  ``sum_r p_r min_reply V`` (``--targets backup``), or toward the
  discounted result of the game (``--targets outcome``).

The 2-ply expert reads the current value net, so improving the net
improves the expert the next iteration.  Starting point: the committed
frozen_v1 net; the league measures the distilled net played greedy
1-ply against frozen_v1.  Collection is a host loop over plies, as in
the JAX script; each ply is one 2-ply decision over all games (both
compaction kernels) and one env step.

Randomness: one generator, seeded 17 as the JAX script's key, draws the
first reset, every ply's env draws, the epoch permutations and the
league games, in the order in which the JAX script splits its key.  The
update is ``optax.adam(lr)`` (no clipping): ``learner.adam_step`` with
``max_grad_norm=0``.

Usage:
    python -m mlp_ppo_2ply_p3_tpu_torch.scripts.run_distill [--iters 8] \\
        [--plies 48] [--envs 256] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
from torch.nn import functional as Fn

from .. import resolve_device
from ..agents import arena, basic, frozen, twoply
from ..core.movegen import MovegenConfig
from ..env import bg_env
from ..ppo import learner
from ..utils.config import SearchConfig

KEYS = ("obs", "after", "n_moves", "turn", "action", "target_v")


def collect(model, env_state, sampler, env_cfg, scfg, plies):
    """``plies`` half-turns of 2-ply self-play; ``sampler.env_draws(B)``
    gives each ply's env draws (``learner.Sampler``).  Returns the
    stacked buffers (host numpy, ply-major) and the advanced env
    state."""
    bufs = {k: [] for k in KEYS}
    b = env_state.turn.shape[0]
    for _ in range(plies):
        action, backup, _ = twoply.twoply_actions_values(model, env_state,
                                                         scfg)
        for k, x in zip(KEYS, (bg_env.observe(env_state), env_state.after,
                               env_state.n_moves, env_state.turn, action,
                               backup)):
            bufs[k].append(x)
        env_state, _ = bg_env.step_with_draws(env_state, action,
                                              sampler.env_draws(b), env_cfg)
    out = {k: torch.cat(v).cpu().numpy() for k, v in bufs.items()}
    return out, env_state


# win reward by match points (1/2/3 -> the env's win/gammon/backgammon
# reward scale the value head was trained on)
_SCORE_REWARD = {1: 1.0, 2: 1.5, 3: 2.0}


def collect_outcomes(model, env_state, sampler, env_cfg, scfg, plies,
                     gamma=0.99):
    """2-ply self-play with outcome-anchored value targets: each state's
    target is the game's result from its mover's perspective, discounted
    by its distance to the end (+-gamma^k r), instead of the net's own
    backup.  States of games unfinished at the window's end are dropped.
    Returns (buffers of the resolved states, env state, resolved count,
    state count)."""
    b = env_state.turn.shape[0]
    bufs = {k: [] for k in KEYS[:-1]}
    pending = [[] for _ in range(b)]  # flat state indices awaiting result
    targets = np.zeros(plies * b, np.float32)
    resolved = np.zeros(plies * b, bool)
    turn_flat = np.zeros(plies * b, np.int8)
    t_flat = np.zeros(plies * b, np.int32)
    for t in range(plies):
        action, _, _ = twoply.twoply_actions_values(model, env_state, scfg)
        turn_np = env_state.turn.cpu().numpy()
        for k, x in zip(KEYS, (bg_env.observe(env_state), env_state.after,
                               env_state.n_moves, env_state.turn, action)):
            bufs[k].append(x)
        idx0 = t * b
        turn_flat[idx0:idx0 + b] = turn_np
        t_flat[idx0:idx0 + b] = t
        for e in range(b):
            pending[e].append(idx0 + e)
        env_state, info = bg_env.step_with_draws(
            env_state, action, sampler.env_draws(b), env_cfg)
        winner = info.winner.cpu().numpy()
        score = info.game_score.cpu().numpy()
        for e in np.nonzero(winner >= 0)[0]:
            r = _SCORE_REWARD.get(int(score[e]), 1.0)
            for i in pending[e]:
                sign = 1.0 if turn_flat[i] == winner[e] else -1.0
                targets[i] = sign * r * gamma ** (t - t_flat[i])
                resolved[i] = True
            pending[e] = []
    # time-major, the idx0 + e layout of the targets
    flat = {k: torch.cat(v).cpu().numpy() for k, v in bufs.items()}
    flat["target_v"] = targets
    flat = {k: v[resolved] for k, v in flat.items()}
    return flat, env_state, int(resolved.sum()), plies * b


def make_update(model, m, lr, value_coef, policy_coef):
    """``update(opt_state, minibatch) -> (opt_state', loss, ce, value
    mse)``: one Adam step (``optax.adam(lr)``) on the policy
    cross-entropy and the value MSE, each averaged over the states with
    a legal move (auto-pass states carry no action signal)."""
    cfg = learner.PPOConfig(learning_rate=lr, max_grad_norm=0.0)
    params = list(model.parameters())

    def update(opt_state, mb):
        obs, after, n_moves, turn, action, target_v = mb
        valid = n_moves > 0
        nvalid = valid.sum().clamp(min=1)
        logits = learner._afterstate_logits(model, after, turn, n_moves)
        logp = Fn.log_softmax(logits, dim=-1)
        ce = -torch.gather(logp, 1, action[:, None].long())[:, 0]
        ce = torch.where(valid, ce, 0.0).sum() / nvalid
        v = model.value(obs)
        vloss = torch.where(valid, (v - target_v) ** 2, 0.0).sum() / nvalid
        loss = policy_coef * ce + value_coef * vloss
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        opt_state = learner.adam_step(params, grads, opt_state, cfg)
        return opt_state, loss.detach(), ce.detach(), vloss.detach()

    return update


def make_league_eval(env_cfg, games, device):
    """``run(model, gen) -> (win rate, finished games)``: the model
    played greedy 1-ply against frozen_v1 greedy 1-ply, ``games`` games
    of at most 400 plies, every draw from ``gen``."""
    f_model, _ = frozen.load_frozen(device=device)

    def pol(model, state, rand):
        return basic.greedy_1ply(model, state)

    def run(model, gen):
        res = arena.play(pol, model, pol, f_model, gen, env_cfg, games, 400,
                         device=device)
        return arena.win_rate(res), int(res.finished)

    return run


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--plies", type=int, default=48)
    ap.add_argument("--envs", type=int, default=256)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--minibatch", type=int, default=1024)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--value-coef", type=float, default=1.0)
    # 0 = value-only distillation (the policy heads left alone)
    ap.add_argument("--policy-coef", type=float, default=1.0)
    ap.add_argument("--eval-games", type=int, default=512)
    # "backup": the net's own 2-ply backup; "outcome": the discounted
    # results of the 2-ply self-play games
    ap.add_argument("--targets", default="backup",
                    choices=("backup", "outcome"))
    ap.add_argument("--out", default="metrics/distill_twoply.jsonl")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    asset = frozen.load_frozen(device=dev)
    if asset is None:
        raise SystemExit("needs the committed frozen_v1 asset")
    model, mcfg = asset
    env_cfg = bg_env.EnvConfig(movegen=MovegenConfig.fast(mcfg.action_size))
    scfg = SearchConfig()
    m = env_cfg.max_moves

    opt_state = learner.init_optimizer(model)
    update = make_update(model, m, args.lr, args.value_coef,
                         args.policy_coef)

    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    env_state = bg_env.reset(gen, env_cfg, args.envs, device=dev)
    sampler = learner.Sampler(gen)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    log = open(args.out, "a", buffering=1)
    league_eval = make_league_eval(env_cfg, args.eval_games, dev)

    wr0, fin0 = league_eval(model, gen)
    print(f"iter 0 (baseline = frozen_v1 vs itself): "
          f"win-rate {wr0:.3f} ({fin0} games)", flush=True)
    records = [{"iter": 0, "win_rate_vs_frozen": wr0, "finished": fin0}]
    log.write(json.dumps(records[0]) + "\n")

    for it in range(1, args.iters + 1):
        t0 = time.time()
        if args.targets == "outcome":
            buf, env_state, n_res, n_tot = collect_outcomes(
                model, env_state, sampler, env_cfg, scfg, args.plies)
            print(f"  resolved {n_res}/{n_tot} states", flush=True)
        else:
            buf, env_state = collect(model, env_state, sampler, env_cfg,
                                     scfg, args.plies)
        t_collect = time.time() - t0
        n = buf["obs"].shape[0]
        t0 = time.time()
        losses = []
        for _ in range(args.epochs):
            perm = torch.randperm(n, generator=gen, device=dev).cpu().numpy()
            for lo in range(0, n - args.minibatch + 1, args.minibatch):
                idx = perm[lo:lo + args.minibatch]
                mb = tuple(torch.from_numpy(buf[k][idx]).to(dev)
                           for k in KEYS)
                opt_state, *mb_losses = update(opt_state, mb)
                losses.append(torch.stack(mb_losses))
        # one device-to-host copy for every minibatch's losses
        losses = (torch.stack(losses).double().cpu().numpy() if losses
                  else np.full((0, 3), np.nan))
        t_train = time.time() - t0
        loss, ce, vl = (float(np.mean(losses[:, i])) for i in range(3))
        wr, fin = league_eval(model, gen)
        rec = {
            "iter": it, "states": n, "loss": round(loss, 4),
            "ce": round(ce, 4), "value_mse": round(vl, 4),
            "win_rate_vs_frozen": wr, "finished": fin,
            "collect_s": round(t_collect, 1),
            "train_s": round(t_train, 1),
        }
        print(json.dumps(rec), flush=True)
        log.write(json.dumps(rec) + "\n")
        records.append(rec)

    log.close()
    return records


if __name__ == "__main__":
    main()
