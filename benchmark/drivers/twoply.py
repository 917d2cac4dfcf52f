"""Traffic driver ``twoply``: 2-ply self-play collection, as the
distillation's ``collect`` runs it (``scripts/run_distill.py``): each ply
one ``agents/twoply.py::twoply_actions_values`` decision over every game
(argmax) and one ``env/bg_env.py::step_with_draws``; finished games
reset themselves; the dice come from the seed.  A closed loop: the next
ply starts when the last has ended on the card.

The weights are the committed frozen_v1 net, which the program and the
reference each read from the same file.  Set-up resets the games and
plays one ply (every shape a ply has, at the traffic's size); the
window then plays whole plies until ``--seconds`` have passed, timing
each from its start to its synchronised end, and keeps each ply's
actions, backups and the small tensors of the games' state.

Once the window has closed the reference judges a sample of the
window's plies drawn from the seed, the last among them: from the
program's state at each it lists the moves and decides by the rules and
the plain net, so that the backups and the choices are compared; and it
steps the program's state before each judged ply by the program's action
there with the seed's dice, and compares the state it reaches.  It also
resets from the seed and compares the first state.  It follows the
program's state rather than replaying the whole run: the start and each
judged ply's step are what it checks of the plies between.

Every run on the card then plays ``traced_plies`` more plies from the
window's last state under a trace with device activity alone: their
device time over their number is ``ply_device_ms``, which the host's
speed does not change.
"""

from __future__ import annotations

import os
import random
import time

import torch

from ..reference import compare, rules
from ..reference import model as Mdl
from ..reference import twoply as ref_twoply
from ..yardstick import profiling, work
from .ppo import _Capture, _spread, _sync, afterstate_work, nondoubles_bytes

FIELDS = rules.BOARD_FIELDS
WEIGHTS = os.path.join("mlp_ppo_2ply_p3_tpu_torch", "assets",
                       "frozen_benchmark_v1.npz")


def _weights_path():
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, WEIGHTS)


class Program:
    """The program's games and decisions, from the seed."""

    def __init__(self, cfg, traffic, seed, dev):
        from mlp_ppo_2ply_p3_tpu_torch.agents import frozen, twoply
        from mlp_ppo_2ply_p3_tpu_torch.core.movegen import MovegenConfig
        from mlp_ppo_2ply_p3_tpu_torch.env import bg_env
        from mlp_ppo_2ply_p3_tpu_torch.ppo import learner
        from mlp_ppo_2ply_p3_tpu_torch.utils.config import SearchConfig

        self.twoply, self.bg_env = twoply, bg_env
        self.env_cfg = bg_env.EnvConfig(
            match_length=cfg["match_length"],
            movegen=MovegenConfig(**cfg["movegen"]))
        self.scfg = SearchConfig(**cfg["search"])
        self.model, _ = frozen.load_frozen(_weights_path(), device=dev)
        self.games = traffic["games"]
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self.sampler = learner.Sampler(gen)
        self.state = bg_env.reset(gen, self.env_cfg, self.games, device=dev)
        self.kept = []

    def decide(self):
        return self.twoply.twoply_actions_values(self.model, self.state,
                                                 self.scfg)

    def advance(self, plies):
        """``plies`` plies on from the current state, keeping nothing."""
        for _ in range(plies):
            action, _, _ = self.decide()
            self.state, _ = self.bg_env.step_with_draws(
                self.state, action, self.sampler.env_draws(self.games),
                self.env_cfg)

    def ply(self):
        s = self.state
        action, backup, _ = self.decide()
        self.state, _ = self.bg_env.step_with_draws(
            s, action, self.sampler.env_draws(self.games), self.env_cfg)
        self.kept.append(({f: getattr(s, f) for f in FIELDS}, action, backup))


def _state_from(fields, mg):
    """A reference state at the program's board: its own move lists."""
    after, n, of = rules.lists_of(fields["points"], fields["bar"],
                                  fields["off"], fields["turn"],
                                  fields["dice"], mg)
    n = torch.where(fields["game_over"], 0, n)
    return rules.State(**{f: fields[f] for f in FIELDS}, after=after,
                       n_moves=n, overflow=of)


def sample_plies(seed, plies, count):
    """The window's plies (1 to ``plies`` - 1; ply 0 is set-up's) that
    the reference judges: the last, and a draw from the seed among the
    others."""
    rest = list(range(1, plies - 1))
    random.Random(seed).shuffle(rest)
    return sorted({plies - 1, *rest[:max(count - 1, 0)]})


def reference_numbers(cfg, traffic, seed, dev, kept):
    """The reference's judgement of the kept plies: {number: value}."""
    mg = rules.Movegen(**cfg["movegen"])
    params = Mdl.load_npz(_weights_path(), dev)
    s = cfg["search"]
    games, plies = traffic["games"], len(kept)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    start = rules.reset(gen, games, mg)
    differ = compare.games_differ(start._asdict(), kept[0][0], FIELDS)
    draws = [rules.draw_step(gen, games) for _ in range(plies)]
    backup_gap = action_gap = 0.0
    for p in sample_plies(seed, plies, traffic["checked_plies"]):
        fields, action, backup = kept[p]
        st = _state_from(fields, mg)
        b_gap, a_gap = ref_twoply.judge(params, st, action, backup,
                                        s["top_k"], s["reply_max_moves"])
        backup_gap, action_gap = max(backup_gap, b_gap), max(action_gap,
                                                             a_gap)
        # the step into the judged ply, from the program's state before it
        before, prev_action, _ = kept[p - 1]
        nxt, _, _ = rules.step(_state_from(before, mg), prev_action,
                               draws[p - 1], mg)
        differ += compare.games_differ(nxt._asdict(), fields, FIELDS)
    return {"backup_gap": backup_gap, "action_gap": action_gap,
            "games_differ": differ}


def control_kept(cfg, traffic, seed, dev, plies, precision="float32",
                 fault=None):
    """The reference in the program's place (the control, or a planted
    fault): ``plies`` plies kept as the program's loop keeps them."""
    s = cfg["search"]
    player = ref_twoply.Player(
        Mdl.load_npz(_weights_path(), dev), rules.Movegen(**cfg["movegen"]),
        traffic["games"], seed, dev, s["top_k"], s["reply_max_moves"],
        precision, fault)
    kept = []
    for _ in range(plies):
        st, action, backup = player.ply()
        kept.append(({f: getattr(st, f) for f in FIELDS}, action, backup))
    return kept


def layer_readings(prog, walls, dev):
    r = {"phase": "twoply", "ply_wall_s": sum(walls) / len(walls)}
    r["decision_device_s"], _ = profiling.device_busy(prog.decide, dev)
    with _Capture() as cap:
        trace = profiling.Trace(prog.decide, dev)
    r["trace"] = trace
    r["kernels"] = {
        "afterstate_eval": trace.kernel_seconds(
            ("afterstate_eval_kernel", "afterstate_finish_kernel",
             "afterstate_fill_kernel")),
        "nondoubles": trace.kernel_seconds(("nondoubles_kernel",))}
    fwd = afterstate_work(cap.calls["afterstate_eval"])
    r["least"] = {"afterstate_eval": work.least_seconds(fwd[0], fwd[1]),
                  "nondoubles": work.least_seconds(nondoubles_bytes(
                      cap.calls["nondoubles"]))}
    h = prog.model.cfg.hidden_size
    r["model_ops"] = work.mlp_flops(fwd[3], fwd[2], h, 1)
    return r


def run(ctx):
    dev, cfg, traffic = ctx.device, ctx.config, ctx.traffic
    prog = Program(cfg, traffic, ctx.seed, dev)
    prog.ply()
    _sync(dev)
    setup_s = time.perf_counter() - ctx.t_start
    ctx.log("set-up done: one ply")
    walls = []
    t0, cpu0 = time.perf_counter(), time.thread_time()
    while True:
        s0 = time.perf_counter()
        prog.ply()
        _sync(dev)
        end = time.perf_counter()
        walls.append(end - s0)
        if end - t0 >= ctx.seconds:
            break
    window_s = end - t0
    kept = prog.kept
    ctx.log(f"window done: {len(walls)} plies, each {_spread(walls)} s; "
            f"{len(walls) * prog.games / window_s:.1f} decisions/s; "
            f"the host thread busy "
            f"{(time.thread_time() - cpu0) / window_s:.3f} of the window")
    readings = {"setup_s": setup_s, "window_s": window_s,
                "plies": len(walls), "decisions": len(walls) * prog.games,
                "ply_s": walls}
    failed = sum(not bool(torch.isfinite(b).all()) for _, _, b in kept[1:])
    readings["memory_peak_bytes"] = ctx.memory_peak()
    if dev.type == "cuda":
        n = traffic["traced_plies"]
        busy, wall = profiling.device_busy(lambda: prog.advance(n), dev)
        readings.update(ply_device_s=busy / n, busy_s=busy, traced_s=wall)
        ctx.log(f"a ply's device time {busy / n:.7f} s, over {n} plies")
    if ctx.trace:
        readings.update(layer_readings(prog, walls, dev))
        ctx.log("per-layer readings done")
    prog.state = prog.model = None
    del prog
    ctx.free()
    numbers = reference_numbers(cfg, traffic, ctx.seed, dev, kept)
    ctx.log("reference done")
    return readings, numbers, len(walls), failed
