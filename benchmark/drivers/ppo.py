"""Traffic driver ``ppo``: a closed loop of back-to-back PPO updates
(``ppo/learner.py::train_step``), each a rollout of T half-turns of B
self-play games and the minibatched epochs on it.

Set-up builds the training state from the seed (weights drawn on the
card by the program's own initialiser), resets the games and drives the
first ``checked_updates`` updates through the window's own call and
sampler, keeping what the reference compares: the first minibatch
step's loss and the per-leaf norms of the gradients the optimizer got
there, each update's mean loss, the games' state after each, the
per-leaf norms of the parameters' change, and every sampled action.
The window then runs whole updates on that same state until
``--seconds`` have passed.  With ``--trace 1`` the per-layer readings
follow the window: the movegen call as a replayed CUDA graph, one
rollout and one update each traced on its own (``perf_step``'s split),
and one update traced with host and device activity for the kernels,
the breakdown and the work their inputs need.  Every run on the card
traces, after the window, the update that followed set-up, from the
state set-up left (copied to the host and put back before each trace),
with device activity alone: its device time is
``train_step_device_ms``, which neither the host's speed nor the number
of updates the window ran changes.  The per-layer readings start from
that state too.
"""

from __future__ import annotations

import time

import torch

from ..reference import compare
from ..reference import ppo as ref_ppo
from ..reference import rules
from ..yardstick import profiling, work

FIELDS = rules.BOARD_FIELDS + ("after", "n_moves", "overflow")


def program_configs(cfg):
    from mlp_ppo_2ply_p3_tpu_torch.core.movegen import MovegenConfig
    from mlp_ppo_2ply_p3_tpu_torch.env.bg_env import EnvConfig
    from mlp_ppo_2ply_p3_tpu_torch.models.mlp import ModelConfig
    from mlp_ppo_2ply_p3_tpu_torch.ppo.learner import PPOConfig

    env = EnvConfig(match_length=cfg["match_length"],
                    movegen=MovegenConfig(**cfg["movegen"]))
    return env, ModelConfig(**cfg["model"]), PPOConfig(**cfg["ppo"])


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _spread(walls):
    w = sorted(walls)
    return (f"{w[0]:.4f} / {w[len(w) // 2]:.4f} / {w[-1]:.4f} "
            f"(min / median / max)")


def _to(tree, dev):
    """A copy of the tensors of a tuple, list or named tuple on ``dev``."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(dev, copy=True)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to(x, dev) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(x, dev) for x in tree)
    return tree


def _fields(state):
    return {f: getattr(state, f).clone() for f in FIELDS}


class Program:
    """The program's training state, driven from the seed."""

    def __init__(self, cfg, seed, dev, checked):
        from mlp_ppo_2ply_p3_tpu_torch.env import bg_env
        from mlp_ppo_2ply_p3_tpu_torch.ppo import learner

        self.learner, self.bg_env = learner, bg_env
        self.env_cfg, self.model_cfg, self.ppo = program_configs(cfg)
        self.dev = dev
        self.ts = learner.init_train_state(seed, self.model_cfg, self.ppo,
                                           device=dev)
        self.es = bg_env.reset(self.ts.gen, self.env_cfg, self.ppo.num_envs,
                               device=dev)

        kept = []

        class Recorder(learner.Sampler):
            """The program's sampler, keeping the actions it returns
            while ``kept`` is open."""

            def actions(self, masked):
                a = super().actions(masked)
                if kept is not None and len(kept) < self.limit:
                    kept.append(a)
                return a

        Recorder.limit = checked * self.ppo.t_horizon
        self.sampler = Recorder(self.ts.gen)
        params = list(self.ts.model.parameters())
        start = [p.detach().clone() for p in params]
        self.record = {"losses": [], "boards": [], "actions": kept}
        with _FirstStep(learner) as first:
            for i in range(checked):
                metrics = self.step()
                self.record["losses"].append(metrics["loss"])
                self.record["boards"].append(_fields(self.es))
        self.record["deltas"] = [torch.linalg.vector_norm(p.detach() - s)
                                 for p, s in zip(params, start)]
        _sync(dev)
        self.record["first_loss"] = float(first.loss)
        self.record["first_grads"] = [float(g) for g in first.grads]
        for key in ("losses", "deltas"):
            self.record[key] = [float(x) for x in self.record[key]]

    def snapshot(self):
        """The training state as it stands, copied to the host."""
        ts = self.ts
        return {"params": _to(list(ts.model.parameters()), "cpu"),
                "opt_state": _to(ts.opt_state, "cpu"),
                "gen": ts.gen.get_state(),
                "counts": _to((ts.update_idx, ts.episodes), "cpu"),
                "es": _to(self.es, "cpu")}

    def restore(self, snap):
        """Put back the training state of ``snap``: the parameters in
        place, the rest anew."""
        with torch.no_grad():
            for p, s in zip(self.ts.model.parameters(), snap["params"]):
                p.copy_(s)
        self.ts.gen.set_state(snap["gen"])
        upd, eps = _to(snap["counts"], self.dev)
        self.ts = self.ts._replace(opt_state=_to(snap["opt_state"], self.dev),
                                   update_idx=upd, episodes=eps)
        self.es = _to(snap["es"], self.dev)

    def step(self):
        self.ts, self.es, metrics = self.learner.train_step(
            self.ts, self.es, self.env_cfg, self.model_cfg, self.ppo,
            self.sampler)
        return metrics


class _FirstStep:
    """Keeps the loss of the first minibatch step and the per-leaf norms
    of the gradients the optimizer gets there (``learner.minibatch_step``
    and ``learner.adam_step``, wrapped while the block runs)."""

    def __init__(self, learner):
        self.learner, self.loss, self.grads = learner, None, None

    def __enter__(self):
        mb, adam = self.learner.minibatch_step, self.learner.adam_step
        self.saved = (mb, adam)

        def minibatch_step(*args, **kwargs):
            opt_state, stats = mb(*args, **kwargs)
            if self.loss is None:
                self.loss = stats[0]
            return opt_state, stats

        def adam_step(params, grads, state, cfg):
            if self.grads is None:
                self.grads = [torch.linalg.vector_norm(g) for g in grads]
            return adam(params, grads, state, cfg)

        self.learner.minibatch_step = minibatch_step
        self.learner.adam_step = adam_step
        return self

    def __exit__(self, *exc):
        self.learner.minibatch_step, self.learner.adam_step = self.saved


def reference_numbers(cfg, seed, dev, record, checked):
    """The reference walks the program's actions from the seed and
    compares; returns {number: value}.  The first update's actions are
    judged, and its first minibatch step's loss and gradients compared:
    there the parameters are the seed's on both sides, so the gaps are
    rounding's.  Each later Adam step feeds rounding back through
    Adam's normalisation, which lifts a gradient that is nought to
    rounding to a full step of either sign, so the later updates are held
    to the exact part: the games' state after every checked update."""
    ref = ref_ppo.Trainer(cfg, seed, dev, follow=record["actions"],
                          judged=cfg["ppo"]["t_horizon"])
    start = [v.clone() for v in ref.params.values()]
    loss_gap, differ = 0.0, 0
    for i in range(checked):
        loss, scale = ref.train_step()
        loss_gap = max(loss_gap, abs(record["losses"][i] - loss) / scale)
        differ += compare.games_differ(_fields(ref.state),
                                       record["boards"][i], FIELDS)
    first_loss, first_scale, first_grads = ref.first
    deltas = compare.norms([v - s for v, s in zip(ref.params.values(),
                                                  start)])
    return {"first_loss_gap": abs(record["first_loss"] - first_loss)
            / first_scale,
            "first_grad_gap": compare.leaf_gap(record["first_grads"],
                                               first_grads, first_grads),
            "action_gap": ref.action_gap, "games_differ": differ,
            "loss_gap": loss_gap,
            "param_change_gap": compare.leaf_gap(record["deltas"], deltas,
                                                 first_grads)}


def control_record(cfg, seed, dev, checked, precision="float32", fault=None,
                   nudge=False):
    """The reference in the program's place (the control, a planted
    fault, or a one-ulp nudge of the weights): the record the program's
    set-up keeps."""
    ctl = ref_ppo.Trainer(cfg, seed, dev, precision=precision, fault=fault,
                          nudge=nudge)
    start = [v.clone() for v in ctl.params.values()]
    rec = {"losses": [], "boards": []}
    for _ in range(checked):
        rec["losses"].append(ctl.train_step()[0])
        rec["boards"].append(_fields(ctl.state))
    rec["deltas"] = compare.norms([v - s for v, s in
                                   zip(ctl.params.values(), start)])
    rec["first_loss"], _, rec["first_grads"] = ctl.first
    rec["actions"] = ctl.actions
    return rec


class _Capture:
    """Keeps the inputs of the program's kernel wrappers and observations
    during one traced update, for the work their kernels needed."""

    def __init__(self):
        from mlp_ppo_2ply_p3_tpu_torch.env import bg_env
        from mlp_ppo_2ply_p3_tpu_torch.ops import afterstate as AE
        from mlp_ppo_2ply_p3_tpu_torch.ops import nondoubles as ND

        self.calls = {"afterstate_eval": [], "afterstate_eval_backward": [],
                      "nondoubles": [], "observe": []}
        self.sites = [(AE, "afterstate_eval"),
                      (AE, "afterstate_eval_backward"),
                      (ND, "nondoubles_batch"), (bg_env, "observe")]

    def __enter__(self):
        self.saved = [getattr(mod, name) for mod, name in self.sites]
        keys = ("afterstate_eval", "afterstate_eval_backward", "nondoubles",
                "observe")
        for (mod, name), fn, key in zip(self.sites, self.saved, keys):
            setattr(mod, name, self._wrap(fn, key))
        return self

    def _wrap(self, fn, key):
        calls = self.calls[key]

        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls.append((args, torch.is_grad_enabled(),
                          out if key == "observe" else None))
            return out

        return wrapper

    def __exit__(self, *exc):
        for (mod, name), fn in zip(self.sites, self.saved):
            setattr(mod, name, fn)


def afterstate_work(calls, backward=False):
    """(bytes, operations, kept boards, their features) summed over the
    captured afterstate calls."""
    tot = [0, 0, 0, 0]
    for args, _, _ in calls:
        boards, _, n, w1 = args[:4]
        got = work.afterstate(boards, n, w1.shape[0], w1.element_size(),
                              args[8], backward)
        tot = [a + b for a, b in zip(tot, got)]
    return tot


def nondoubles_bytes(calls):
    total = 0
    for args, _, _ in calls:
        vecs, m = args[0], args[6]
        place = args[8] if len(args) > 8 else None
        total += work.nondoubles(vecs.shape[0], m,
                                 None if place is None else place[:2])
    return total


def layer_readings(prog, walls, dev):
    """The per-layer readings of the ``--trace 1`` run."""
    from mlp_ppo_2ply_p3_tpu_torch.core import board as Bd
    from mlp_ppo_2ply_p3_tpu_torch.core.movegen import legal_afterstates_batch

    learner, es, cfg = prog.learner, prog.es, prog.ppo
    r = {"phase": "train", "step_wall_s": sum(walls) / len(walls)}
    vecs = Bd.to_canonical(es.points, es.bar, es.off, es.turn)
    r["movegen_device_s"] = profiling.timed_scan(
        legal_afterstates_batch, vecs, es.dice, prog.env_cfg.movegen,
        es.turn == 1)
    sampler = learner.Sampler(prog.ts.gen)
    rollout = lambda: learner.rollout(  # noqa: E731
        prog.ts.model, es, sampler, prog.env_cfg, cfg)
    r["rollout_device_s"], rollout_wall = profiling.device_busy(rollout, dev)
    _, traj, last_value, last_turn = rollout()
    r["update_device_s"], update_wall = profiling.device_busy(
        lambda: learner.ppo_update(prog.ts, traj, last_value, last_turn,
                                   prog.env_cfg, cfg, sampler), dev)
    del traj
    # the device's record: an update's two halves traced with device
    # activity alone, whose host time the profiler stretches least
    r["busy_s"] = r["rollout_device_s"] + r["update_device_s"]
    r["traced_s"] = rollout_wall + update_wall
    with _Capture() as cap:
        trace = profiling.Trace(prog.step, dev)
    r["trace"] = trace
    r["kernels"] = {
        "afterstate_eval": trace.kernel_seconds(
            ("afterstate_eval_kernel", "afterstate_finish_kernel",
             "afterstate_fill_kernel")),
        "afterstate_eval_backward": trace.kernel_seconds(
            ("afterstate_backward_kernel", "afterstate_reduce_kernel")),
        "nondoubles": trace.kernel_seconds(("nondoubles_kernel",))}
    fwd = afterstate_work(cap.calls["afterstate_eval"])
    bwd = afterstate_work(cap.calls["afterstate_eval_backward"], True)
    r["least"] = {
        "afterstate_eval": work.least_seconds(fwd[0], fwd[1]),
        "afterstate_eval_backward": work.least_seconds(bwd[0], bwd[1]),
        "nondoubles": work.least_seconds(nondoubles_bytes(
            cap.calls["nondoubles"]))}
    r["model_ops"] = model_ops(cap, prog)
    return r


def model_ops(cap, prog):
    """The MLP's operations in one update: the rollout's forwards on the
    observations (the action and value heads; in the afterstate policy
    the value head) and on the kept candidate boards (the score head),
    the bootstrap, and the epochs' forward and backward passes, each a
    row of the rollout once an epoch and the backward twice the forward.
    No recomputation, no Adam, no rules."""
    h = prog.model_cfg.hidden_size
    afterstate = prog.ppo.policy_mode == "afterstate"
    width = 1 if afterstate else prog.model_cfg.action_size + 1
    obs = [out for _, _, out in cap.calls["observe"]]
    rows = sum(o.shape[0] for o in obs)
    feats = sum(int((o != 0).sum()) for o in obs)
    bootstrap = obs[-1]
    rollout = work.mlp_flops(feats, rows, h, width)
    last = work.mlp_flops(int((bootstrap != 0).sum()), bootstrap.shape[0],
                          h, width)
    update = 3 * prog.ppo.num_epochs * (rollout - last)
    for args, grad, _ in cap.calls["afterstate_eval"]:
        _, _, n_kept, n_feat = work.afterstate(args[0], args[2], h, 4,
                                               args[8])
        ops = work.mlp_flops(n_feat, n_kept, h, 1)
        # an epoch's forward here; its backward is twice it
        update += 2 * ops if grad else 0
        rollout += ops
    return rollout + update


def run(ctx):
    """Set-up, window, readings and the comparison of one run."""
    dev, cfg, traffic = ctx.device, ctx.config, ctx.traffic
    checked = traffic["checked_updates"]
    prog = Program(cfg, ctx.seed, dev, checked)
    # the state the device-time traces start from: the seed's, at the
    # window's start, whatever number of updates the window then runs
    start = prog.snapshot()
    _sync(dev)
    setup_s = time.perf_counter() - ctx.t_start
    ctx.log(f"set-up done: {checked} checked updates")
    walls, losses = [], []
    t0, cpu0 = time.perf_counter(), time.thread_time()
    while True:
        s0 = time.perf_counter()
        metrics = prog.step()
        _sync(dev)
        end = time.perf_counter()
        walls.append(end - s0)
        losses.append(metrics["loss"])
        if end - t0 >= ctx.seconds:
            break
    window_s = end - t0
    ppo = prog.ppo
    env_steps = len(walls) * ppo.num_envs * ppo.t_horizon
    ctx.log(f"window done: {len(walls)} updates, each {_spread(walls)} s; "
            f"{env_steps / window_s:.1f} env steps/s; the host thread busy "
            f"{(time.thread_time() - cpu0) / window_s:.3f} of the window")
    readings = {"setup_s": setup_s, "window_s": window_s,
                "updates": len(walls), "env_steps": env_steps}
    failed = sum(not torch.isfinite(x).item() for x in losses)
    readings["memory_peak_bytes"] = ctx.memory_peak()
    if dev.type == "cuda":
        readings["train_step_device_s"], _ = profiling.device_busy(
            prog.step, dev, lambda: prog.restore(start))
        ctx.log(f"an update's device time "
                f"{readings['train_step_device_s']:.6f} s")
    if ctx.trace:
        prog.restore(start)
        readings.update(layer_readings(prog, walls, dev))
        ctx.log("per-layer readings done")
    record = prog.record
    del prog, metrics, losses
    ctx.free()
    numbers = reference_numbers(cfg, ctx.seed, dev, record, checked)
    ctx.log("reference done")
    return readings, numbers, len(walls), failed
