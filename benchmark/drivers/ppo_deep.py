"""Traffic driver ``ppo_deep``: ``ppo``'s closed loop of back-to-back PPO
updates for a configuration with a deep network (a ``trunk``): the same
set-up, window, device-time traces and comparison, with the deep
reference (``reference/deep.py``) and the deep pass's own readings.

With ``--trace 1`` the per-layer readings follow the window, from the
state set-up left: ``ppo``'s (phase ``train``: movegen's graph-timed
call, one rollout and one update each traced on their own, the
``nondoubles`` kernel's share); one update traced with host and device
activity for the kernels (the first layer's deep forms in
``afterstate_eval_kernel`` and ``afterstate_backward_kernel``, under the
keys of their wrappers ``afterstate_hidden`` and
``afterstate_hidden_backward``; the dense layers' ``dense_*`` kernels),
the breakdown and the work their inputs need; and one update traced with
the program's spans recording, for the device time launched inside its
``dense_layers`` and ``dense_layers_backward`` spans.
"""

from __future__ import annotations

import time

import torch

from ..reference import compare
from ..reference import deep as ref_deep
from ..yardstick import deep_work, profiling, work
from . import ppo

FIELDS = ppo.FIELDS
DENSE_SPANS = ("dense_layers", "dense_layers_backward")
# numbers the reference computes that ``correct`` does not compare: the
# checked updates' mean loss moves under rounding alone as far as under
# TF32 (a one-ulp nudge of the weights reads 1.1e-3 to 1.2e-3, the TF32
# control 1.0e-3 to 1.2e-3, the program 2.5e-4 to 2.0e-3), so no limit
# tells them apart; calibrate.py still prints it
NOT_COMPARED = ("loss_gap",)


def program_cfg(cfg):
    """The configuration with its trunk as the program's tuple."""
    model = dict(cfg["model"], trunk=tuple(cfg["model"]["trunk"]))
    return dict(cfg, model=model)


def reference_numbers(cfg, seed, dev, record, checked):
    """``ppo.reference_numbers`` with the deep reference."""
    ref = ref_deep.Trainer(cfg, seed, dev, follow=record["actions"],
                           judged=cfg["ppo"]["t_horizon"])
    start = [v.clone() for v in ref.params.values()]
    loss_gap, differ = 0.0, 0
    for i in range(checked):
        loss, scale = ref.train_step()
        loss_gap = max(loss_gap, abs(record["losses"][i] - loss) / scale)
        differ += compare.games_differ(ppo._fields(ref.state),
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
    """The deep reference in the program's place: the record the program's
    set-up keeps (``ppo.control_record``'s)."""
    ctl = ref_deep.Trainer(cfg, seed, dev, precision=precision, fault=fault,
                           nudge=nudge)
    start = [v.clone() for v in ctl.params.values()]
    rec = {"losses": [], "boards": []}
    for _ in range(checked):
        rec["losses"].append(ctl.train_step()[0])
        rec["boards"].append(ppo._fields(ctl.state))
    rec["deltas"] = compare.norms([v - s for v, s in
                                   zip(ctl.params.values(), start)])
    rec["first_loss"], _, rec["first_grads"] = ctl.first
    rec["actions"] = ctl.actions
    return rec


class _Capture:
    """Keeps the deep pass's calls and the observations of one traced
    update, for the work their kernels needed."""

    def __init__(self):
        from mlp_ppo_2ply_p3_tpu_torch.env import bg_env
        from mlp_ppo_2ply_p3_tpu_torch.ops import afterstate as AE
        from mlp_ppo_2ply_p3_tpu_torch.ops import nondoubles as ND

        self.calls = {"afterstate_deep": [], "observe": [], "nondoubles": []}
        self.sites = [(AE, "afterstate_deep"), (bg_env, "observe"),
                      (ND, "nondoubles_batch")]
        self.keys = ("afterstate_deep", "observe", "nondoubles")

    def __enter__(self):
        self.saved = [getattr(mod, name) for mod, name in self.sites]
        for (mod, name), fn, key in zip(self.sites, self.saved, self.keys):
            setattr(mod, name, self._wrap(fn, key))
        return self

    def _wrap(self, fn, key):
        calls = self.calls[key]

        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls.append((args, kwargs, torch.is_grad_enabled(),
                          out if key == "observe" else None))
            return out

        return wrapper

    def __exit__(self, *exc):
        for (mod, name), fn in zip(self.sites, self.saved):
            setattr(mod, name, fn)


def _pass_args(args, kwargs):
    """(boards, n, epilogue, the head's outputs) of a captured
    ``afterstate_deep`` call."""
    names = ("boards", "mover", "n", "weights", "rewards", "opponent",
             "epilogue", "sign")
    got = dict(zip(names, args), **kwargs)
    rewards = got.get("rewards")
    return (got["boards"], got["n"], got.get("epilogue", "logits"),
            1 if rewards is None else len(rewards))


def layer_readings(prog, walls, dev):
    """The per-layer readings of the ``--trace 1`` run."""
    from mlp_ppo_2ply_p3_tpu_torch.utils import profiling as program

    from mlp_ppo_2ply_p3_tpu_torch.core import board as Bd
    from mlp_ppo_2ply_p3_tpu_torch.core.movegen import legal_afterstates_batch

    learner, es, cfg = prog.learner, prog.es, prog.ppo
    widths = tuple(prog.model_cfg.widths)
    r = {"phase": "train", "deep": True,
         "step_wall_s": sum(walls) / len(walls)}
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
    r["busy_s"] = r["rollout_device_s"] + r["update_device_s"]
    r["traced_s"] = rollout_wall + update_wall
    with _Capture() as cap:
        trace = profiling.Trace(prog.step, dev)
    r["trace"] = trace
    r["kernels"] = {
        "afterstate_hidden": trace.kernel_seconds(
            ("afterstate_eval_kernel",)),
        "afterstate_hidden_backward": trace.kernel_seconds(
            ("afterstate_backward_kernel", "afterstate_reduce_kernel")),
        "dense_layers": trace.kernel_seconds(deep_work.DENSE_KERNELS),
        "nondoubles": trace.kernel_seconds(("nondoubles_kernel",))}
    fwd, bwd, dense = [0, 0], [0, 0], [0, 0]
    for args, kwargs, grad, _ in cap.calls["afterstate_deep"]:
        boards, n, epilogue, heads = _pass_args(args, kwargs)
        got = deep_work.hidden(boards, n, widths[0], epilogue)
        fwd = [a + b for a, b in zip(fwd, got[:2])]
        d = deep_work.dense(got[2], widths, heads)
        dense = [a + b for a, b in zip(dense, d)]
        if grad:
            got = deep_work.hidden(boards, n, widths[0], epilogue, True)
            bwd = [a + b for a, b in zip(bwd, got[:2])]
            d = deep_work.dense(got[2], widths, heads, True)
            dense = [a + b for a, b in zip(dense, d)]
    nondoubles = [(args, grad, out)
                  for args, _, grad, out in cap.calls["nondoubles"]]
    r["least"] = {"afterstate_hidden": work.least_seconds(*fwd),
                  "afterstate_hidden_backward": work.least_seconds(*bwd),
                  "dense_layers": work.least_seconds(*dense),
                  "nondoubles": work.least_seconds(
                      ppo.nondoubles_bytes(nondoubles))}
    r["model_ops"] = deep_work.model_ops(
        [out for _, _, _, out in cap.calls["observe"]],
        [(*_pass_args(a, k)[:3], g)
         for a, k, g, _ in cap.calls["afterstate_deep"]],
        widths, prog.ppo.num_epochs)
    dense_s = deep_work.span_seconds(prog.step, dev, program, DENSE_SPANS)
    if dense_s is not None:
        r["dense_layers_device_s"] = dense_s
    return r


def run(ctx):
    """Set-up, window, readings and the comparison of one run
    (``ppo.run``'s, with the deep reference and readings)."""
    dev, traffic = ctx.device, ctx.traffic
    cfg = program_cfg(ctx.config)
    checked = traffic["checked_updates"]
    prog = ppo.Program(cfg, ctx.seed, dev, checked)
    start = prog.snapshot()
    ppo._sync(dev)
    setup_s = time.perf_counter() - ctx.t_start
    ctx.log(f"set-up done: {checked} checked updates")
    walls, losses = [], []
    t0, cpu0 = time.perf_counter(), time.thread_time()
    while True:
        s0 = time.perf_counter()
        metrics = prog.step()
        ppo._sync(dev)
        end = time.perf_counter()
        walls.append(end - s0)
        losses.append(metrics["loss"])
        if end - t0 >= ctx.seconds:
            break
    window_s = end - t0
    env_steps = len(walls) * prog.ppo.num_envs * prog.ppo.t_horizon
    ctx.log(f"window done: {len(walls)} updates, each {ppo._spread(walls)} "
            f"s; {env_steps / window_s:.1f} env steps/s; the host thread "
            f"busy {(time.thread_time() - cpu0) / window_s:.3f} of the "
            f"window")
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
    ctx.log(f"reference done; not compared: "
            f"{ {k: numbers.pop(k) for k in NOT_COMPARED} }")
    return readings, numbers, len(walls), failed
