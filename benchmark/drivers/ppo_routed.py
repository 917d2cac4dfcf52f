"""Traffic driver ``ppo_routed``: ``ppo_deep``'s closed loop of back-to-back
PPO updates for a routed model (wildbg's contact and race networks, a
configuration with ``race``): the same set-up, window and comparison,
with the routed reference (``reference/routed.py``) and the routed pass's
own readings.

``train_step_device_ms`` here is the mean device time of the
``TIMED_UPDATES`` updates that follow set-up, each traced as ``ppo``
traces the one that follows it (from the state before it, put back before
each trace, until two traces agree): one update's content (how many
boards each network gets) varies from seed to seed more than the device
time of a trace does: one update read 1176-1205 ms over six seeds on an
H100 80GB HBM3 (PERF.md §6), a spread past what the benchmark admits.

With ``--trace 1`` the per-layer readings follow the window, each of the
first of those updates, from the state set-up left (put back before each
trace): ``ppo_deep``'s (phase ``train``: movegen's graph-timed call, one
rollout and one update each traced on their own, the ``nondoubles``
kernel's share); the update traced with host and device activity for the
kernels (the route, ``afterstate_route_kernel``; the first layer's routed
forms in ``afterstate_eval_kernel`` and ``afterstate_backward_kernel``;
the dense layers' ``dense_*`` kernels), the breakdown and the work their
inputs need, each kept board counted once on its own network; the
program's tally of kept boards by network over it, where the program
keeps one; and the update traced with the program's spans recording, for
the device time launched inside the dense spans of both groups, and of
each.  They are not averaged over the ``TIMED_UPDATES``: each of the
eight traces would be taken six times, and a run's updates differ by
their content (the reset's games ageing), not by what the layers'
shares of an update are.
"""

from __future__ import annotations

import statistics
import time

import torch

from ..reference import compare
from ..reference import routed as ref_routed
from ..yardstick import deep_work, profiling, routed_work, work
from . import ppo, ppo_deep

FIELDS = ppo.FIELDS
NOT_COMPARED = ppo_deep.NOT_COMPARED
TIMED_UPDATES = 6


def _leaf_gap(program, reference, gradient):
    """``compare.leaf_gap``; where the median leaf's first gradient is
    nought (a network that no row of the first minibatch reached, at the
    cell's CPU test sizes), over the leaves whose first gradient is not
    nought, since ``compare.leaf_gap`` would divide by nought there."""
    if statistics.median(gradient) > 0:
        return compare.leaf_gap(program, reference, gradient)
    live = [i for i, g in enumerate(gradient) if g > 0]
    if not live:
        return 0.0
    pick = lambda xs: [xs[i] for i in live]  # noqa: E731
    return compare.leaf_gap(pick(program), pick(reference), pick(gradient))


def reference_numbers(cfg, seed, dev, record, checked):
    """``ppo_deep.reference_numbers`` with the routed reference."""
    ref = ref_routed.Trainer(cfg, seed, dev, follow=record["actions"],
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
            "first_grad_gap": _leaf_gap(record["first_grads"], first_grads,
                                        first_grads),
            "action_gap": ref.action_gap, "games_differ": differ,
            "loss_gap": loss_gap,
            "param_change_gap": _leaf_gap(record["deltas"], deltas,
                                          first_grads)}


def control_record(cfg, seed, dev, checked, precision="float32", fault=None,
                   nudge=False):
    """The routed reference in the program's place (the TF32 control, a
    planted fault, a one-ulp nudge): the record the program's set-up
    keeps."""
    ctl = ref_routed.Trainer(cfg, seed, dev, precision=precision,
                             fault=fault, nudge=nudge)
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


class _Capture(ppo_deep._Capture):
    """``ppo_deep._Capture`` on the routed pass's calls."""

    def __init__(self):
        super().__init__()
        from mlp_ppo_2ply_p3_tpu_torch.ops import afterstate as AE

        self.sites[0] = (AE, "afterstate_routed")


def _pass_args(args, kwargs):
    """(boards, n, epilogue, the head's outputs) of a captured
    ``afterstate_routed`` call."""
    names = ("boards", "mover", "n", "contact", "race", "rewards",
             "opponent", "epilogue", "sign")
    got = dict(zip(names, args), **kwargs)
    rewards = got.get("rewards")
    return (got["boards"], got["n"], got.get("epilogue", "logits"),
            1 if rewards is None else len(rewards))


def _tally():
    """The program's tally of kept boards by network, or None."""
    from mlp_ppo_2ply_p3_tpu_torch.ops import afterstate as AE

    return getattr(AE, "routed_rows", None)


def layer_readings(prog, walls, dev, log, snap):
    """The per-layer readings of the ``--trace 1`` run, each from the
    state ``snap``."""
    from mlp_ppo_2ply_p3_tpu_torch import ops
    from mlp_ppo_2ply_p3_tpu_torch.core import board as Bd
    from mlp_ppo_2ply_p3_tpu_torch.core.movegen import legal_afterstates_batch
    from mlp_ppo_2ply_p3_tpu_torch.utils import profiling as program

    learner, es, cfg = prog.learner, prog.es, prog.ppo
    widths = tuple(prog.model_cfg.widths)
    prog.restore(snap)
    r = {"phase": "train", "routed": True,
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
    prog.restore(snap)
    ops.zero_launches()
    with _Capture() as cap:
        trace = profiling.Trace(prog.step, dev)
    tally = _tally()
    if tally is not None:
        r["routed_rows"] = tally()
    r["trace"] = trace
    r["kernels"] = {
        "afterstate_route": trace.kernel_seconds(
            ("afterstate_route_kernel",)),
        "afterstate_hidden": trace.kernel_seconds(
            ("afterstate_eval_kernel",)),
        "afterstate_hidden_backward": trace.kernel_seconds(
            ("afterstate_backward_kernel", "afterstate_reduce_kernel")),
        "dense_layers": trace.kernel_seconds(deep_work.DENSE_KERNELS),
        "nondoubles": trace.kernel_seconds(("nondoubles_kernel",))}
    total = {k: [0, 0] for k in ("afterstate_route", "afterstate_hidden",
                                 "afterstate_hidden_backward",
                                 "dense_layers")}
    rows, unmoved = [0, 0], 0
    for args, kwargs, grad, _ in cap.calls["afterstate_deep"]:
        boards, n, epilogue, heads = _pass_args(args, kwargs)
        got, kept = routed_work.pass_work(boards, n, epilogue, widths, heads,
                                          grad)
        for k, v in got.items():
            total[k] = [a + b for a, b in zip(total[k], v)]
        rows = [a + b for a, b in zip(rows, kept)]
        if epilogue == "logits":   # rows with no move keep every slot
            unmoved += int((n <= 0).sum()) * boards.shape[1]
    r["counted_rows"] = dict(zip(("contact", "race"), rows),
                             of_rows_with_no_move=unmoved)
    nondoubles = [(args, grad, out)
                  for args, _, grad, out in cap.calls["nondoubles"]]
    r["least"] = {k: work.least_seconds(*v) for k, v in total.items()}
    r["least"]["nondoubles"] = work.least_seconds(
        ppo.nondoubles_bytes(nondoubles))
    r["model_ops"] = deep_work.model_ops(
        [out for _, _, _, out in cap.calls["observe"]],
        [(*_pass_args(a, k)[:3], g)
         for a, k, g, _ in cap.calls["afterstate_deep"]],
        widths, prog.ppo.num_epochs)
    # the dense spans of both groups, then of each, in the same update
    prog.restore(snap)
    dense = deep_work.span_seconds(prog.step, dev, program,
                                   routed_work.DENSE_SPANS)
    if dense is not None:
        r["dense_layers_device_s"] = dense
        r["group_dense_device_s"] = {}
        for name in routed_work.GROUP_SPANS:
            prog.restore(snap)
            r["group_dense_device_s"][name] = deep_work.span_seconds(
                prog.step, dev, program, (name,))
    log(f"kept boards by network, counted {r['counted_rows']}, the "
        f"program's tally {r.get('routed_rows')}; dense device time by "
        f"group {r.get('group_dense_device_s')}")
    return r


def _updates_device_s(prog, start, dev):
    """The device time of each of the ``TIMED_UPDATES`` updates that follow
    the state ``start``: each traced from the state before it, put back
    before every trace; a traced call leaves the state after it."""
    each, snap = [], start
    for _ in range(TIMED_UPDATES):
        busy, _ = profiling.device_busy(prog.step, dev,
                                        lambda s=snap: prog.restore(s))
        each.append(busy)
        snap = prog.snapshot()
    return each


def run(ctx):
    """Set-up, window, readings and the comparison of one run
    (``ppo_deep.run``'s, with the routed reference and readings)."""
    dev, traffic = ctx.device, ctx.traffic
    cfg = ppo_deep.program_cfg(ctx.config)
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
        each = _updates_device_s(prog, start, dev)
        readings["train_step_device_s"] = sum(each) / len(each)
        ctx.log(f"the device time of the {len(each)} updates after set-up "
                f"{[round(x, 6) for x in each]} s, mean "
                f"{readings['train_step_device_s']:.6f} s")
    if ctx.trace:
        readings.update(layer_readings(prog, walls, dev, ctx.log, start))
        ctx.log("per-layer readings done")
    record = prog.record
    del prog, metrics, losses
    ctx.free()
    numbers = reference_numbers(cfg, ctx.seed, dev, record, checked)
    ctx.log(f"reference done; not compared: "
            f"{ {k: numbers.pop(k) for k in NOT_COMPARED} }")
    return readings, numbers, len(walls), failed
