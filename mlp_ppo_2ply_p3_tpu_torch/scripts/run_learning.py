"""A learning-at-scale run of the port: the ``afterstate4096`` preset on
one card for hundreds of updates with the league eval every 20 updates
against the fixed opponents (the pubeval heuristic, and frozen_v1).

Port of ``scripts/run_learning.py``.  Metrics stream to
``metrics/learning_<name>.jsonl`` and checkpoints to
``checkpoints/<name>``; a second call with the same name resumes.

Usage:
    python -m mlp_ppo_2ply_p3_tpu_torch.scripts.run_learning [updates] \\
        [--preset afterstate4096|wildbg4096] [--hidden H] [--tag TAG] \\
        [--device cuda] \\
        [--num-processes N --coordinator HOST:PORT --process-id R] \\
        [--backend nccl|gloo]

``--hidden 256`` runs the capacity experiment (one-layer presets only);
``--preset wildbg4096`` trains wildbg's deep network instead; ``--tag``
tells repeat runs of one configuration apart.  The process-group flags are the
driver's (``ppo/train.py``): with them, or under ``torchrun``, the games
are sharded over the ranks.
"""

import argparse
import dataclasses

from ..parallel import mesh
from ..ppo.train import train
from ..utils.config import get_preset


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("updates", nargs="?", type=int, default=500)
    ap.add_argument("--preset", default="afterstate4096")
    ap.add_argument("--hidden", type=int, default=None,
                    help="fc1's width (default: the preset's)")
    ap.add_argument("--tag", default="torch")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--backend", choices=mesh.BACKENDS, default=None)
    args = ap.parse_args(argv)
    world = mesh.initialize_distributed(
        coordinator=args.coordinator, num_processes=args.num_processes,
        process_id=args.process_id, backend=args.backend,
        device=args.device)
    try:
        run(args, world)
    finally:
        if world is not None:
            mesh.shutdown()


def run(args, world):

    cfg = get_preset(args.preset)
    name = cfg.name
    if args.hidden is not None and cfg.model.trunk:
        raise ValueError(f"--hidden resizes a one-layer network; "
                         f"{args.preset} has the trunk {cfg.model.trunk}")
    if args.hidden is not None and args.hidden != cfg.model.hidden_size:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model,
                                           hidden_size=args.hidden)
        )
        name = f"{name}_h{args.hidden}"
    if args.tag:
        name = f"{name}_{args.tag}"
    cfg = dataclasses.replace(
        cfg,
        name=name,
        metrics_path=f"metrics/learning_{name}.jsonl",
        checkpoint_dir="checkpoints",
        checkpoint_every=50,
        eval_every=20,
        eval_games=1024,  # +/-1.5% at 1 sigma
        log_every=5,
        num_updates=args.updates,
    )
    ts, _, metrics, total = train(cfg, resume=True, updates=args.updates,
                                  device=args.device, world=world)
    if world is not None and world.rank != 0:
        return
    steps = cfg.ppo.num_envs * cfg.ppo.t_horizon * args.updates
    print(
        f"learning run {name} done: {int(ts.update_idx)} updates, "
        f"{steps / 1e6:.1f}M env-steps, {total:.0f}s wall "
        f"({steps / max(total, 1e-9) / 1e3:.0f}k steps/s incl. eval)"
    )


if __name__ == "__main__":
    main()
