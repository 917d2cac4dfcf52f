"""Write a frozen benchmark opponent asset (``agents/frozen.py``) from the
newest checkpoint of a learning run of the driver.

Port of ``scripts/save_frozen.py``: the run is an ``afterstate4096`` run
(``scripts/run_learning.py``) named ``name``; its newest
``checkpoints/<name>/ckpt_<n>.npz`` is restored and its network written
with ``frozen.save_frozen`` in the JAX package's layout, so that either
package loads it.  By default the asset replaces the port's copy of
frozen_v1, as the JAX script replaces its own; ``--out`` writes it
elsewhere.

Usage:
    python -m mlp_ppo_2ply_p3_tpu_torch.scripts.save_frozen [name] \\
        [--out PATH] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import os

from ..agents import frozen
from ..env import bg_env
from ..ppo import learner
from ..utils import checkpoint as ckpt
from ..utils.config import get_preset


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("name", nargs="?", default="afterstate4096_r4")
    ap.add_argument("--out", default=frozen.FROZEN_V1_PATH)
    ap.add_argument("--device", default="cuda",
                    help="where the checkpoint is restored: cuda (the "
                         "default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(get_preset("afterstate4096"), name=args.name)
    path = ckpt.latest(os.path.join(cfg.checkpoint_dir, cfg.name))
    if not path:
        raise SystemExit(f"no checkpoint under {cfg.checkpoint_dir}/"
                         f"{cfg.name}")
    ts = learner.init_train_state(0, cfg.model, cfg.ppo, device=args.device)
    env0 = bg_env.reset(ts.gen, cfg.env, cfg.ppo.num_envs,
                        device=args.device)
    ts, _ = ckpt.restore(path, (ts, env0))
    frozen.save_frozen(args.out, ts.model)
    print(f"saved {args.out} from {path} (update {int(ts.update_idx)}, "
          f"hidden {cfg.model.hidden_size})")
    return args.out


if __name__ == "__main__":
    main()
