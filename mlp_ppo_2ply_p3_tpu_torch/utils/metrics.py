"""Structured metrics pipeline: JSONL always, TensorBoard if available.

Port of ``mlp_ppo_2ply_p3_tpu/utils/metrics.py``.  The scalars of a
``train_step`` arrive as 0-dim tensors on the card; ``to_host`` fetches
all of them with one device-to-host transfer (one ``float()`` per key
would wait for the card once per key)."""

from __future__ import annotations

import json
import os
import time

import torch


def to_host(scalars: dict) -> dict:
    """``scalars`` with every tensor value replaced by a Python float.
    The tensors are stacked as float64 (exact for float32 and int32) on
    the first one's device and copied to the host at once; other values
    pass through."""
    keys = [k for k, v in scalars.items() if torch.is_tensor(v)]
    out = dict(scalars)
    if keys:
        dev = scalars[keys[0]].device
        stacked = torch.stack([
            scalars[k].detach().reshape(()).to(device=dev,
                                                dtype=torch.float64)
            for k in keys
        ])
        out.update(zip(keys, stacked.tolist()))
    return out


class MetricsWriter:
    def __init__(self, jsonl_path: str | None = None,
                 tb_logdir: str | None = None):
        self._jsonl = None
        if jsonl_path:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
            self._jsonl = open(jsonl_path, "a", buffering=1)
        self._tb = None
        if tb_logdir:
            # torch's writer first, then tensorboardX, then none: the JAX
            # package's order
            try:  # tensorboard backends are optional
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=tb_logdir)
            except Exception:
                try:
                    from tensorboardX import SummaryWriter  # type: ignore

                    self._tb = SummaryWriter(log_dir=tb_logdir)
                except Exception:
                    self._tb = None

    def write(self, step: int, scalars: dict):
        rec = {"step": int(step), "time": time.time()}
        for k, v in to_host(scalars).items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                continue
        if self._jsonl:
            self._jsonl.write(json.dumps(rec) + "\n")
        if self._tb:
            for k, v in rec.items():
                if k in ("step", "time"):
                    continue
                self._tb.add_scalar(k, v, step)

    def close(self):
        if self._jsonl:
            self._jsonl.close()
        if self._tb:
            self._tb.close()
