"""The numbers that decide ``correct``: each is a gap between what the
program produced and what the reference computes from the same seed,
held to its limit (``workloads/<cell>.json``)."""

from __future__ import annotations

import statistics

import torch

# a leaf whose first gradient is under this share of the median leaf's is
# nought to rounding (a head the loss does not reach): it moves under Adam
# by round-off alone, so it is left out of the leaf comparisons
QUIET_LEAF = 1e-3


def leaf_gap(program, reference, gradient):
    """Worst leaf's |program norm - reference norm| over the larger of
    the reference's norm of that leaf and of the median leaf; leaves
    whose reference ``gradient`` norm is quiet are left out."""
    med_g = statistics.median(gradient)
    med = statistics.median(reference)
    gaps = [abs(p - r) / max(r, med) for p, r, g in
            zip(program, reference, gradient) if g >= QUIET_LEAF * med_g]
    return max(gaps) if gaps else 0.0


def games_differ(a, b, fields):
    """Games whose state differs in any of ``fields`` between the dicts
    of (B, ...) tensors ``a`` and ``b``."""
    bsz = a[fields[0]].shape[0]
    diff = torch.zeros((bsz,), dtype=torch.bool, device=a[fields[0]].device)
    for f in fields:
        x, y = a[f].reshape(bsz, -1), b[f].to(a[f].device).reshape(bsz, -1)
        diff |= (x.to(y.dtype) != y).any(dim=1)
    return int(diff.sum())


def norms(tensors):
    return [float(torch.linalg.vector_norm(t.float())) for t in tensors]
