"""What the work needs: the bytes and operations of a kernel's call on
its actual inputs, a kernel's least time on one H100, and the MLP's
operations for the model utilisation.

Frozen from the PyTorch port's ``chip_smoke.py`` (``afterstate_work``,
``nondoubles_work``) and held to one yardstick:

- Operations are those these inputs need.  The first layer costs 2 H a
  non-zero feature of each kept board or observation row (a point of c
  checkers sets min(c, 3) + [c > 3] features, a bar or off count one, the
  mover's one-hot one); the heads are dense.  The afterstate pass's
  backward costs twice its feature products.
- Bytes count each input read once and each output written once.
- A kernel's least time is the larger of its operations over the peak
  and its bytes over the bandwidth (``peaks.py``).

``nondoubles`` is held to its bytes alone: its integer work is some
hundred operations a byte, far under what the bytes take at the peak.
In place the rows that games past the doubles capacity copy are not
counted as read, so its bound stays a lower bound.
"""

from __future__ import annotations

import torch

from . import peaks


def least_seconds(nbytes, ops=0):
    return max(ops / peaks.PEAK_OPS_PER_S, nbytes / peaks.BYTES_PER_S)


def _nnz(boards):
    """Non-zero features of each (..., 52) canonical board."""
    b = boards.to(torch.int32)
    pts = b[..., :48]
    return ((pts.clamp(0, 3) + (pts > 3)).sum(-1)
            + (b[..., 48:] != 0).sum(-1) + 1)


def _kept(n, m, epilogue):
    valid = torch.arange(m, device=n.device)[None, :] < n[:, None]
    if epilogue == "logits":
        valid = valid | (n <= 0)[:, None]
    return valid


def afterstate(boards, n, h, weight_bytes, epilogue, backward=False):
    """(bytes, operations, kept boards, their non-zero features) of one
    afterstate pass (``ops/afterstate.py``) over (R, M, 52) ``boards``
    with valid prefixes ``n``, hidden width ``h``."""
    r, m, _ = boards.shape
    kept = _kept(n, m, epilogue)
    n_kept = int(kept.sum())
    n_feat = int((_nnz(boards) * kept).sum())
    params = h * 198 + 2 * h + 1
    out = r if epilogue == "min" else r * m
    if backward:
        nbytes = n_kept * (52 + 4) + 8 * r + weight_bytes * params + 4 * params
        ops = 4 * n_feat * h + n_kept * 5 * h
    else:
        nbytes = n_kept * 52 + 8 * r + weight_bytes * params + 4 * out
        ops = 2 * n_feat * h + n_kept * (3 * h + 1)
    return nbytes, ops, n_kept, n_feat


def nondoubles(g, m, place=None):
    """Bytes of one ``nondoubles`` call over ``g`` games into an M-wide
    list: each game's board, dice and mirror flag in, its list, count and
    flag out; in place (``place`` = (src, fits)) each game's placement in,
    a doubles game's count and flag alone (its list is another kernel's)
    unless it is past the doubles capacity."""
    if place is None:
        return g * (52 + 4 + 4 + 1) + g * m * 52 + 5 * g
    src, fits = place
    dbl = src < 0
    n_dbl = int(dbl.sum())
    n_past = int((dbl & ~fits.bool()).sum())
    return (5 * g + (g - n_dbl) * (52 + 4 + 4 + 1) + n_dbl * (1 + 9)
            + (g - n_dbl + n_past) * m * 52 + 5 * g)


def mlp_flops(n_feat, rows, h, head_width):
    """Operations of ``rows`` rows through the first layer (``n_feat``
    non-zero features among them) and dense heads ``head_width`` wide."""
    return 2 * h * n_feat + 2 * h * head_width * rows


def roofline_share(r, phase, kernel):
    """A metric reader's share: 100 x the kernel's least time over its
    summed device time in the traced ``phase``; nothing where that phase
    was not traced or the kernel did not run."""
    if r.get("phase") != phase or not r["kernels"].get(kernel):
        return None
    return 100 * r["least"][kernel] / r["kernels"][kernel]
