"""Batched stable compaction, the movegen hot op, and the plain
first-occurrence dedup + compaction.

``compact_rows`` ports both Pallas TPU kernels in
``mlp_ppo_2ply_p3_tpu/ops/compaction.py``: ``compact_rows`` (one-hot int8
matmul, ``pallas_call`` at :231) and ``compact_rows_segmented`` (128-wide
segmented one-hots, ``pallas_call`` at :178).  Both compute the same
function, so one CUDA C++ kernel (``csrc/compaction.cu``) replaces them.
It is bound by bytes on an H100; the note at the top of
``csrc/compaction.cu`` says what each part of the design does about it.

``dedup_compact_rows_plain`` is the non-doubles dedup of movegen and the
compaction after it, which the JAX package writes in jnp
(``mlp_ppo_2ply_p3_tpu/core/movegen.py:256-273`` and ``:364``) and XLA
fuses: the plain version of ``ops/nondoubles.py``, whose kernel dedups on
chip.

The wrapper dispatches on the tensors' device: CPU tensors take the
plain PyTorch version, CUDA tensors launch the kernel or raise.  Its
``launches`` attribute counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.board import pack_key


def compact_rows_plain(payload, valid, k_out: int):
    """Plain PyTorch stable compaction (any device).

    Output slot j takes the first row whose running valid-count reaches
    j+1 — a valid row by construction — found by binary search over the
    (sorted) running count; slots at or past the count are zero."""
    b, n, c = payload.shape
    pos = torch.cumsum(valid.to(torch.int32), dim=1, dtype=torch.int32)
    count = pos[:, -1].clone() if n else torch.zeros(
        b, dtype=torch.int32, device=payload.device)
    if n == 0 or k_out == 0:
        return payload.new_zeros((b, k_out, c)), count
    targets = torch.arange(1, k_out + 1, dtype=torch.int32,
                           device=payload.device).expand(b, k_out)
    src = torch.searchsorted(pos, targets.contiguous()).clamp_(max=n - 1)
    out = torch.gather(payload, 1, src[:, :, None].expand(b, k_out, c))
    live = targets <= count[:, None]
    return out * live[:, :, None].to(out.dtype), count


def first_occurrence_plain(boards, valid):
    """First-occurrence dedup flags in ORIGINAL (generation) order for
    (G, K, 52) boards: keep[g, i] iff row i is valid and no earlier valid
    row has the same packed key (``core.board.pack_key``).  The (G, K, K)
    equality is accumulated one key word at a time, so only one (G, K, K)
    bool block is live (fusing all 7 words would materialise 7 of them)."""
    keys = pack_key(boards)  # (G, K, 7)
    eq = keys[:, :, None, 0] == keys[:, None, :, 0]
    for w in range(1, keys.shape[-1]):
        eq &= keys[:, :, None, w] == keys[:, None, :, w]
    k = boards.shape[1]
    earlier = torch.ones((k, k), dtype=torch.bool,
                         device=boards.device).tril_(-1)
    eq &= earlier
    eq &= valid[:, None, :].to(torch.bool)
    dup = eq.any(dim=2)
    return valid.to(torch.bool) & torch.logical_not(dup)


def dedup_compact_rows_plain(boards, valid, k_out: int):
    """Plain PyTorch dedup + compaction (any device)."""
    return compact_rows_plain(boards, first_occurrence_plain(boards, valid),
                              k_out)


def _check(payload, valid, k_out):
    if payload.dtype != torch.int8:
        raise TypeError(f"payload must be int8, got {payload.dtype}")
    if valid.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"valid must be bool or uint8, got {valid.dtype}")
    if payload.dim() != 3 or valid.shape != payload.shape[:2]:
        raise ValueError(
            f"need payload (B, N, C) and valid (B, N); got "
            f"{tuple(payload.shape)} and {tuple(valid.shape)}"
        )
    if payload.device != valid.device:
        raise ValueError("payload and valid are on different devices")
    if not (payload.is_contiguous() and valid.is_contiguous()):
        raise ValueError("payload and valid must be contiguous")
    if k_out < 0:
        raise ValueError(f"k_out must be >= 0, got {k_out}")
    b, n, c = payload.shape
    if max(b, n * c, k_out * c) >= 2**31:
        raise ValueError(f"shape {tuple(payload.shape)} -> {k_out} too large")
    if payload.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {payload.device}")


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "compact_rows_scratch_ints": ([_I, _I], _I),
    "compact_rows_launch": ([_P] * 5 + [_I] * 4 + [_P], _I),
}


def _fn(name):
    from .build import load

    fn = getattr(load("compaction"), name)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _SIGNATURES[name]
    return fn


def compact_rows(payload, valid, k_out: int):
    """Batched stable compaction: move valid rows to the front.

    Args:
      payload: (B, N, C) int8 rows, contiguous.
      valid:   (B, N) bool (or uint8 0/1), contiguous.
      k_out:   output width.

    Returns: (out (B, k_out, C) int8, count (B,) int32 valid counts;
    a count may exceed k_out, the caller derives overflow from it).
    """
    _check(payload, valid, k_out)
    if payload.device.type == "cpu":
        return compact_rows_plain(payload, valid, k_out)
    b, n, c = payload.shape
    ints = _fn("compact_rows_scratch_ints")(b, n)
    with torch.cuda.device(payload.device):
        scratch = torch.empty((ints,), dtype=torch.int32,
                              device=payload.device)
        out = torch.empty((b, k_out, c), dtype=torch.int8,
                          device=payload.device)
        count = torch.empty((b,), dtype=torch.int32, device=payload.device)
        err = _fn("compact_rows_launch")(
            payload.data_ptr(), valid.data_ptr(), out.data_ptr(),
            count.data_ptr(), scratch.data_ptr(), b, n, c, k_out,
            torch.cuda.current_stream(payload.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"compact_rows kernel launch failed: CUDA error "
                           f"{err} at shape {tuple(payload.shape)} -> "
                           f"{k_out}")
    _COUNTERS["compact_rows"].launches += 1
    return out, count


compact_rows.launches = 0
# the function object that owns the count, so that a caller who wraps the
# wrapper (to capture its inputs) still counts on the original
_COUNTERS = {"compact_rows": compact_rows}
