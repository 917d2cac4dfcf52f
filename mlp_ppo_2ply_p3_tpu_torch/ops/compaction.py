"""Batched stable compaction: the movegen hot op.

Port of both Pallas TPU kernels in ``mlp_ppo_2ply_p3_tpu/ops/compaction.py``:
``compact_rows`` (one-hot int8 matmul, ``pallas_call`` at :231) and
``compact_rows_segmented`` (128-wide segmented one-hots, ``pallas_call``
at :178).  Both compute the same function, so one CUDA C++ kernel
(``csrc/compaction.cu``, one CTA per batch row: warp ballot + popc
prefix, shared-memory scan of warp totals, cooperative row copy,
zero-filled tail) replaces them.

What bounds it on an H100: bytes moved — the valid flags, the payload
rows that land in the output, and the output itself; it does no
arithmetic worth counting.  The one-hot matmul and the 8-aligned merges
of the TPU versions were shapes chosen for the MXU and Mosaic, not part
of the contract.

``compact_rows`` dispatches on the tensors' device: CPU tensors take the
plain PyTorch version (``compact_rows_plain``: a prefix count, a binary
search per output slot, a gather); CUDA tensors launch the kernel or
raise.  ``compact_rows.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch


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


def _launch(payload, valid, k_out: int):
    from .build import load

    lib = load("compaction")
    fn = lib.compact_rows_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    b, n, c = payload.shape
    if max(b, n * c, k_out * c) >= 2**31:
        raise ValueError(f"shape {tuple(payload.shape)} -> {k_out} too large")
    with torch.cuda.device(payload.device):
        out = torch.empty((b, k_out, c), dtype=torch.int8,
                          device=payload.device)
        count = torch.empty((b,), dtype=torch.int32, device=payload.device)
        stream = torch.cuda.current_stream(payload.device).cuda_stream
        err = fn(payload.data_ptr(), valid.data_ptr(), out.data_ptr(),
                 count.data_ptr(), b, n, c, k_out, stream)
    if err != 0:
        raise RuntimeError(f"compact_rows kernel launch failed: CUDA error "
                           f"{err} at shape {tuple(payload.shape)} -> {k_out}")
    _COUNTER.launches += 1
    return out, count


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
    if payload.device.type != "cuda":
        raise ValueError(f"compact_rows: unsupported device {payload.device}")
    return _launch(payload, valid, k_out)


compact_rows.launches = 0
# the function object that owns the count, so that a caller who wraps
# ``compact_rows`` (to capture its inputs) still counts on the original
_COUNTER = compact_rows
