"""The PPO update's optimizer step: optax's ``clip_by_global_norm ->
scale_by_adam -> scale(-lr)`` over every leaf of the model.

``adam_update`` launches one hand-written CUDA kernel pair
(``csrc/adam.cu``) for CUDA tensors: the global norm's partial sums, then
the clip, the moments and the parameters of every leaf, two launches a
step where ``adam_update_plain`` launches about 170 ATen kernels.  It
replaces no TPU kernel: the JAX package's update is optax's chain, which
XLA fuses (``mlp_ppo_2ply_p3_tpu/ppo/learner.py:102-106``).

``adam_update_plain`` is the plain PyTorch version, written out by hand so
that it matches optax's arithmetic:

- ``optax.clip_by_global_norm``: scale by max/norm when norm >= max
  (``clip_grad_norm_`` adds 1e-6 to the norm, so it is not used); a
  ``max_grad_norm`` of 0 turns clipping off;
- ``optax.scale_by_adam`` (b1 0.9, b2 0.999, eps 1e-8, bias-corrected),
  then ``scale(-lr)``.

The kernels run each element's operations in the plain version's order and
rounding and sum only the global norm in another order: with clipping off
or not engaged both give the same bits; where it is engaged each output is
the plain version's at a norm a few ulps away.

Both update the parameters in place and return the new step count and
moments as new tensors, leaving the old ones as they were.  The leaves stay
separate tensors: the kernels take a table of their pointers and sizes, at
most ``MAX_LEAVES``, cut into blocks by ``block_layout``.  CPU tensors take
the plain version, CUDA tensors launch the kernels or raise.
``adam_update.launches`` counts the calls that launched them (one a step,
of one or two kernels); ``ops.launches()`` reads it and
``ops.zero_launches()`` zeroes it under ``ops.OPTIMIZER``, outside
``ops.KERNELS``.
"""

from __future__ import annotations

import ctypes

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8
BLOCK_ELEMS = 1024   # csrc/adam.cu kBlockElems: 256 threads x 4 elements
MAX_LEAVES = 24      # csrc/adam.cu kMaxLeaves


@torch.no_grad()
def adam_update_plain(params, grads, count, mu, nu, lr: float,
                      max_grad_norm: float):
    """Plain PyTorch version (any device): in place on ``params``; returns
    (count + 1, new first moments, new second moments)."""
    if max_grad_norm > 0:
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = g_norm < max_grad_norm
        grads = [torch.where(keep, g, (g / g_norm) * max_grad_norm)
                 for g in grads]
    count = count + 1
    c = count.to(torch.float32)
    bc1 = 1 - B1 ** c
    bc2 = 1 - B2 ** c
    mu_out, nu_out = [], []
    for p, g, m, v in zip(params, grads, mu, nu):
        m = (1 - B1) * g + B1 * m
        v = (1 - B2) * (g * g) + B2 * v
        upd = (m / bc1) / (torch.sqrt(v / bc2) + EPS)
        p.add_(upd * (-lr))
        mu_out.append(m)
        nu_out.append(v)
    return count, mu_out, nu_out


def block_layout(sizes) -> list:
    """The first block of each leaf of ``sizes`` elements, then the blocks
    in all: leaf i takes ceil(sizes[i] / BLOCK_ELEMS) blocks of each
    launch, and none where it is empty."""
    first = [0]
    for n in sizes:
        first.append(first[-1] + -(-n // BLOCK_ELEMS))
    return first


def _check(params, grads, count, mu, nu):
    k = len(params)
    if not 1 <= k <= MAX_LEAVES:
        raise ValueError(f"need 1 to {MAX_LEAVES} leaves, got {k}")
    if not len(grads) == len(mu) == len(nu) == k:
        raise ValueError(f"params, grads, mu and nu hold {k}, {len(grads)}, "
                         f"{len(mu)} and {len(nu)} leaves")
    if count.dtype != torch.int32 or count.dim() != 0:
        raise TypeError(f"count must be a 0-dim int32 tensor, got "
                        f"{count.dtype} of shape {tuple(count.shape)}")
    leaves = list(zip(params, grads, mu, nu))
    tensors = [t for leaf in leaves for t in leaf]
    bad = {t.dtype for t in tensors} - {torch.float32}
    if bad:
        raise TypeError(f"the optimizer takes float32 leaves only, got "
                        f"{sorted(map(str, bad))}")
    devices = {t.device for t in tensors} | {count.device}
    if len(devices) != 1:
        raise ValueError(f"the leaves and the count are on different "
                         f"devices: {sorted(map(str, devices))}")
    if count.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {count.device}")
    for i, (p, g, m, v) in enumerate(leaves):
        if not p.shape == g.shape == m.shape == v.shape:
            raise ValueError(
                f"leaf {i}: parameter, gradient and moments have shapes "
                f"{[tuple(t.shape) for t in (p, g, m, v)]}")
        if p.numel() >= 2**31:
            raise ValueError(f"leaf {i} of {p.numel()} elements is too large")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the optimizer needs contiguous leaves")


def _on_card(x):
    """Whether a step on ``x``'s device runs the kernels (a CUDA tensor)."""
    return x.device.type == "cuda"


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "adam_launch": ([_P] * 8 + [_I] + [_P] * 3 + [_I] + [_F] * 7 + [_P], _I),
}


def _fn(name):
    from .build import load

    fn = getattr(load("adam"), name)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _SIGNATURES[name]
    return fn


def _launch(dev, *args):
    """``adam_launch`` on ``dev``'s current stream; its CUDA error code."""
    with torch.cuda.device(dev):
        return _fn("adam_launch")(
            *args, torch.cuda.current_stream(dev).cuda_stream)


def _table(ctype, values):
    return (ctype * len(values))(*values)


def adam_update(params, grads, count, mu, nu, lr: float,
                max_grad_norm: float):
    """One optimizer step: in place on ``params``; returns (count + 1, new
    first moments, new second moments).

    Args:
      params: the model's parameters, float32, contiguous (at most
        ``MAX_LEAVES``).
      grads, mu, nu: each leaf's gradient and Adam moments, the same shapes.
      count: () int32 steps taken.
      lr: the learning rate.
      max_grad_norm: the global norm's clip; 0 turns clipping off.
    """
    _check(params, grads, count, mu, nu)
    if not _on_card(count):
        return adam_update_plain(params, grads, count, mu, nu, lr,
                                 max_grad_norm)
    sizes = [p.numel() for p in params]
    first = block_layout(sizes)
    clip = max_grad_norm > 0
    mu_out = [torch.empty_like(m) for m in mu]
    nu_out = [torch.empty_like(v) for v in nu]
    count_out = torch.empty_like(count)
    partial = (torch.empty((first[-1],), dtype=torch.float32,
                           device=count.device) if clip else None)

    def ptrs(tensors):
        return _table(_P, [t.data_ptr() for t in tensors])

    err = _launch(
        count.device, ptrs(params), ptrs(grads), ptrs(mu), ptrs(nu),
        ptrs(mu_out), ptrs(nu_out), _table(_I, sizes), _table(_I, first),
        len(sizes), count.data_ptr(), count_out.data_ptr(),
        None if partial is None else partial.data_ptr(), int(clip),
        B1, 1 - B1, B2, 1 - B2, EPS, -float(lr), float(max_grad_norm))
    if err != 0:
        raise RuntimeError(f"adam kernel launch failed: CUDA error {err} "
                           f"over leaves of {sizes} elements")
    adam_update.launches += 1
    return count_out, mu_out, nu_out


adam_update.launches = 0
