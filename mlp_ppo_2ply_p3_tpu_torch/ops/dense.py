"""The dense layers of a deep afterstate network on the kept boards: the
layers after ``fc1`` of an ``MLP`` with a ``trunk``, its head and the
epilogue's write, forward and backward.

    h_l = relu(W_l h_{l-1} + b_l)        l = 1 .. L, h_0 = fc1's output
    z   = W_head h_L + b_head
    y   = z_0, or softmax(z) . rewards   (the outcome head)
    out[elem[g]] = sign y                g < count

``ops.afterstate.afterstate_hidden`` writes ``h1`` (capacity, ``ld(H)``):
the post-ReLU ``fc1`` of every kept board in its kernels' global order of
kept boards, each board's element r m + s into ``elem`` and their number
into ``count``, a one-int tensor that stays on the card.  A whole row (a
row whose m slots hold one board, ``ops.afterstate.collapsed_plain``) is
one kept board whose element is marked ``~(r m)``: the head writes its
value into each of the row's m slots, and the backward takes the row's m
entries of ``grad`` summed as its cotangent.  The kernels
(``csrc/dense.cu``) read the count there, so nothing syncs with the host,
every shape is the capacity's and a CUDA graph captures a call.  Their
products run on the tensor cores in exact split form: each float32 operand
as three bf16 limbs (``ops.afterstate.split_bf16``), each float32 product
as the six limb products with i + j <= 2, summed in float32 in a fixed
order; the weights are split once a call into scratch (``limb_entries``).

``dense_layers`` is the forward (with ``save`` it also keeps each h_l for
the backward); ``dense_layers_backward`` gives fc1's dpre (what
``afterstate_hidden_backward`` takes) and the gradients of every dense
layer and of the head.  CPU tensors take the plain versions, which read
the count on the host; CUDA tensors launch the kernels or raise.  Each
wrapper's ``launches`` counts its calls on the card, and each runs inside
its span (``dense_layers``, ``dense_layers_backward``).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import span

MAX_WIDTH = 320      # csrc/dense.cu kMaxWidth
MAX_LAYERS = 8       # kMaxLayers: dense layers after fc1
MAX_HEADS = 8        # kMaxHeads
TILE = 128           # kRows: kept rows a tile
# the backward's row blocks and the weight gradient's row slices: numbers
# of the shapes, never of the card, so that the sums run in one order; with
# 132 slices every layer's weight-gradient grid (its units, csrc/dense.cu
# WgradUnits, x the slices) is a whole number of waves on an H100's 132 SMs
ROW_BLOCKS = 132
SLICES = 132


def ld(width: int) -> int:
    """A buffer's row stride for ``width`` floats: a multiple of 4."""
    return -(-width // 4) * 4


def row_blocks(capacity: int) -> int:
    return min(-(-capacity // TILE), ROW_BLOCKS)


def head_entries(width: int, heads: int) -> int:
    """The head's weight and bias entries: heads (width + 1)."""
    return heads * (width + 1)


def layer_entries(widths) -> int:
    """Every dense layer's weight and bias entries, sum w_l (w_{l-1} + 1)."""
    return sum(n * (k + 1) for k, n in zip(widths[:-1], widths[1:]))


def wgrad_partials(widths) -> int:
    """The weight gradient's partial sums that a backward call keeps in
    scratch: every dense layer's weight and bias entries, once a row
    slice (``csrc/dense.cu::dense_reduce_kernel`` sums them in order)."""
    return SLICES * layer_entries(widths)


def limb_entries(widths, backward=False) -> int:
    """The bf16 entries of the weights' limbs that a call splits
    (``csrc/dense.cu::split_weights``): three limbs of each W_l, its rows
    padded to 8 and its columns to 16; W_l^T's for the backward."""
    pad8, pad16 = (lambda x: -(-x // 8) * 8), (lambda x: -(-x // 16) * 16)
    pairs = [(n, k) if not backward else (k, n)
             for k, n in zip(widths[:-1], widths[1:])]
    return sum(3 * pad8(r) * pad16(c) for r, c in pairs)


def _y(z, rewards):
    if rewards is None:
        return z[..., 0]
    r = torch.tensor(rewards, dtype=z.dtype, device=z.device)
    return (torch.softmax(z, dim=-1) * r).sum(-1)


def _check(h1, elem, count, layers, head, rewards):
    if not layers or len(layers) > MAX_LAYERS:
        raise ValueError(f"a deep network needs 1 to {MAX_LAYERS} dense "
                         f"layers after fc1, got {len(layers)}")
    widths = [layers[0][0].shape[1]] + [w.shape[0] for w, _ in layers]
    heads = head[0].shape[0]
    if rewards is not None and len(rewards) != heads:
        raise ValueError(f"{len(rewards)} rewards for {heads} head outputs")
    tensors = [h1, elem, count, *(t for p in layers for t in p), *head]
    if any(t.device != h1.device for t in tensors):
        raise ValueError("the dense layers' tensors are on different "
                         "devices")
    if h1.device.type == "cuda":
        if any(w < 1 or w > MAX_WIDTH for w in widths) or \
                heads > MAX_HEADS or (rewards is not None and heads < 2):
            raise ValueError(f"the dense kernels take widths 1 to "
                             f"{MAX_WIDTH} and 1 to {MAX_HEADS} head "
                             f"outputs, got {widths} and {heads}")
        if any(t.dtype != torch.float32 or not t.is_contiguous()
               for t in [h1, *(t for p in layers for t in p), *head]):
            raise ValueError("the dense kernels take contiguous float32 "
                             "weights and activations")
        if h1.shape[1] != ld(widths[0]):
            raise ValueError(f"h1 must be (capacity, {ld(widths[0])})")
    return widths


def _elements(elem, k):
    """(each kept row's element r m + s, a whole row's r m; whether its
    row is whole) of the first ``k`` entries of ``elem``."""
    e = elem[:k].long()
    whole = e < 0
    return torch.where(whole, ~e, e), whole


def dense_layers_plain(h1, elem, count, out, layers, head, rewards, sign,
                       save=False):
    """Plain PyTorch version (reads the count on the host): writes
    ``out``; returns the kept rows' h_l at capacity as the kernels keep
    them (with ``save``), else None."""
    k = int(count.reshape(-1)[0])
    h = h1[:k, :layers[0][0].shape[1]]
    acts = [] if save else None
    for w, b in layers:
        h = torch.relu(torch.nn.functional.linear(h, w, b))
        if save:
            buf = torch.zeros((h1.shape[0], ld(w.shape[0])), dtype=h.dtype,
                              device=h.device)
            buf[:k, :w.shape[0]] = h
            acts.append(buf)
    y = sign * _y(torch.nn.functional.linear(h, *head), rewards)
    m = out.shape[1]
    e, whole = _elements(elem, k)
    out.view(-1)[e[~whole]] = y[~whole]
    out[e[whole] // max(m, 1)] = y[whole, None]
    return acts


def dense_layers_backward_plain(h1, acts, elem, count, grad, layers, head,
                                rewards, sign):
    """Plain PyTorch version by torch's autograd over the kept rows:
    (fc1's dpre (capacity, ld(H)), [dW_1, db_1, ..., dW_head, db_head])."""
    k = int(count.reshape(-1)[0])
    width = layers[0][0].shape[1]
    with torch.enable_grad():
        x = h1[:k, :width].detach().requires_grad_()
        params = [t.detach().requires_grad_() for p in [*layers, head]
                  for t in p]
        h = x
        for i in range(len(layers)):
            h = torch.relu(torch.nn.functional.linear(
                h, params[2 * i], params[2 * i + 1]))
        y = _y(torch.nn.functional.linear(h, params[-2], params[-1]),
               rewards)
        m = grad.shape[1]
        e, whole = _elements(elem, k)
        g = grad.reshape(-1)[e]
        g[whole] = grad[e[whole] // max(m, 1)].sum(1)
        g = sign * g
        dx, *grads = torch.autograd.grad(y, [x, *params], g)
    dpre = torch.zeros_like(h1)
    dpre[:k, :width] = torch.where(x > 0, dx, 0.0)
    return dpre, grads


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "dense_forward_launch": ([_I] + [_P] * 6 + [_I, _I] + [_P] * 7
                             + [_I, _I, _F, _P], _I),
    "dense_backward_launch": ([_I] + [_P] * 6 + [_I, _I] + [_P] * 8
                              + [_I, _P, _I, _P, _P, _I, _I, _F, _P], _I),
}


def _fn(name):
    from .build import load

    fn = getattr(load("dense"), name)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _SIGNATURES[name]
    return fn


def _array(ctype, values):
    return (ctype * max(len(values), 1))(*values)


def _net(layers, head, rewards, widths):
    """The C arguments of the network: widths, strides, weight and bias
    pointers, the head's, its outputs, the outcome flag, the rewards."""
    ptrs = lambda ts: _array(_P, [t.data_ptr() for t in ts])  # noqa: E731
    rew = None if rewards is None else _array(_F, list(rewards))
    return (len(layers), _array(_I, widths),
            _array(_I, [ld(w) for w in widths]),
            ptrs([w for w, _ in layers]), ptrs([b for _, b in layers]),
            head[0].data_ptr(), head[1].data_ptr(), head[0].shape[0],
            int(rewards is not None), rew)


def _launch(name, dev, *args):
    with torch.cuda.device(dev):
        return _fn(name)(*args, torch.cuda.current_stream(dev).cuda_stream)


def dense_layers(h1, elem, count, out, layers, head, rewards=None, sign=1.0,
                 save=False):
    """The forward over the ``count`` kept rows of ``h1``: writes ``sign
    y`` into (R, M) float32 ``out`` at each row's element ``elem`` (into
    each of a whole row's M slots).
    ``layers`` [(W_l, b_l)] in ``nn.Linear``'s layout, ``head`` (W_head,
    b_head), ``rewards`` the outcome head's weights of its softmax (None: a
    scalar head).  Returns the saved activations [(capacity, ld(w_l))]
    with ``save``, else None."""
    widths = _check(h1, elem, count, layers, head, rewards)
    with span("dense_layers"):
        if h1.device.type != "cuda":
            return dense_layers_plain(h1, elem, count, out, layers, head,
                                      rewards, sign, save)
        cap, dev = h1.shape[0], h1.device
        # every layer's h_l: the kernel reads each back as the next layer's
        # input, and the backward takes them
        acts = [torch.empty((cap, ld(w)), dtype=torch.float32, device=dev)
                for w in widths[1:]]
        act_ptrs = _array(_P, [a.data_ptr() for a in acts])
        limbs = torch.empty((limb_entries(widths),), dtype=torch.bfloat16,
                            device=dev)
        err = _launch("dense_forward_launch", dev,
                      *_net(layers, head, rewards, widths), h1.data_ptr(),
                      act_ptrs, elem.data_ptr(), count.data_ptr(),
                      out.data_ptr(), limbs.data_ptr(), cap, out.shape[1],
                      float(sign))
        if err != 0:
            raise RuntimeError(f"dense_layers kernel launch failed: CUDA "
                               f"error {err} at capacity {cap}, widths "
                               f"{widths}")
        _COUNTERS["dense_layers"].launches += 1
        return acts if save else None


def dense_layers_backward(h1, acts, elem, count, grad, layers, head,
                          rewards=None, sign=1.0):
    """The gradients of ``sum(grad * out)`` for the forward's ``out``:
    (fc1's dpre (capacity, ld(H)), whose rows past the count are
    unspecified on the card, and [dW_1, db_1, ..., dW_L, db_L, dW_head,
    db_head]).  ``acts`` are the forward's saved activations."""
    widths = _check(h1, elem, count, layers, head, rewards)
    with span("dense_layers_backward"):
        if h1.device.type != "cuda":
            return dense_layers_backward_plain(h1, acts, elem, count, grad,
                                               layers, head, rewards, sign)
        cap, dev = h1.shape[0], h1.device
        grad = grad.to(torch.float32).contiguous()
        dpre = [torch.empty((cap, ld(w)), dtype=torch.float32, device=dev)
                for w in widths]
        blocks = row_blocks(cap)
        heads = head[0].shape[0]
        part_rows = torch.empty((max(blocks, 1) * head_entries(
            widths[-1], heads),), dtype=torch.float32, device=dev)
        part_w = torch.empty((wgrad_partials(widths),), dtype=torch.float32,
                             device=dev)
        sizes = [t.numel() for p in [*layers, head] for t in p]
        dflat = torch.empty((sum(sizes),), dtype=torch.float32, device=dev)
        limbs = torch.empty((limb_entries(widths, backward=True),),
                            dtype=torch.bfloat16, device=dev)
        err = _launch("dense_backward_launch", dev,
                      *_net(layers, head, rewards, widths), h1.data_ptr(),
                      _array(_P, [a.data_ptr() for a in acts]),
                      _array(_P, [d.data_ptr() for d in dpre]),
                      elem.data_ptr(), count.data_ptr(), grad.data_ptr(),
                      part_rows.data_ptr(), blocks, part_w.data_ptr(),
                      SLICES, dflat.data_ptr(), limbs.data_ptr(), cap,
                      grad.shape[1], float(sign))
        if err != 0:
            raise RuntimeError(f"dense_layers_backward kernel launch "
                               f"failed: CUDA error {err} at capacity {cap}, "
                               f"widths {widths}")
        _COUNTERS["dense_layers_backward"].launches += 1
        shapes = [t.shape for p in [*layers, head] for t in p]
        grads = [g.view(s) for g, s in zip(dflat.split(sizes), shapes)]
        return dpre[0], grads


dense_layers.launches = 0
dense_layers_backward.launches = 0
_COUNTERS = {"dense_layers": dense_layers,
             "dense_layers_backward": dense_layers_backward}
