"""The backgammon MLP as plain PyTorch: 198 -> hidden (ReLU) -> the
action logits, the state value and the afterstate score.

The parameters are a dict of (out, in) weights and (out,) biases under
``fc1``, ``action``, ``value`` and ``score``.  ``precision`` is
``"float32"`` (the configuration's own) or ``"tf32"``: the control,
whose every product rounds both operands to TF32's 10-bit significand,
to nearest with ties away from zero (``cvt.rna.tf32.f32``), in the
forward and in both products of the backward.  The rounding is done by
hand so that it is the same on the CPU and on the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import rules

HEADS = ("fc1", "action", "value", "score")


def sizes(hidden, actions, inputs=198):
    return {"fc1": (inputs, hidden), "action": (hidden, actions),
            "value": (hidden, 1), "score": (hidden, 1)}


def init(gen, hidden, actions, device):
    """Weights and biases drawn U(-1/sqrt(fan_in), 1/sqrt(fan_in)) from
    ``gen``, head by head, weight before bias."""
    params = {}
    for name, (fan_in, fan_out) in sizes(hidden, actions).items():
        bound = 1.0 / math.sqrt(fan_in)
        w = torch.empty((fan_out, fan_in), device=device)
        b = torch.empty((fan_out,), device=device)
        params[name + ".weight"] = w.uniform_(-bound, bound, generator=gen)
        params[name + ".bias"] = b.uniform_(-bound, bound, generator=gen)
    return params


def load_npz(path, device):
    """The weights of a frozen asset, stored in (in, out) layout."""
    with np.load(path) as data:
        return {f"{h}.{k}": torch.from_numpy(
                    np.ascontiguousarray(data[f"{h}_{s}"].T if s == "w"
                                         else data[f"{h}_{s}"])).to(device)
                for h in HEADS for k, s in (("weight", "w"), ("bias", "b"))}


def tf32(x):
    bits = x.contiguous().view(torch.int32)
    bits = torch.bitwise_and(bits + 0x1000, ~0x1FFF)
    return bits.view(torch.float32)


class _LinearTF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return torch.nn.functional.linear(tf32(x), tf32(w), b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = tf32(g.reshape(-1, g.shape[-1]))
        dx = (g2 @ tf32(w)).reshape(x.shape)
        dw = g2.t() @ tf32(x.reshape(-1, x.shape[-1]))
        return dx, dw, g.reshape(-1, g.shape[-1]).sum(0)


def linear(x, w, b, precision):
    if precision == "tf32":
        return _LinearTF32.apply(x, w, b)
    return torch.nn.functional.linear(x, w, b)


def head(params, x, name, precision="float32"):
    """(..., 198) features -> the head ``name``'s (..., width) output."""
    h = torch.relu(linear(x, params["fc1.weight"], params["fc1.bias"],
                          precision))
    return linear(h, params[name + ".weight"], params[name + ".bias"],
                  precision)


def value(params, x, precision="float32"):
    return head(params, x, "value", precision)[..., 0]


def board_head(params, boards, mover, name, precision="float32",
               opponent=False):
    """(R, M, 52) canonical boards encoded for ``mover`` (R,), seen from
    the other side first where ``opponent``: the head's (R, M) output."""
    view = rules.opponent_view(boards) if opponent else boards
    feats = rules.encode_canonical(view, mover[:, None])
    return head(params, feats, name, precision)[..., 0]
