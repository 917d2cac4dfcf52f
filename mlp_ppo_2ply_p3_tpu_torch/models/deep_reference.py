"""A plain reference of the deep network, for the tests: wildbg's
evaluation network (github.com/carsten-wenderdel/wildbg, its training
code's ``Network``) on the port's 198 TD-Gammon features, written out
layer by layer in float32 on a dict of weights, with no kernel, no cache
and no batching: every slot of every row goes through it.

    h1 = relu(W1 x + b1), h2 = relu(W2 h1 + b2), h3 = relu(W3 h2 + b3)
    p  = softmax(W_outcome h3 + b_outcome)       (6 outcomes)
    value = p . OUTCOME_REWARDS,  score = w_score h3 + b_score

The weights are ``MLP.named_parameters()`` without the ``layers.``
prefix ("fc1.weight", ...).  The products are ``torch.matmul`` with TF32
off (the caller's setting), each layer's sum in full float32.
"""

from __future__ import annotations

import torch

from ..core import board as Bd
from ..core import features as F
from .mlp import OUTCOME_REWARDS

FLOOR = -1e9


def weights_of(model) -> dict:
    """The model's weights by layer name, detached."""
    return {n.removeprefix("layers."): p.detach()
            for n, p in model.named_parameters()}


def _linear(w, b, x):
    return torch.matmul(x, w.t()) + b


def trunk(params, x):
    """(..., 198) features -> the last hidden layer."""
    h, i = x, 1
    while f"fc{i}.weight" in params:
        h = torch.relu(_linear(params[f"fc{i}.weight"], params[f"fc{i}.bias"],
                               h))
        i += 1
    return h


def outcome_probs(params, x):
    h = trunk(params, x)
    return torch.softmax(_linear(params["outcome.weight"],
                                 params["outcome.bias"], h), dim=-1)


def value(params, x):
    r = torch.tensor(OUTCOME_REWARDS, dtype=x.dtype, device=x.device)
    return (outcome_probs(params, x) * r).sum(-1)


def score(params, x):
    h = trunk(params, x)
    return _linear(params["score.weight"], params["score.bias"], h)[..., 0]


def logits(params, x):
    h = trunk(params, x)
    return _linear(params["action.weight"], params["action.bias"], h)


def afterstate(params, boards, mover, n, head, opponent=False,
               epilogue="logits", sign=1.0):
    """(R, M) of ``head`` ("score" or "value") over (R, M, 52) int8
    ``boards`` encoded for ``mover`` (seen from the other side first where
    ``opponent``), times ``sign`` where slot < n and -1e9 elsewhere; under
    ``logits`` a row with n <= 0 keeps every raw value."""
    view = Bd.opponent_view(boards) if opponent else boards
    x = F.encode_canonical(view, mover[:, None])
    y = sign * (score(params, x) if head == "score" else value(params, x))
    m = boards.shape[1]
    valid = torch.arange(m, device=n.device)[None, :] < n[:, None]
    if epilogue == "logits":
        valid = valid | (n <= 0)[:, None]
    return torch.where(valid, y, torch.full_like(y, FLOOR))
