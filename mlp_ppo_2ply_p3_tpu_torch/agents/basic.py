"""Basic action-selection policies over the batched env state.

Port of ``mlp_ppo_2ply_p3_tpu/agents/basic.py``.  A policy is
``(model or weights, state, rand) -> (B,) int32 actions``, where
``rand(shape)`` returns float32 uniforms in [0, 1) on the state's device
(``uniforms(gen)``, from ``ppo.learner``, draws them from an explicit
``torch.Generator``; a test can hand in the JAX package's own).  Policies that draw nothing
ignore ``rand``.

- ``random_actions``: uniform over the legal-move prefix.
- ``greedy_1ply``: argmax of the value head over candidate afterstates.
- ``index_policy``: the reference-style blind-index policy (obs -> masked
  logits), sampled or argmax.
- ``afterstate_policy``: softmax over score-head evaluations of the
  legal afterstates.

Sampling is Gumbel-max on the uniforms (the learner's ``Sampler``): the
same distribution as ``jax.random.categorical``, not the same stream.
"""

from __future__ import annotations

import torch

from ..env import bg_env
from ..models.mlp import MLP
from ..ops import afterstate as AE
from ..ppo.learner import Rand, categorical, uniforms  # noqa: F401

NEG_INF = -1e9


def random_actions(state: bg_env.EnvState, rand: Rand):
    u = rand((state.n_moves.shape[0],))
    n = state.n_moves.clamp(min=1)
    return (u * n).to(torch.int32) % n


def afterstate_values(model: MLP, state: bg_env.EnvState):
    """(B, M) value of each legal afterstate FOR THE MOVER:
    -V(opponent_view(after), mover = opponent), since the value head is
    trained on states encoded for the player about to move and an
    afterstate has the opponent to move next.  Only the legal prefix is
    evaluated (``ops.afterstate``'s ``masked`` epilogue); the slots past
    it hold NEG_INF, where the JAX twin returns the padding boards' values
    that each of its callers then masks."""
    return AE.evaluate(model, state.after, 1 - state.turn.to(torch.int32),
                       state.n_moves, "value", opponent=True,
                       epilogue="masked", sign=-1.0)


def greedy_1ply(model: MLP, state: bg_env.EnvState):
    return torch.argmax(afterstate_values(model, state),
                        dim=-1).to(torch.int32)


def index_policy_logits(model: MLP, state: bg_env.EnvState):
    """Masked logits with the finite -1e9 floor, and the value; a row
    with no legal move keeps its raw logits."""
    logits, value = model(bg_env.observe(state))
    m = state.after.shape[1]
    mask = bg_env.action_mask(state)
    any_valid = (state.n_moves > 0)[:, None]
    masked = torch.where(mask | torch.logical_not(any_valid), logits[:, :m],
                         NEG_INF)
    return masked, value


def index_policy(model: MLP, state, rand: Rand, sample: bool = True):
    masked, _ = index_policy_logits(model, state)
    if sample:
        return categorical(rand, masked)
    return torch.argmax(masked, dim=-1).to(torch.int32)


def afterstate_policy_logits(model: MLP, state: bg_env.EnvState):
    """(B, M) score-head logits of the legal afterstates, NEG_INF past
    the legal prefix."""
    return AE.evaluate(model, state.after, state.turn, state.n_moves,
                       "score", epilogue="masked")


def afterstate_policy(model: MLP, state, rand: Rand, sample: bool = True):
    logits = afterstate_policy_logits(model, state)
    if sample:
        return categorical(rand, logits)
    return torch.argmax(logits, dim=-1).to(torch.int32)
