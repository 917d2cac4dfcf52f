"""Return / advantage estimators over (T, B) rollout columns.

Port of ``mlp_ppo_2ply_p3_tpu/ppo/gae.py``; the reverse ``lax.scan``s
are reverse Python loops over T.

- ``negamax_gae``: GAE(lambda) in the MOVER's perspective for zero-sum
  self-play (the default): the bootstrap and advantage recursions negate
  whenever the mover changes between consecutive steps.
- ``gae``: single-perspective GAE(lambda) with bootstrap, per env column.
- ``mc_returns_ref``: the reference's reversed discounted sum with R=0
  reset at dones and no bootstrap, per env column (parity preset).
"""

from __future__ import annotations

import torch


def gae(rewards, values, dones, last_value, gamma: float, lam: float):
    """rewards/values/dones: (T, B); last_value: (B,) bootstrap V(s_T).

    Returns (advantages (T, B), returns (T, B))."""
    not_done = 1.0 - dones.to(torch.float32)
    advs = torch.empty_like(values)
    adv_next, v_next = torch.zeros_like(last_value), last_value
    for t in range(rewards.shape[0] - 1, -1, -1):
        nd = not_done[t]
        delta = rewards[t] + gamma * v_next * nd - values[t]
        adv_next = delta + gamma * lam * nd * adv_next
        advs[t] = adv_next
        v_next = values[t]
    return advs, advs + values


def negamax_gae(rewards, values, dones, flips, last_value,
                gamma: float, lam: float):
    """Mover-perspective GAE for alternating zero-sum self-play.

    delta_t = r_t + gamma * s_t * V(s_{t+1}) * nd_t - V(s_t)
    A_t     = delta_t + gamma * lam * s_t * nd_t * A_{t+1}
    with s_t = -1 where the mover flips between t and t+1, +1 otherwise.
    Returns (advantages, value targets)."""
    nd_all = 1.0 - dones.to(torch.float32)
    sign = torch.where(flips, -1.0, 1.0).to(torch.float32)
    advs = torch.empty_like(values)
    adv_next, v_next = torch.zeros_like(last_value), last_value
    for t in range(rewards.shape[0] - 1, -1, -1):
        s, n = sign[t], nd_all[t]
        delta = rewards[t] + gamma * s * v_next * n - values[t]
        adv_next = delta + gamma * lam * s * n * adv_next
        advs[t] = adv_next
        v_next = values[t]
    return advs, advs + values


def mc_returns_ref(rewards, dones, gamma: float):
    """Reference-style Monte-Carlo returns: reversed discounted sum, reset
    at done, zero bootstrap.  (T, B) -> (T, B)."""
    not_done = 1.0 - dones.to(torch.float32)
    rets = torch.empty_like(rewards)
    r_next = torch.zeros_like(rewards[0])
    for t in range(rewards.shape[0] - 1, -1, -1):
        r_next = rewards[t] + gamma * r_next * not_done[t]
        rets[t] = r_next
    return rets
