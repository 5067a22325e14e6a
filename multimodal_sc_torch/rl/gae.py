"""Generalized Advantage Estimation over a rollout.

Counterpart of ``multimodal_sc_tpu/rl/gae.py``: the JAX package's reverse
``lax.scan`` is a reverse loop over the T steps of (T, B) tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch


def gae(rewards: torch.Tensor, values: torch.Tensor, dones: torch.Tensor,
        last_value: torch.Tensor, gamma: float,
        lam: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(advantages (T, B), returns (T, B) = advantages + values)``.

    ``rewards`` and ``values`` (V(s_t)) are (T, B), ``dones`` (T, B) marks
    an episode that ended AT step t (after its reward), ``last_value`` (B,)
    is V(s_T). A done cuts the bootstrap and the recursion:
    delta_t = r_t + gamma V_{t+1} (1 - done_t) - V_t and
    A_t = delta_t + gamma lam (1 - done_t) A_{t+1}.
    """
    nonterm = 1.0 - dones.to(values.dtype)
    adv = torch.empty_like(values)
    adv_next = torch.zeros_like(last_value)
    v_next = last_value
    for t in range(values.shape[0] - 1, -1, -1):
        delta = rewards[t] + gamma * v_next * nonterm[t] - values[t]
        adv_next = delta + gamma * lam * nonterm[t] * adv_next
        adv[t] = adv_next
        v_next = values[t]
    return adv, adv + values
