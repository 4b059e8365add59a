"""RL return computations.

TD(lambda) as a reverse loop over the T steps of a [T, B] batch (one
tensor op chain per step; T is the rollout length, 32 by default).
"""

from __future__ import annotations

import torch

from reference.envs.base import DoneFlags


def compute_td_lambda_return(r: torch.Tensor, next_vals: torch.Tensor,
                             done: torch.Tensor, discount: float,
                             td_lambda: float) -> torch.Tensor:
    """[T, B] rewards/values/dones -> [T, B] TD(lambda) targets.

    ``done != NULL`` cuts the recursion (the episode bootstraps through
    next_vals at that step).
    """
    reset = (done != DoneFlags.NULL).to(r.dtype)
    rets = [r[-1] + discount * next_vals[-1]]
    for t in range(r.shape[0] - 2, -1, -1):
        lam = td_lambda * (1.0 - reset[t])
        rets.append(r[t] + discount * ((1.0 - lam) * next_vals[t]
                                       + lam * rets[-1]))
    return torch.stack(rets[::-1])
