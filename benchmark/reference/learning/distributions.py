"""Action distribution helpers (plain functions on tensors).

The diagonal Gaussian of the tracker's actor and the categorical helpers.
Samples draw from an explicit ``torch.Generator`` on the tensors' device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

_LOG_2PI = math.log(2.0 * math.pi)


def sample(generator: Optional[torch.Generator], mean: torch.Tensor,
           logstd: torch.Tensor) -> torch.Tensor:
    return mean + torch.exp(logstd) * torch.randn(
        mean.shape, generator=generator, device=mean.device, dtype=mean.dtype)


def mode(mean: torch.Tensor, logstd: torch.Tensor) -> torch.Tensor:
    del logstd
    return mean


def log_prob(mean: torch.Tensor, logstd: torch.Tensor,
             actions: torch.Tensor) -> torch.Tensor:
    var = torch.exp(2.0 * logstd)
    return torch.sum(-0.5 * ((actions - mean) ** 2 / var)
                     - logstd - 0.5 * _LOG_2PI, dim=-1)


def entropy(logstd: torch.Tensor) -> torch.Tensor:
    return torch.sum(logstd + 0.5 * (_LOG_2PI + 1.0), dim=-1)


def kl(mean0: torch.Tensor, logstd0: torch.Tensor, mean1: torch.Tensor,
       logstd1: torch.Tensor) -> torch.Tensor:
    var0, var1 = torch.exp(2 * logstd0), torch.exp(2 * logstd1)
    return torch.sum(logstd1 - logstd0
                     + (var0 + (mean0 - mean1) ** 2) / (2.0 * var1) - 0.5,
                     dim=-1)


# ---------------------------------------------------------------------------
# Categorical
# ---------------------------------------------------------------------------


def categorical_sample(generator: Optional[torch.Generator],
                       logits: torch.Tensor) -> torch.Tensor:
    probs = torch.softmax(logits, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    draws = torch.multinomial(flat, 1, generator=generator)
    return draws.reshape(logits.shape[:-1])


def categorical_mode(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1)


def categorical_log_prob(logits: torch.Tensor,
                         actions: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return torch.take_along_dim(logp, actions[..., None].long(),
                                dim=-1)[..., 0]


def categorical_entropy(logits: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.sum(torch.exp(logp) * logp, dim=-1)


def categorical_kl(logits0: torch.Tensor,
                   logits1: torch.Tensor) -> torch.Tensor:
    lp0 = torch.log_softmax(logits0, dim=-1)
    lp1 = torch.log_softmax(logits1, dim=-1)
    return torch.sum(torch.exp(lp0) * (lp0 - lp1), dim=-1)
