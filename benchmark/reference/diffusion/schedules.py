"""Diffusion schedules and embeddings.

Reference parity: diffusion/diffusion_util.py:72-248 — cosine beta schedule
over 1001 steps, posterior coefficients for predict-x0 DDPM, sinusoidal
timestep embeddings.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DiffusionRates:
    """Host numpy f32 tables, one entry per timestep: the samplers read
    per-step scalars from them without touching the device."""

    betas: np.ndarray
    alphas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    posterior_mean_x0_coef: np.ndarray
    posterior_mean_xt_coef: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    steps = timesteps + 1
    x = np.linspace(0, timesteps, steps)
    ac = np.cos(((x / timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
    ac = ac / ac[0]
    betas = 1 - (ac[1:] / ac[:-1])
    return np.clip(betas, 0.0001, 0.9999)


def make_rates(timesteps: int = 1001) -> DiffusionRates:
    betas = cosine_beta_schedule(timesteps).astype(np.float32)
    alphas = 1.0 - betas
    ac = np.cumprod(alphas)
    ac_prev = np.concatenate([np.ones((1,), np.float32), ac[:-1]])
    posterior_variance = betas * (1.0 - ac_prev) / (1.0 - ac)

    def f32(x):
        return np.asarray(x, np.float32)

    return DiffusionRates(
        betas=f32(betas),
        alphas=f32(alphas),
        alphas_cumprod=f32(ac),
        alphas_cumprod_prev=f32(ac_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(ac)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - ac)),
        posterior_mean_x0_coef=f32(betas * np.sqrt(ac_prev) / (1.0 - ac)),
        posterior_mean_xt_coef=f32((1.0 - ac_prev) * np.sqrt(alphas)
                                   / (1.0 - ac)),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(
            np.log(np.maximum(posterior_variance, 1e-20))),
    )


def gather(table: np.ndarray, t: torch.Tensor) -> torch.Tensor:
    """``table[t]`` for a tensor of timesteps, on ``t``'s device."""
    return torch.as_tensor(table, device=t.device)[t]


def forward_diffusion(rates: DiffusionRates, x0: torch.Tensor,
                      t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """q(x_t | x_0): scale and noise. t broadcasts over batch dims."""
    a = gather(rates.sqrt_alphas_cumprod, t)
    b = gather(rates.sqrt_one_minus_alphas_cumprod, t)
    shape = t.shape + (1,) * (x0.dim() - t.dim())
    return a.reshape(shape) * x0 + b.reshape(shape) * noise


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """(..., dim) sinusoidal embedding: the cosines, then the sines."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t[..., None].to(torch.float32) * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
