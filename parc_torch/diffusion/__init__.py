"""Terrain-conditioned motion diffusion (the MDM): schedules, the window
sampler, the denoiser, training, DDIM/DDPM sampling and guidance."""
