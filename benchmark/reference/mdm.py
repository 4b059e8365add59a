"""The MDM's reference: the frozen copy's MDM (denoiser, window sampler,
losses, AdamW and EMA) built from the inputs the benchmark hands both sides
(the clips and terrains, the configuration, the batch, the seed), in
float32 with TF32 off, or, as the control, with the encoder layers'
matmuls in fp8. The program's MDM draws its weights, every batch, the
diffusion noise and the dropout masks from one generator seeded with the
run's seed, in a fixed order; the copy makes the same draws."""

from __future__ import annotations

import torch

from reference import fp8
from reference.anim import motion_lib as ml
from reference.data.humanoid import humanoid_spec
from reference.diffusion import sampler as sampler_lib
from reference.diffusion.mdm import MDM, MDMConfig
from reference.tracker import clip_data


def build(clips, mdm_cfg: dict, sampler_cfg: dict, windows: int, seed: int,
          device, control: bool = False):
    """(mdm, lib, state) of the reference, ready for ``train_step``."""
    from harness.cfg import build as from_json
    model = humanoid_spec().build(device=device)
    lib = ml.build_motion_lib(model, clip_data(clips), device=device)
    mdm = MDM(model, from_json(MDMConfig, mdm_cfg, batch_size=windows,
                               bf16_compute=False),
              from_json(sampler_lib.SamplerConfig, sampler_cfg),
              device=device)
    state = mdm.init(lib, torch.Generator(device=device).manual_seed(seed))
    if control:
        fp8.use_fp8(state.net.layers)
    return mdm, lib, state
