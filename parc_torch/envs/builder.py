"""Env construction from config dicts (YAML-loaded).

Registered envs: "deepmimic" (dataset tracking), "parkour" (dm + mgdm
composition), "mgdm" (standalone generated-reference env).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from parc_torch import resolve_device
from parc_torch.anim import char_model as cm
from parc_torch.envs.base import EnvConfig
from parc_torch.physics import engine
from parc_torch.utils.config import dataclass_from_dict


def _platform(cfg: Dict[str, Any], mgdm_terrain, device):
    if mgdm_terrain is not None:
        return mgdm_terrain
    from parc_torch.envs.mgdm import make_platform_terrain
    return make_platform_terrain(
        np.random.default_rng(cfg.get("terrain_seed", 0)),
        dim=cfg.get("terrain_dim", 64), device=device)


def build_env(model: cm.CharModel, cfg: Dict[str, Any], mdm=None,
              mgdm_terrain=None, device="cuda"):
    """The env of ``cfg["env_name"]`` (default "deepmimic"); the remaining
    keys fill EnvConfig / SimParams (from ``cfg["sim"]`` if given) /
    ParkourConfig or MGDMConfig fields by name. The parkour and mgdm envs
    need an ``mdm``; their platform terrain is ``mgdm_terrain``, or drawn
    from ``terrain_seed`` / ``terrain_dim``."""
    dev = resolve_device(device)
    name = cfg.get("env_name", "deepmimic")
    env_cfg = dataclass_from_dict(EnvConfig, cfg)
    sim_params = dataclass_from_dict(engine.SimParams, cfg.get("sim", cfg))
    if name == "deepmimic":
        from parc_torch.envs.deepmimic import DeepMimicEnv
        return DeepMimicEnv(model, sim_params, env_cfg, device=dev)
    if name == "parkour":
        from parc_torch.envs.parkour import ParkourConfig, ParkourEnv
        if mdm is None:
            raise ValueError("the parkour env needs an MDM")
        return ParkourEnv(model, sim_params, env_cfg,
                          dataclass_from_dict(ParkourConfig, cfg), mdm,
                          _platform(cfg, mgdm_terrain, dev), device=dev)
    if name == "mgdm":
        from parc_torch.envs.mgdm import MGDMConfig, MGDMEnv
        if mdm is None:
            raise ValueError("the mgdm env needs an MDM")
        return MGDMEnv(model, sim_params, env_cfg,
                       dataclass_from_dict(MGDMConfig, cfg), mdm,
                       _platform(cfg, mgdm_terrain, dev), device=dev)
    raise KeyError(f"unknown env_name {name!r}")
