#!/usr/bin/env python3
"""Convert a run of the JAX package (orbax checkpoints) into a run of the
PyTorch port (parc_torch checkpoints).

    python tools/orbax_to_torch.py SRC_RUN_DIR DST_RUN_DIR [--config cfg.yaml]

SRC_RUN_DIR is a directory that parc_tpu's ``train_tracker`` or
``train_mdm`` wrote: ``checkpoints/<step>/`` (orbax) and ``log.tsv``. Every
step is restored and written as the port's checkpoint
``DST_RUN_DIR/checkpoints/<step>/state.pt``; ``log.tsv`` is copied, so that
``checkpoint=best`` picks the same step, and so is the run's config (the
``--config`` file, else ``SRC_RUN_DIR/config.yaml`` if there is one), as
``DST_RUN_DIR/config.yaml``. The port's entry points then take DST_RUN_DIR
as they take a run of their own: ``train_tracker --out_dir`` resumes from
it, ``record``, ``eval`` and the studio read it as ``--tracker_dir``,
``kin_gen`` and the studio as ``--mdm_dir``.

The kind of checkpoint is read from its tree:
- a tracker (``ppo.persistent_state``: params, opt_state, obs_norm,
  sample_count, fail_rates), with MLP nets or a vision policy (dm_cnn_mlp,
  dm_vit); a parkour or mgdm tracker's fail rates keep the terrain slot
  last, as the port's own checkpoints keep it;
- an MDM trainer's state (``MDMState``: params, ema_params, opt_state,
  mean, std, rng, step); the JAX key is not carried over (the port draws
  from a torch generator).

Run it where JAX and orbax are installed, not on the GPU machine: parc_torch
reads what it writes without either. JAX runs on the CPU here unless
JAX_PLATFORMS says otherwise. An orbax checkpoint does not hold the
observation normalizer's clip and sample limit (static fields of the JAX
NormalizerState): they come from the config's ``norm_obs_clip`` and
``normalizer_samples``, else PPOConfig's defaults.
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import yaml  # noqa: E402

from parc_torch import convert  # noqa: E402
from parc_torch.utils import checkpoint as torch_ckpt  # noqa: E402
from parc_tpu.learning.ppo import PPOConfig  # noqa: E402
from parc_tpu.utils import checkpoint as jax_ckpt  # noqa: E402

TRACKER_KEYS = {"params", "opt_state", "obs_norm", "sample_count",
                "fail_rates"}
MDM_KEYS = {"params", "ema_params", "opt_state", "mean", "std", "step"}
_OPTAX_STATES = {frozenset(cls._fields): cls
                 for cls in (optax.TraceState, optax.ScaleByAdamState)}


def optax_state(tree):
    """optax's named tuples back in a tree restored against the
    checkpoint's metadata, which holds a named tuple as a dict of its
    fields and a tuple as a list."""
    if isinstance(tree, dict):
        items = {k: optax_state(v) for k, v in tree.items()}
        cls = _OPTAX_STATES.get(frozenset(items))
        return cls(**items) if cls else items
    if isinstance(tree, list):
        return tuple(optax_state(v) for v in tree)
    return tree


def tracker_net(params) -> str:
    """The tracker's policy: dm_vit, dm_cnn_mlp or the MLP trunk widths."""
    p = params.get("params", params)
    if "RayConvTokenizer_0" in p:
        return "dm_vit" if "cls" in p else "dm_cnn_mlp"
    widths = [np.shape(p["actor_trunk"][f"Dense_{i}"]["kernel"])[1]
              for i in range(len(p["actor_trunk"]))]
    return f"MLP {'x'.join(map(str, widths))}"


def restore_step(ckpt_dir: str, step: int):
    """One step of a JAX run (the tree of ``jax_ckpt.save``) as numpy
    arrays, whatever devices it was saved from: restored onto one CPU
    device against the checkpoint's own metadata."""
    import orbax.checkpoint as ocp
    path = os.path.join(os.path.abspath(ckpt_dir), str(step), "default")
    ckptr = ocp.StandardCheckpointer()
    absl = logging.getLogger("absl")
    level = absl.level
    absl.setLevel(logging.ERROR)  # the step's metadata file is one level up
    try:
        meta = ckptr.metadata(path).item_metadata.tree
    finally:
        absl.setLevel(level)
    cpu = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])
    like = jax.tree.map(
        lambda m: jax.ShapeDtypeStruct(m.shape, m.dtype, sharding=cpu), meta)
    return jax.tree.map(np.asarray, ckptr.restore(path, like))


def convert_step(tree, cfg: dict):
    """(the port's checkpoint dict, a description) of one restored step
    (numpy leaves)."""
    keys = set(tree)
    if not (keys == TRACKER_KEYS or MDM_KEYS <= keys):
        raise ValueError(f"not a tracker or MDM checkpoint: keys "
                         f"{sorted(keys)}")
    tree = dict(tree, opt_state=optax_state(tree["opt_state"]))
    if keys == TRACKER_KEYS:
        defaults = PPOConfig()
        tree["obs_norm"] = dict(
            tree["obs_norm"],
            clip=float(cfg.get("norm_obs_clip", defaults.norm_obs_clip)),
            sample_limit=float(cfg.get("normalizer_samples",
                                       defaults.normalizer_samples)))
        fail_rates = np.shape(tree["fail_rates"])[0]
        return (convert.persistent_from_numpy(tree),
                f"tracker ({tracker_net(tree['params'])}, "
                f"{fail_rates} fail rates)")
    return (convert.mdm_state_from_numpy(tree),
            f"MDM (step {int(tree['step'])})")


def convert_run(src: str, dst: str, config: str | None = None) -> list:
    """Convert every checkpoint step of the JAX run ``src`` into the port's
    run ``dst``; returns the steps."""
    src_ckpt = os.path.join(src, "checkpoints")
    if not os.path.isdir(src_ckpt):
        raise FileNotFoundError(f"no checkpoints directory in {src}")
    steps = jax_ckpt.all_steps(src_ckpt)
    if not steps:
        raise FileNotFoundError(f"no orbax checkpoints in {src_ckpt}")
    if config is None and os.path.isfile(os.path.join(src, "config.yaml")):
        config = os.path.join(src, "config.yaml")
    cfg = {}
    if config is not None:
        with open(config) as f:
            cfg = yaml.safe_load(f) or {}
    os.makedirs(dst, exist_ok=True)
    for step in steps:
        state, kind = convert_step(restore_step(src_ckpt, step), cfg)
        path = torch_ckpt.save(os.path.join(dst, "checkpoints"), step, state)
        print(f"step {step}: {kind} -> {path}")
    if os.path.isfile(os.path.join(src, "log.tsv")):
        shutil.copyfile(os.path.join(src, "log.tsv"),
                        os.path.join(dst, "log.tsv"))
    if config is not None:
        shutil.copyfile(config, os.path.join(dst, "config.yaml"))
    return steps


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("src", help="the JAX run directory (orbax checkpoints)")
    p.add_argument("dst", help="the port's run directory to write")
    p.add_argument("--config", default=None,
                   help="the run's config YAML (copied; the normalizer's "
                        "clip and sample limit are read from it)")
    args = p.parse_args(argv)
    steps = convert_run(args.src, args.dst, args.config)
    print(f"converted {len(steps)} checkpoint(s) of {args.src} into "
          f"{args.dst}")


if __name__ == "__main__":
    main()
