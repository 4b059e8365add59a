"""MDM training loop (parc_1 stage).

Dataset -> feature statistics -> diffusion training loop with EMA,
checkpoints and the epoch's mean loss. An epoch is ``iters_per_epoch``
``train_step``s whose losses stay on the device until the epoch's one read.

Reference parity: parc_1_train_gen.py:13-98 + diffusion/mdm.py:1238-1335.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from parc_torch.anim import motion_lib as ml
from parc_torch.diffusion.mdm import MDM, MDMState
from parc_torch.utils import checkpoint as ckpt_lib
from parc_torch.utils import profiling
from parc_torch.utils.logger import Logger


@dataclasses.dataclass
class MDMTrainerConfig:
    epochs: int = 100000
    iters_per_epoch: int = 50
    epochs_per_checkpoint: int = 2500
    epochs_per_output: int = 10
    output_dir: str = "output/mdm"
    use_wandb: bool = False
    # torch.profiler: capture epochs [profile_start, profile_start +
    # profile_epochs) into <output_dir>/profile/trace.json (Perfetto), with
    # each train_step's parc.mdm.* spans (utils/profiling.py)
    profile_epochs: int = 0
    profile_start: int = 2


def train(mdm: MDM, lib: ml.MotionLib,
          cfg: MDMTrainerConfig = MDMTrainerConfig(),
          state: Optional[MDMState] = None, seed: int = 0,
          max_epochs: Optional[int] = None) -> MDMState:
    """Train from ``state``, or from a fresh init (seeded by ``seed``) that
    resumes from the latest checkpoint in ``cfg.output_dir`` if there is
    one. ``max_epochs`` (default ``cfg.epochs``) is a total: a finished run
    re-invoked is a no-op, and a crashed one completes to the target."""
    ckpt_dir = f"{cfg.output_dir}/checkpoints"
    logger = Logger(output_file=f"{cfg.output_dir}/log.tsv",
                    use_wandb=cfg.use_wandb)
    start_epoch = 0
    if state is None:
        state = mdm.init(lib, torch.Generator(device=mdm.device)
                         .manual_seed(seed))
        start = ckpt_lib.latest_step(ckpt_dir)
        if start is not None:
            state = mdm.merge_persistent(
                state, ckpt_lib.restore(ckpt_dir, map_location=mdm.device))
            # resume epoch numbering where the checkpoint left off so the
            # retained-checkpoint history keeps accumulating distinct steps
            start_epoch = start
            print(f"resumed MDM from checkpoint epoch {start}")

    epochs = cfg.epochs if max_epochs is None else max_epochs
    epochs = max(start_epoch, epochs)
    prof = None
    t_start = time.time()
    for epoch in range(start_epoch, epochs):
        if cfg.profile_epochs and epoch == cfg.profile_start:
            prof = profiling.start_trace()
        t0 = time.time()
        totals = []
        for _ in range(cfg.iters_per_epoch):
            state, metrics = mdm.train_step(lib, state)
            totals.append(metrics["total"])
        totals = torch.stack(totals)
        profiling.sync(totals)
        if prof is not None and \
                epoch + 1 == cfg.profile_start + cfg.profile_epochs:
            path = profiling.stop_trace(prof, f"{cfg.output_dir}/profile")
            prof = None
            print(f"profile trace written to {path}")
        if epoch % cfg.epochs_per_output == 0:
            logger.log("Epoch", epoch)
            logger.log("Step", state.step)
            logger.log("Loss", float(totals.mean()))
            logger.log("Wall_Time", (time.time() - t_start) / 3600.0)
            logger.log("Samples_Per_Sec",
                       cfg.iters_per_epoch * mdm.cfg.batch_size
                       / (time.time() - t0))
            logger.end_iter()
        if (epoch + 1) % cfg.epochs_per_checkpoint == 0:
            ckpt_lib.save(ckpt_dir, epoch + 1, mdm.persistent_state(state))
    if prof is not None:  # the run ended inside the profiled window
        profiling.stop_trace(prof, f"{cfg.output_dir}/profile")

    # final checkpoint so kin-gen always finds a model even when training
    # stopped between checkpoint intervals
    if epochs != start_epoch and epochs % cfg.epochs_per_checkpoint != 0:
        ckpt_lib.save(ckpt_dir, epochs, mdm.persistent_state(state))
    return state
