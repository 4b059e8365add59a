"""parc_torch pipeline CLI.

Stages:

    python -m parc_torch.pipeline.cli create_dataset --motions_dir D \
        --out m.yaml
    python -m parc_torch.pipeline.cli train_mdm --dataset m.yaml --out_dir M
    python -m parc_torch.pipeline.cli kin_gen --dataset m.yaml --mdm_dir M \
        --out_dir K -n 50
    python -m parc_torch.pipeline.cli optimize --motions_dir K --out_dir O
    python -m parc_torch.pipeline.cli augment --motions_dir K --out_dir A
    python -m parc_torch.pipeline.cli train_tracker --dataset m.yaml \
        --out_dir T [--env_name parkour --mdm_dir M]
    python -m parc_torch.pipeline.cli record --dataset m.yaml --tracker_dir T
    python -m parc_torch.pipeline.cli eval --dataset m.yaml --tracker_dir T
    python -m parc_torch.pipeline.cli setup_iter --root R --iter N
    python -m parc_torch.pipeline.cli metrics --motions_dir K [--out m.csv]
    python -m parc_torch.pipeline.cli view --input clip.npz \
        [--compare other.npz]
    python -m parc_torch.pipeline.cli studio [--input clip.npz] \
        [--mdm_dir M --tracker_dir T --port 8000 --workspace W]

Every stage runs on ``--device`` (default ``cuda``; ``--device cpu`` runs
the plain PyTorch versions on the CPU). Any flag can also come from a YAML
file via --config (flags win). Reference parity: run.py:95-164,
parc_0_setup_iter.py, parc_1..5 scripts.

``train_tracker`` trains data-parallel on N GPUs under torchrun, one rank a
GPU, each on ``cuda:{LOCAL_RANK}`` over NCCL:

    python -m torch.distributed.run --nproc_per_node N \
        -m parc_torch.pipeline.cli train_tracker --dataset m.yaml --out_dir T

``--device`` names one device for every rank instead, and
``--dist_backend gloo`` swaps NCCL for gloo (two ranks may share one card
over gloo; NCCL refuses that). The other stages stay single-process.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os

import numpy as np
import torch
import yaml

from parc_torch import resolve_device
from parc_torch.utils.config import dataclass_from_dict


def _load_config(args) -> dict:
    cfg = {}
    if args.config:
        with open(args.config) as f:
            cfg = yaml.safe_load(f) or {}
    for k, v in vars(args).items():
        if v is not None and k not in ("config", "stage"):
            cfg[k] = v
    return cfg


def _device(cfg: dict) -> torch.device:
    return resolve_device(cfg.get("device", "cuda"))


def _build_model(device):
    from parc_torch.data.humanoid import humanoid_spec
    return humanoid_spec().build(device=device)


def _tracking_env(model, cfg: dict, device, **overrides):
    """The env that ``record`` and ``eval`` run a tracker in, whatever it
    was trained in: the deepmimic env on the dataset clips, with default
    physics (``SimParams()``) and the EnvConfig fields of ``cfg``
    (``overrides`` replace some)."""
    from parc_torch.envs.base import EnvConfig
    from parc_torch.envs.deepmimic import DeepMimicEnv
    from parc_torch.physics import engine
    env_cfg = dataclasses.replace(dataclass_from_dict(EnvConfig, cfg),
                                  **overrides)
    return DeepMimicEnv(model, engine.SimParams(), env_cfg, device=device)


def stage_create_dataset(cfg: dict):
    from parc_torch.pipeline import dataset
    out = dataset.create_dataset_yaml(
        cfg["motions_dir"], cfg.get("out", "output/motions.yaml"),
        dataclass_from_dict(dataset.DatasetConfig, cfg),
        device=_device(cfg))
    print(f"wrote {out}")


def _train_device(cfg: dict) -> torch.device:
    """train_tracker's device: in a torchrun launch of more than one rank,
    this rank's (``cuda:{LOCAL_RANK}`` unless ``device`` names one) after
    joining the process group (NCCL on CUDA unless ``dist_backend`` names
    another); else ``device``."""
    from parc_torch.parallel import mesh
    if mesh.launch_world_size() <= 1:
        return _device(cfg)
    info = mesh.init_distributed(backend=cfg.get("dist_backend"),
                                 device=cfg.get("device"))
    print(f"rank {info.rank} of {info.world_size} on {info.device} "
          f"({info.backend})")
    return info.device


def stage_train_tracker(cfg: dict):
    """Tracker training (parc_3). ``env_name: deepmimic`` (default) trains
    on the dataset clips; ``parkour`` trains the composition env (a dm
    fraction on the dataset clips, an mgdm fraction of ``mgdm_num`` envs
    tracking references that the MDM of ``mdm_dir`` generates online);
    ``mgdm`` trains on generated references only. Under torchrun every
    rank runs this, data-parallel (pipeline/train_tracker.py)."""
    from parc_torch.parallel import mesh
    joins = mesh.launch_world_size() > 1 and not mesh.initialized()
    try:
        return _train_tracker(cfg, _train_device(cfg))
    finally:
        if joins:  # leave the group this stage joined
            mesh.shutdown()


def _train_tracker(cfg: dict, dev: torch.device):
    from parc_torch.envs import builder
    from parc_torch.learning.ppo import PPOAgent, PPOConfig
    from parc_torch.pipeline import dataset, train_tracker
    model = _build_model(dev)
    lib = dataset.load_dataset(model, cfg["dataset"], device=dev)
    mdm = mdm_state = None
    if cfg.get("env_name") in ("parkour", "mgdm"):
        from parc_torch.diffusion.mdm import MDM, MDMConfig
        from parc_torch.utils import checkpoint as ckpt_lib
        mdm = MDM(model, dataclass_from_dict(MDMConfig, cfg), device=dev)
        mdm_state = mdm.init(lib, torch.Generator(device=dev).manual_seed(0),
                             stats_samples=256)
        if cfg.get("mdm_dir"):
            mdm_state = mdm.merge_persistent(mdm_state, ckpt_lib.restore(
                f"{cfg['mdm_dir']}/checkpoints", map_location=dev))
    env = builder.build_env(model, cfg, mdm=mdm, device=dev)
    agent = PPOAgent(env, dataclass_from_dict(PPOConfig, cfg), device=dev)
    if mdm is not None:
        lib = env.make_lib(lib, mdm_state)
    tcfg = dataclass_from_dict(train_tracker.TrainerConfig, cfg)
    if cfg.get("out_dir"):
        tcfg = dataclasses.replace(tcfg, output_dir=cfg["out_dir"])
    return train_tracker.train(agent, lib, tcfg, seed=cfg.get("seed", 0),
                               max_iters=cfg.get("max_iters"),
                               meta=dataset.dataset_meta(cfg["dataset"]))


def stage_train_mdm(cfg: dict):
    """Motion-diffusion training (parc_1) on the dataset clips; returns the
    trained MDMState."""
    from parc_torch.diffusion.mdm import MDM, MDMConfig
    from parc_torch.pipeline import dataset, train_mdm
    from parc_torch.utils import checkpoint as ckpt_lib
    dev = _device(cfg)
    seed = cfg.get("seed", 0)
    model = _build_model(dev)
    lib = dataset.load_dataset(model, cfg["dataset"], device=dev)
    mdm = MDM(model, dataclass_from_dict(MDMConfig, cfg), device=dev)
    tcfg = dataclass_from_dict(train_mdm.MDMTrainerConfig, cfg)
    if cfg.get("out_dir"):
        tcfg = dataclasses.replace(tcfg, output_dir=cfg["out_dir"])
    # warm start: PARC iterations k>1 continue training the previous
    # iteration's model on the grown dataset rather than re-initializing
    # (reference: parc_0_setup_iter.py:11,72-76 input_model_path ->
    # parc_1_train_gen.py:40-46); the feature stats come with the restored
    # state. A checkpoint already in out_dir (a resumed run) wins.
    state = None
    if (cfg.get("init_from")
            and ckpt_lib.latest_step(
                f"{tcfg.output_dir}/checkpoints") is None):
        # the fresh state is only a template (the restore overwrites its
        # stats), so a 64-sample estimate stands in for the exact pass
        state = mdm.init(lib, torch.Generator(device=dev).manual_seed(seed),
                         stats_samples=64)
        state = mdm.merge_persistent(state, ckpt_lib.restore(
            f"{cfg['init_from']}/checkpoints", map_location=dev))
        print(f"warm-started MDM from {cfg['init_from']}")
    return train_mdm.train(mdm, lib, tcfg, state=state, seed=seed,
                           max_epochs=cfg.get("max_epochs"))


def _select_checkpoint_step(cfg: dict):
    """Resolve the ``checkpoint`` option for tracker-consuming stages:
    'last' (default) / 'best' (highest logged Test_Reward in the retained
    history: robust to late fail-rate-curriculum reward dips) / an int
    step."""
    which = cfg.get("checkpoint", "last")
    if which in (None, "last"):
        return None
    if which == "best":
        from parc_torch.pipeline import train_tracker
        step = train_tracker.best_checkpoint_step(cfg["tracker_dir"])
        print(f"checkpoint=best -> step {step}")
        return step
    return int(which)


def _restored_agent(cfg: dict, lib, env, seed: int):
    """A PPOAgent on ``env`` and its state, restored from the tracker's
    checkpoint (any num_envs)."""
    from parc_torch.learning import ppo as ppo_lib
    from parc_torch.learning.ppo import PPOAgent, PPOConfig
    from parc_torch.utils import checkpoint as ckpt_lib
    dev = env.device
    agent = PPOAgent(env, dataclass_from_dict(PPOConfig, cfg), device=dev)
    state = agent.init(lib, torch.Generator(device=dev).manual_seed(seed))
    restored = ckpt_lib.restore(f"{cfg['tracker_dir']}/checkpoints",
                                step=_select_checkpoint_step(cfg),
                                map_location=dev)
    # a parkour/mgdm tracker's fail rates carry the appended terrain slot
    # last: the dataset's motions come first
    restored["fail_rates"] = restored["fail_rates"][:lib.num_motions]
    return agent, ppo_lib.merge_persistent(agent, state, restored)


def stage_record(cfg: dict):
    from parc_torch.pipeline import dataset, record
    dev = _device(cfg)
    model = _build_model(dev)
    lib = dataset.load_dataset(model, cfg["dataset"], device=dev)
    env = _tracking_env(model, cfg, dev, num_envs=lib.num_motions,
                        rand_reset=False)
    agent, state = _restored_agent(cfg, lib, env, seed=0)
    rcfg = dataclass_from_dict(record.RecordConfig, cfg)
    results = record.record_motions(agent, lib, state, rcfg)
    paths = record.save_recorded(results,
                                 cfg.get("out_dir", "output/recorded"))
    print(f"recorded {len(paths)}/{lib.num_motions} motions")
    return results


def stage_eval(cfg: dict):
    """Deterministic-policy evaluation of a trained tracker + optional
    network-health diagnostics (reference: run.py modes test/test2,
    learning/dm_ppo_agent.py:162-219 test metrics and :607-773 test_model2
    dormant-unit / stable-rank report)."""
    from parc_torch.pipeline import dataset, train_tracker
    from parc_torch.utils.logger import Logger
    dev = _device(cfg)
    seed = cfg.get("seed", 0)
    model = _build_model(dev)
    lib = dataset.load_dataset(model, cfg["dataset"], device=dev)
    env = _tracking_env(model, cfg, dev)
    agent, state = _restored_agent(cfg, lib, env, seed=seed)
    test_fn = train_tracker.make_test_fn(
        agent, cfg.get("test_steps", 300),
        test_episodes=cfg.get("test_episodes", 16))
    test = test_fn(lib, state, torch.Generator(device=dev).manual_seed(seed))
    print(f"test_reward      {float(test['mean_reward']):.4f}")
    print(f"test_return      {float(test['mean_return']):.4f}")
    print(f"episodes         {int(test['num_eps'])}"
          f" (over {int(test['test_steps'])} steps)")
    print(f"mean_ep_len      {float(test['mean_ep_len']):.3f} s")
    print(f"fail_frac        {float(test['fail_frac']):.4f}")
    comp = test["component_returns"].cpu().numpy()
    for name, v in zip(train_tracker.REWARD_COMPONENT_NAMES, comp):
        print(f"return_{name:<13s} {float(v):.4f}")
    terr = test["tracking_error"].cpu().numpy()
    for name, v in zip(train_tracker.TRACKING_ERROR_NAMES, terr):
        print(f"{name:<16s} {float(v):.5f}")
    train_tracker.log_fail_rate_tables(
        Logger(), state.env_state.fail_rates.cpu().numpy(),
        dataset.dataset_meta(cfg["dataset"]), top_k=10)
    report = None
    if cfg.get("diagnostics"):
        from parc_torch.learning import diagnostics
        report = diagnostics.full_report(agent, state, state.env_state.obs)
        print("\nnetwork diagnostics (test2 parity):")
        for layer, stats in report.items():
            line = "  ".join(f"{k}={v:.4g}" if isinstance(v, float)
                             else f"{k}={v}" for k, v in stats.items())
            print(f"  {layer}: {line}")
    return test, report


def stage_kin_gen(cfg: dict):
    """Kinematic generation (parc_2) from the MDM trained by ``train_mdm``
    under ``mdm_dir`` (feature stats come with the checkpoint); returns the
    written clip paths. ``batch_idx`` / ``num_batches`` shard the motion
    slots across jobs that share ``out_dir`` (reference: parc_0 writes
    num_batches_of_motions kin-gen job configs for separate machines)."""
    from parc_torch.diffusion.mdm import MDM, MDMConfig
    from parc_torch.pipeline import dataset, kin_gen
    from parc_torch.utils import checkpoint as ckpt_lib
    dev = _device(cfg)
    model = _build_model(dev)
    lib = dataset.load_dataset(model, cfg["dataset"], device=dev)
    mdm = MDM(model, dataclass_from_dict(MDMConfig, cfg), device=dev)
    state = mdm.init(lib, torch.Generator(device=dev).manual_seed(0),
                     stats_samples=512)
    if cfg.get("mdm_dir"):
        state = mdm.merge_persistent(state, ckpt_lib.restore(
            f"{cfg['mdm_dir']}/checkpoints", map_location=dev))
    num_motions = cfg.get("num_motions", 10)
    batch_idx = int(cfg.get("batch_idx", 0))
    num_batches = int(cfg.get("num_batches", 1))
    prefix = f"b{batch_idx}_" if num_batches > 1 else ""
    paths = kin_gen.run_kin_gen(
        mdm, state, num_motions, cfg.get("out_dir", "output/kin_gen"),
        dataclass_from_dict(kin_gen.KinGenConfig, cfg),
        seed=cfg.get("seed", 0) + batch_idx * num_motions,
        name_prefix=prefix)
    print(f"generated {len(paths)} clips")
    return paths


def stage_setup_iter(cfg: dict):
    """Write the per-iteration stage configs chaining output dirs
    (reference: parc_0_setup_iter.py); returns {stage: config path}. Each
    config carries the ``device`` its stage runs on."""
    dev = _device(cfg)
    root = cfg.get("root", "output/parc")
    it = int(cfg.get("iter", 0))
    base = os.path.join(root, f"iter_{it}")
    os.makedirs(base, exist_ok=True)
    stages = {
        "train_mdm": {"dataset": os.path.join(base, "motions.yaml"),
                      "out_dir": os.path.join(base, "mdm")},
        "kin_gen": {"dataset": os.path.join(base, "motions.yaml"),
                    "mdm_dir": os.path.join(base, "mdm"),
                    "out_dir": os.path.join(base, "kin_gen"),
                    "num_motions": cfg.get("num_motions", 50),
                    "num_batches": cfg.get("num_batches", 1)},
        "train_tracker": {"dataset": os.path.join(base, "motions+gen.yaml"),
                          "out_dir": os.path.join(base, "tracker")},
        "record": {"dataset": os.path.join(base, "motions+gen.yaml"),
                   "tracker_dir": os.path.join(base, "tracker"),
                   "out_dir": os.path.join(base, "recorded")},
        "create_dataset": {"motions_dir": os.path.join(base, "recorded"),
                           "out": os.path.join(root, f"iter_{it + 1}",
                                               "motions.yaml")},
    }
    written = {}
    for name, scfg in stages.items():
        path = os.path.join(base, f"{name}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump({**scfg, "device": str(dev)}, f)
        print(f"wrote {path}")
        written[name] = path
    return written


def _clip_files(motions_dir: str):
    return sorted(glob.glob(os.path.join(motions_dir, "*.npz"))
                  + glob.glob(os.path.join(motions_dir, "*.pkl")))


def stage_metrics(cfg: dict):
    """Per-clip quality metrics + dataset statistics for a motion dir
    (reference: tools/motion_tests/compute_losses.py, compute_stats.py);
    writes the CSV (``--out``, default ``<motions_dir>/metrics.csv``) and
    returns the rows and the statistics."""
    from parc_torch.anim import motion_data as md
    from parc_torch.tools import metrics
    model = _build_model(_device(cfg))
    motions_dir = cfg["motions_dir"]
    csv_path = cfg.get("out", os.path.join(motions_dir, "metrics.csv"))
    rows = metrics.evaluate_motion_dir(model, motions_dir, csv_path=csv_path)
    print(f"wrote {csv_path} ({len(rows)} clips)")
    motions = [md.load_motion_data(os.path.join(motions_dir, r["file"]))
               for r in rows]
    stats = metrics.dataset_statistics(model, motions) if motions else {}
    for k, v in stats.items():
        print(f"{k}: {v:.4f}")
    return rows, stats


def stage_augment(cfg: dict):
    """Batch terrain-aware augmentation of an existing motion set
    (reference: tools/motion_opt/augment_motions.py); returns the written
    clip paths."""
    from parc_torch.anim import motion_data as md
    from parc_torch.pipeline import augment
    model = _build_model(_device(cfg))
    files = _clip_files(cfg["motions_dir"])
    motions = [md.load_motion_data(f) for f in files]
    acfg = dataclass_from_dict(augment.AugmentConfig, cfg)
    if cfg.get("num_motions"):
        acfg = dataclasses.replace(acfg, num_new_motions=cfg["num_motions"])
    paths = augment.run_augment(model, motions,
                                cfg.get("out_dir", "output/augmented"),
                                acfg, names=files, seed=cfg.get("seed", 0))
    print(f"wrote {len(paths)} augmented clips")
    return paths


def stage_optimize(cfg: dict):
    """Batch terrain-aware contact optimization of existing clips
    (reference: tools/motion_opt/optimize_motions.py); returns
    {written path: final losses}."""
    from parc_torch.anim import motion_data as md
    from parc_torch.opt import motion_opt
    dev = _device(cfg)
    model = _build_model(dev)
    out_dir = cfg.get("out_dir", "output/optimized")
    os.makedirs(out_dir, exist_ok=True)
    ocfg = dataclass_from_dict(motion_opt.MotionOptConfig, cfg)
    written = {}
    for f in _clip_files(cfg["motions_dir"]):
        m = md.load_motion_data(f)
        if m.terrain is None:
            print(f"skipping {f} (no terrain)")
            continue
        contacts = (m.contacts if m.contacts is not None
                    else np.zeros((m.frames.shape[0], model.num_bodies),
                                  np.float32))
        frames, losses = motion_opt.motion_contact_optimization(
            model, m.terrain.to_device(dev), m.frames, contacts, ocfg)
        base = os.path.splitext(os.path.basename(f))[0]
        out = os.path.join(out_dir, base + "_opt.npz")
        md.save_motion_data(out, dataclasses.replace(
            m, frames=frames.cpu().numpy().astype(np.float32)))
        print(f"{base}: pen={losses['penetration']:.4f} "
              f"contact={losses['contact']:.4f} -> {out}")
        written[out] = losses
    print(f"optimized {len(written)} clips")
    return written


def stage_view(cfg: dict):
    """Export a standalone HTML viewer for a clip (``--compare`` adds a
    second clip beside it), and a PNG strip where matplotlib is installed
    (reference: the MOTION_FORGE viewer app); returns the paths written."""
    import importlib.util

    from parc_torch.anim import motion_data as md
    from parc_torch.viewer import html_viewer
    dev = _device(cfg)
    model = _build_model(dev)
    motion = md.load_motion_data(cfg["input"])
    out = cfg.get("out") or cfg["input"].rsplit(".", 1)[0] + ".html"
    if cfg.get("compare"):
        other = md.load_motion_data(cfg["compare"])
        html_viewer.export_compare(
            model, [motion, other], out,
            labels=[os.path.basename(cfg["input"]),
                    os.path.basename(cfg["compare"])],
            title=os.path.basename(cfg["input"]), device=dev)
    else:
        html_viewer.export(model, motion, out,
                           title=os.path.basename(cfg["input"]), device=dev)
    if importlib.util.find_spec("matplotlib") is None:
        print(f"wrote {out} (no .png strip: matplotlib is not installed)")
        return [out]
    from parc_torch.viewer import render
    png = out.rsplit(".", 1)[0] + ".png"
    render.render_motion_strip(model, motion, png, device=dev)
    print(f"wrote {out} (+ .png strip)")
    return [out, png]


def stage_studio(cfg: dict):
    """Interactive browser studio: terrain editing, A* planning, MDM
    generation, motion editing/optimization, physics tracking in the loop
    (reference: the MOTION_FORGE Polyscope app). Serves until interrupted.
    """
    from parc_torch.anim import motion_data as md
    from parc_torch.viewer import studio
    dev = _device(cfg)
    motion = (md.load_motion_data(cfg["input"])
              if cfg.get("input") else None)
    s = studio.Studio(_build_model(dev), motion,
                      mdm_dir=cfg.get("mdm_dir"),
                      tracker_dir=cfg.get("tracker_dir"),
                      seed=cfg.get("seed", 0),
                      # MDMConfig / PPOConfig keys are picked inside
                      mdm_config=cfg, tracker_config=cfg,
                      workspace=cfg.get("workspace"), device=dev)
    studio.run_studio(s, port=int(cfg.get("port", 8000)),
                      host=cfg.get("host", "127.0.0.1"),
                      allow_remote=bool(cfg.get("allow_remote", False)))


STAGES = {
    "create_dataset": stage_create_dataset,
    "train_tracker": stage_train_tracker,
    "record": stage_record,
    "eval": stage_eval,
    "train_mdm": stage_train_mdm,
    "kin_gen": stage_kin_gen,
    "setup_iter": stage_setup_iter,
    "augment": stage_augment,
    "optimize": stage_optimize,
    "metrics": stage_metrics,
    "view": stage_view,
    "studio": stage_studio,
}


def main(argv=None):
    """Run one stage; returns what the stage returns (the trained tracker
    or MDM state, the recorded clips, the eval statistics, the written
    files), for callers in Python."""
    p = argparse.ArgumentParser(prog="parc_torch.pipeline")
    p.add_argument("stage", choices=sorted(STAGES))
    p.add_argument("--config", default=None)
    p.add_argument("--device", default=None,
                   help="torch device of every stage (default cuda)")
    p.add_argument("--input", default=None)
    p.add_argument("--compare", default=None)
    p.add_argument("--dataset", default=None)
    p.add_argument("--motions_dir", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--out_dir", default=None)
    p.add_argument("--init_from", default=None,
                   help="train_mdm: warm-start from this run's checkpoints"
                        " (reference input_model_path iteration chaining)")
    p.add_argument("--mdm_dir", default=None)
    p.add_argument("--tracker_dir", default=None)
    p.add_argument("--checkpoint", default=None,
                   help="tracker checkpoint for record/eval: 'last' "
                        "(default), 'best' (highest logged Test_Reward), "
                        "or an int step")
    p.add_argument("--root", default=None)
    p.add_argument("--iter", type=int, default=None)
    p.add_argument("--num_motions", "-n", type=int, default=None)
    p.add_argument("--batch_idx", type=int, default=None)
    p.add_argument("--num_batches", type=int, default=None)
    p.add_argument("--num_envs", type=int, default=None)
    p.add_argument("--max_iters", type=int, default=None)
    p.add_argument("--max_epochs", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--test_steps", type=int, default=None)
    p.add_argument("--test_episodes", type=int, default=None)
    p.add_argument("--diagnostics", action="store_true", default=None)
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--host", default=None)
    p.add_argument("--allow_remote", action="store_true", default=None)
    p.add_argument("--workspace", default=None)
    p.add_argument("--env_name", default=None,
                   choices=["deepmimic", "parkour", "mgdm"])
    p.add_argument("--dist_backend", default=None, choices=["nccl", "gloo"],
                   help="train_tracker under torchrun: the process group's "
                        "backend (default nccl on CUDA, gloo on the CPU)")
    args = p.parse_args(argv)
    return STAGES[args.stage](_load_config(args))


if __name__ == "__main__":
    main()
