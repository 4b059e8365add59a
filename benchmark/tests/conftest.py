"""Shared set-up of the benchmark's tests: the harness on sys.path, the
``cuda`` marker, and cells shrunk to a size the CPU holds.

Run them with ``python -m pytest benchmark/tests -q`` from the checkout's
root; the tests marked ``cuda`` skip without a card."""

import copy
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

from harness import core  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def bench():
    return core.load_json(core.ROOT / "BENCHMARK.json")


def tiny(bench, name, seed=2 ** 31 + 11, device=None, trace=False):
    """Cell ``name`` at a size the CPU holds: 8 clips, 8 envs or windows,
    small nets; its limits as the cell's file sets them."""
    import torch
    ctx = core.context(bench, name, seed, device or torch.device("cpu"),
                       trace)
    config, workload = copy.deepcopy(ctx.config), copy.deepcopy(ctx.workload)
    if "ppo" in config:
        workload["num_envs"] = 8
        config["ppo"].update(actor_net="fc_2layers_512units",
                             critic_net="fc_2layers_512units",
                             steps_per_iter=4)
    small_mdm = dict(d_model=32, num_heads=2, d_hid=32, num_layers=1,
                     diffusion_timesteps=11)
    if "mdm" in config:
        workload["windows"] = 8
        config["mdm"].update(small_mdm)
    if "mgdm_rows" in workload:
        workload["mgdm_rows"] = 4
        mdm = core.load_json(core.HERE / "configs" /
                             f"{workload['mdm_config']}.json")
        mdm["mdm"].update(small_mdm)
        workload["mdm_config"] = mdm
    traffic = dict(ctx.traffic, clips=8)
    if "platform" in traffic:
        traffic["platform"] = dict(traffic["platform"], dim=20)
    return core.context(bench, name, seed, ctx.device, trace,
                        traffic=traffic, config=config, workload=workload)
