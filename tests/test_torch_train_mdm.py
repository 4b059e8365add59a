"""The MDM's training stage in parc_torch on the CPU: a checkpoint round
trip (the restored state continues bit for bit, generator included) and
``train_mdm`` through the CLI (its log keys, a final checkpoint, resume
with ``--max_epochs`` as a total, and the ``--init_from`` warm start).
The file imports no JAX."""

import csv

import pytest
import torch
import yaml

from parc_torch.anim import motion_data as tmd
from parc_torch.anim import motion_lib as tml
from parc_torch.data import synthetic as tsyn
from parc_torch.data.humanoid import humanoid_spec
from parc_torch.diffusion.mdm import MDM, MDMConfig
from parc_torch.pipeline import cli
from parc_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

TINY = dict(diffusion_timesteps=51, batch_size=4, d_model=32, num_heads=2,
            d_hid=32, num_layers=1, ema_start=1)


def _mdm_and_lib():
    model = humanoid_spec().build(device="cpu")
    lib = tml.build_motion_lib(
        model, [tsyn.walking_clip(n=30, seed=1), tsyn.standing_clip(n=30)],
        device="cpu")
    return MDM(model, MDMConfig(**TINY), device="cpu"), lib


def test_checkpoint_round_trip(tmp_path):
    mdm, lib = _mdm_and_lib()
    state = mdm.init(lib, torch.Generator().manual_seed(0))
    for _ in range(2):
        state, _ = mdm.train_step(lib, state)
    ckpt.save(str(tmp_path), state.step, mdm.persistent_state(state))
    restored = mdm.merge_persistent(
        mdm.init(lib, torch.Generator().manual_seed(5), stats_samples=8),
        ckpt.restore(str(tmp_path)))
    assert restored.step == state.step == 2
    assert torch.equal(restored.mean, state.mean)
    assert torch.equal(restored.std, state.std)
    assert torch.equal(restored.generator.get_state(),
                       state.generator.get_state())
    for (k, a), b in zip(state.net.named_parameters(),
                         restored.net.parameters()):
        assert torch.equal(a, b), k
        sa, sb = state.optimizer.state[a], restored.optimizer.state[b]
        assert torch.equal(sa["exp_avg"], sb["exp_avg"]), k
        assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"]), k
        assert float(sa["step"]) == float(sb["step"]) == 2.0
    # both continue the same stream: one more step agrees bit for bit
    state, m = mdm.train_step(lib, state)
    restored, mr = mdm.train_step(lib, restored)
    assert torch.equal(m["total"], mr["total"])
    for a, b in zip(state.ema_net.parameters(), restored.ema_net.parameters()):
        assert torch.equal(a, b)


def _log_rows(path):
    with open(path) as f:
        return list(csv.DictReader(f, delimiter="\t"))


def test_cli_train_mdm(tmp_path):
    motions = tmp_path / "motions" / "walk"
    motions.mkdir(parents=True)
    tmd.save_motion_data(str(motions / "walk1.npz"),
                         tsyn.walking_clip(n=30, seed=1))
    tmd.save_motion_data(str(motions / "stand.npz"), tsyn.standing_clip(n=30))
    config = tmp_path / "config.yaml"
    config.write_text(yaml.safe_dump(dict(
        TINY, iters_per_epoch=2, epochs_per_output=1)))
    ds, a, b = (str(tmp_path / n) for n in ("dataset.yaml", "a", "b"))
    common = ["--device", "cpu", "--config", str(config)]
    cli.main(["create_dataset", "--motions_dir", str(tmp_path / "motions"),
              "--out", ds] + common)

    def train(out, epochs, *extra):
        return cli.main(["train_mdm", "--dataset", ds, "--out_dir", out,
                         "--max_epochs", str(epochs), *extra] + common)

    state = train(a, 2)
    assert state.step == 4
    assert ckpt.all_steps(f"{a}/checkpoints") == [2]  # the final one
    rows = _log_rows(f"{a}/log.tsv")
    assert [float(r["Epoch"]) for r in rows] == [0, 1]
    assert [float(r["Step"]) for r in rows] == [2, 4]
    for key in ("Loss", "Wall_Time", "Samples_Per_Sec"):
        assert all(float(r[key]) >= 0 for r in rows), key
    assert all(torch.isfinite(p).all() for p in state.net.parameters())
    # max_epochs is a total: the same target is a no-op, a larger resumes
    assert train(a, 2).step == 4
    assert ckpt.all_steps(f"{a}/checkpoints") == [2]
    assert train(a, 3).step == 6
    assert ckpt.all_steps(f"{a}/checkpoints") == [2, 3]
    # warm start from a's latest checkpoint into a new run
    warm = train(b, 1, "--init_from", a)
    assert warm.step == 8
    assert ckpt.all_steps(f"{b}/checkpoints") == [1]


def test_entry_points_need_cuda_unless_cpu(tmp_path):
    """Without a card, the MDM and the train_mdm stage raise unless the
    caller asks for the CPU: there is no silent fallback."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    model = humanoid_spec().build(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MDM(model, MDMConfig(**TINY))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["train_mdm", "--dataset", str(tmp_path / "none.yaml"),
                  "--out_dir", str(tmp_path / "out")])
