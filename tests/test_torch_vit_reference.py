"""parc_torch's transformer tracker policy (``learning/vision_nets.DMViT``)
against the benchmark's plain float32 reference of it
(``benchmark/reference/learning/vision_nets.py``), and the ViT trunk's
spans and row counters, on the CPU at a small width over the 7 x 63 ray
cone (49 heightfield tokens).

Tolerances, each a relative max error (the largest |difference| over the
largest |reference output|, of the action mean and of the value):
- f32 port vs reference: 1e-5, as tests/test_torch_vision_nets.py holds
  the port against flax: the two differ only in the order of their sums;
- the port's bf16 trunk vs the f32 reference: inside (0, 2e-2), the gate
  chip_smoke.py phase 9c holds the bf16 trunk to on the card;
- the reference's fp8 control (every dense layer of its trunk in fp8) vs
  the reference: outside 2e-2, so the gate tells one precision lower.
"""

import sys
from pathlib import Path
from types import SimpleNamespace

import torch

from parc_torch.envs.obs import ObsLayout
from parc_torch.learning import vision_nets as tvn

sys.path.append(str(Path(__file__).resolve().parents[1] / "benchmark"))

from reference import fp8  # noqa: E402
from reference.envs import obs as robs  # noqa: E402
from reference.learning import vision_nets as rvn  # noqa: E402
from reference.vit_tracker import trunk_modules  # noqa: E402

torch.set_num_threads(1)

NAMES = ("char_obs", "tar_obs", "contact_obs", "tar_contact_obs", "hf_obs")
SIZES = (10, 12, 3, 6, 7 * 63)
NORMED = (True, True, False, False, False)
WIDTHS = dict(d_model=32, num_heads=4, num_layers=2)


def _nets(seed=3):
    port = tvn.DMViT(5, ObsLayout(NAMES, SIZES, NORMED), (7, 63),
                     generator=torch.Generator().manual_seed(seed),
                     **WIDTHS)
    ref = rvn.DMViT(5, robs.ObsLayout(NAMES, SIZES, NORMED), (7, 63),
                    d_hid=4 * WIDTHS["d_model"],
                    generator=torch.Generator().manual_seed(seed), **WIDTHS)
    return port, ref


def _obs(rows=6):
    return torch.randn((rows, sum(SIZES)),
                       generator=torch.Generator().manual_seed(1))


def _err(got, want) -> float:
    return max(float((g - w).abs().max() / w.abs().max())
               for g, w in ((got[0], want[0]), (got[2], want[2])))


@torch.no_grad()
def test_f32_port_is_the_reference():
    """The same draws give the same weights under the same names, and the
    f32 outputs agree to 1e-5."""
    port, ref = _nets()
    sp, sr = port.state_dict(), ref.state_dict()
    assert list(sp) == list(sr)
    for k in sp:
        assert torch.equal(sp[k], sr[k]), k
    assert ref.num_tokens == port.pos.shape[0] == 1 + 4 + 49
    obs = _obs()
    assert _err(port(obs), ref(obs)) < 1e-5


@torch.no_grad()
def test_bf16_trunk_within_the_gate():
    port, ref = _nets()
    port.compute_dtype = torch.bfloat16
    obs = _obs()
    assert 0.0 < _err(port(obs), ref(obs)) < 2e-2


@torch.no_grad()
def test_fp8_control_outside_the_gate():
    _, ref = _nets()
    _, control = _nets()
    assert fp8.use_fp8(trunk_modules(control)) == 1 + 4 + 6 * 2
    obs = _obs()
    assert _err(control(obs), ref(obs)) > 2e-2


def test_spans_open_under_a_profiler():
    """One forward pass opens ``parc.vit.tokenize`` then
    ``parc.vit.encode``, once each."""
    port, _ = _nets()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            port(_obs())
    spans = sorted((e.time_range.start, e.name) for e in prof.events()
                   if e.name.startswith("parc.vit."))
    assert [n for _, n in spans] == ["parc.vit.tokenize", "parc.vit.encode"]


def test_spans_cost_nothing_without_a_profiler(monkeypatch):
    """Without a profiler the trunk builds no span at all."""
    port, _ = _nets()

    def no_span(name):
        raise AssertionError(f"span {name} built without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", no_span)
    with torch.no_grad():
        port(_obs())


def test_counters_count_an_act_and_a_minibatch():
    """An act of 6 rows adds 6 rows and no grad rows; a minibatch's loss
    and backward pass of 4 rows adds 4 of each. The counts are Python
    ints, read from shapes."""
    from parc_torch.learning.ppo import PPOAgent, PPOConfig

    port, _ = _nets()
    assert (port.rows, port.grad_rows) == (0, 0)
    with torch.no_grad():
        port.actor(_obs(6))
    assert (port.rows, port.grad_rows) == (6, 0)

    agent = SimpleNamespace(cfg=PPOConfig(actor_net="dm_vit"), net=port)
    loss, _ = PPOAgent._loss(agent, _obs(4), torch.zeros(4, 5),
                             torch.zeros(4), torch.ones(4), torch.ones(4),
                             torch.ones(4))
    loss.backward()
    assert (port.rows, port.grad_rows) == (10, 4)
    assert type(port.rows) is int and type(port.grad_rows) is int
