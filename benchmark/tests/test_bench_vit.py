"""The ViT tracker cell's own pieces, on the CPU: the yardstick's counts of
the ViT against torch's flop counter, the reference's row blocks against
its whole minibatches, the program's row counters over the measured
window, and the two metrics that read them. The fp8 control and every
fault planted in ``tracker.vit`` (the attention without its scale among
them) come out as not correct in test_bench_control.py, which takes every
cell of BENCHMARK.json."""

import copy

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import tiny
from harness import core, traffic, vit_counts

VIT = core.load_json(core.HERE / "configs" /
                     "humanoid_vit_tracker.json")["vit"]
NAMES = ("char_obs", "tar_obs", "contact_obs", "tar_contact_obs", "hf_obs")
SIZES = (10, 12, 3, 6, 7 * 63)
SMALL = dict(d_model=32, num_heads=4, num_layers=2)


def _net(side: str):
    g = torch.Generator().manual_seed(4)
    if side == "program":
        from parc_torch.envs.obs import ObsLayout
        from parc_torch.learning.vision_nets import DMViT
        return DMViT(5, ObsLayout(NAMES, SIZES, (True,) * 5), (7, 63),
                     generator=g, **SMALL)
    from reference.envs.obs import ObsLayout
    from reference.learning.vision_nets import DMViT
    return DMViT(5, ObsLayout(NAMES, SIZES, (True,) * 5), (7, 63),
                 d_hid=4 * SMALL["d_model"], generator=g, **SMALL)


@pytest.mark.parametrize("side", ["program", "reference"])
def test_counts_are_the_flop_counters(side):
    """Forward and backward operations a row at a small width, as
    ``FlopCounterMode`` counts them on either side's net."""
    vit = dict(VIT, d_hid=4 * SMALL["d_model"], **SMALL)
    net = _net(side)
    obs = torch.randn((3, sum(SIZES)), generator=torch.Generator()
                      .manual_seed(5))
    with FlopCounterMode(display=False) as fwd:
        mean, _, value = net(obs)
    loss = mean.square().sum() + value.square().sum()
    with FlopCounterMode(display=False) as bwd:
        loss.backward()
    segments = SIZES[:-1]
    assert fwd.get_total_flops() == 3 * vit_counts.forward_flops(
        vit, segments, 5)
    assert bwd.get_total_flops() == 3 * vit_counts.backward_flops(
        vit, segments, 5)


def test_counts_at_the_published_widths():
    """The humanoid's observation (136, 630, 15 and 90 wide beside the
    441 rays) and 28 actions: 54 tokens, some 281 MFLOP a row forward."""
    segments = (136, 630, 15, 90)
    assert vit_counts.tokens(VIT, segments) == VIT["tokens"] == 54
    assert vit_counts.forward_flops(VIT, segments, 28) == 281_304_512
    assert vit_counts.backward_flops(VIT, segments, 28) == 561_739_712


def _agents(bench, rows):
    """Two reference agents with the same weights, computing in blocks of
    ``rows`` rows."""
    from reference import vit_tracker
    ctx = tiny(bench, "tracker.vit")
    driver = core.driver_module(ctx)
    cell = driver.Cell(ctx)
    c, w = cell.ctx.config, cell.ctx.workload
    clips = traffic.make(ctx.traffic, ctx.seed)
    return [vit_tracker.build(clips, c["env"], c["sim"], c["ppo"],
                              w["num_envs"], ctx.seed, ctx.device, rows)[0]
            for _ in range(2)]


@pytest.mark.parametrize("held", [False, True])
def test_blocked_update_is_the_minibatch_update(bench, held):
    """The reference's update in blocks of 3 rows (minibatches of 8) ends
    where the frozen agent's whole minibatches do, the guard holding the
    actor (critic loss over its bound) or not, and reads the same
    losses."""
    from reference.learning.ppo import PPOAgent
    blocked, whole = _agents(bench, 3)
    g = torch.Generator().manual_seed(6)
    n, obs_dim, act = 24, blocked.env.obs_dim, blocked.env.action_dim
    flat = {"norm_obs": torch.randn((n, obs_dim), generator=g),
            "norm_a": 0.1 * torch.randn((n, act), generator=g),
            "logp": torch.randn(n, generator=g),
            "adv": torch.randn(n, generator=g),
            "tar_val": (10.0 if held else 0.1) * torch.randn(n, generator=g),
            "rand_mask": (torch.rand(n, generator=g) < 0.7).float()}
    outs = []
    for agent, update in ((blocked, blocked._update),
                          (whole, PPOAgent._update.__get__(whole))):
        gen = torch.Generator().manual_seed(7)
        outs.append((update(copy.deepcopy(flat), agent._make_optimizer(),
                            gen, 8), dict(agent.net.named_parameters())))
    (aux_b, p_b), (aux_w, p_w) = outs
    assert bool(aux_w["critic_loss"][0] > 20.0) is held
    for k in aux_w:
        torch.testing.assert_close(aux_b[k], aux_w[k])
    for k in p_w:
        torch.testing.assert_close(p_b[k], p_w[k], rtol=1e-5, atol=1e-7)


def test_blocked_targets_are_the_whole_targets(bench):
    """The targets' critic passes in blocks of 5 rows give the frozen
    agent's targets over the whole [3, 4] batch."""
    from reference.learning.ppo import PPOAgent
    blocked, whole = _agents(bench, 5)
    g = torch.Generator().manual_seed(8)
    t, b, d = 3, 4, blocked.env.obs_dim
    from reference.learning import normalizer as norm_lib
    norm = norm_lib.create(d, torch.ones(d), clip=10.0, sample_limit=1e8,
                           device="cpu")
    batch = {"next_obs": torch.randn((t, b, d), generator=g),
             "obs": torch.randn((t, b, d), generator=g),
             "reward": torch.rand((t, b), generator=g),
             "done": torch.zeros((t, b), dtype=torch.long),
             "rand_mask": torch.ones((t, b))}
    with torch.no_grad():
        got = blocked._targets(batch, norm)
        want = PPOAgent._targets(whole, batch, norm)
    assert "critic" not in vars(blocked.net)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y)


def test_rows_counted_over_the_window(bench):
    """Two iterations of the shrunk cell (4 steps of 8 envs, one
    minibatch of 32, 5 epochs): an iteration's rows are the 32 acts, the
    targets' two critic passes and the 5 minibatches; the grad rows the
    minibatches alone."""
    ctx = tiny(bench, "tracker.vit", trace=True)
    driver = core.driver_module(ctx)
    cell = driver.Cell(ctx)
    cell.setup()
    for _ in range(2):
        cell.step()
    cell.phases()
    w = cell.work()
    assert (w["vit_rows"], w["vit_grad_rows"]) == (32 + 64 + 160, 160)
    assert w["vit_forward_flops"] > 0 and w["vit_backward_flops"] > 0
    # a program without the counters (the parent of the change that added
    # them) gives the metric nothing to read
    assert driver.counters(torch.nn.Linear(1, 1)) is None


def _run(work, gaps=(), spans=()):
    """A run whose iteration takes 2 s in the measured window and whose
    traced iteration is busy 1 s of it."""
    from harness import trace
    tr = trace.Trace(window_s=3.0, busy_s=1.0, ops=[], gaps=list(gaps),
                     spans=[(n, 0.0, 1.0) for n in spans])
    return core.Run(None, "", 40.0, 20, 1.0, {}, {}, work, tr)


def test_vit_readers():
    mfu = core.metric_reader("vit.mfu")
    work = {"vit_rows": 1000.0, "vit_grad_rows": 400.0,
            "vit_forward_flops": 2e9, "vit_backward_flops": 4e9}
    flops = 1000 * 2e9 + 400 * 4e9
    assert mfu.read(_run(work)) == pytest.approx(100 * flops / 989e12 / 2.0)
    assert mfu.read(_run({})) is None
    idle = core.metric_reader("vit.idle_ms")
    gaps = [("parc.vit.encode", 0.3), ("parc.vit.tokenize", 0.1),
            ("parc.ppo.act", 0.2), ("update", 0.4)]
    assert idle.read(_run({}, gaps, ["parc.vit.tokenize",
                                     "parc.vit.encode"])) == pytest.approx(
        400.0)
    assert idle.read(_run({}, gaps[2:], ["parc.ppo.act"])) is None
