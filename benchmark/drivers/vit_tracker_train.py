"""Tracker training with PARC's transformer policy (DM_ViT):
``PPOAgent.train_iter`` over and over as drivers/tracker_train.py drives
it, with ``PPOConfig.actor_net`` ``dm_vit``, the net ``PPOAgent`` builds
itself (one bf16 trunk for the actor's mean and the critic's value).

It differs from the MLP tracker in four ways:

* the actor's own leaves, which the calibration's diagnostics read, are
  the mean head's (the trunk is shared with the critic);
* the set-up checks the built net's widths against the configuration's
  ``vit`` block, on both sides;
* its counts of work are the ViT's (harness/vit_counts), times the rows
  the program's own counters saw in the measured window;
* the reference is reference/vit_tracker.py, which computes the update's
  minibatches and the targets' critic passes in row blocks
  (``check.micro_rows``) so that float32 fits the card.

The policy is this driver's: it runs the ViT whatever ``actor_net`` a
shrunk copy of the configuration names (the tests' shrinker gives the MLP
cells small trunks; the ViT's widths are fixed by the program).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch

from harness import core, vit_counts

# a private copy of the MLP tracker's driver, whose recorders read the
# ViT's actor leaves
tracker = core.load_module(Path(__file__).with_name("tracker_train.py"),
                           "bench_driver_tracker_train_vit")


def actor_params(net) -> list:
    """The actor's own leaves: the mean head (the log-std is fixed)."""
    return [p for k, p in net.named_parameters()
            if k.startswith("mean_head")]


tracker.actor_params = actor_params
checks = tracker.checks
diagnostics = tracker.diagnostics


def widths(net) -> dict:
    """The built net's widths, under the keys of the configuration's
    ``vit`` block; the program's net and the reference's alike."""
    layer, convs = net.layers[0], list(net.tokenizer.conv)
    d = net.pos.shape[1]
    return {"d_model": d, "num_heads": layer.num_heads,
            "head_dim": d // layer.num_heads, "num_layers": len(net.layers),
            "d_hid": layer.dense_0.out_features,
            "conv_channels": [c.weight.shape[0] for c in convs],
            "conv_kernel": list(convs[0].weight.shape[2:]),
            "conv_strides": [list(c.stride) for c in convs],
            "tokens": net.pos.shape[0]}


def check_widths(net, vit: dict) -> None:
    got = widths(net)
    want = {k: vit[k] for k in got}
    if got != want:
        raise RuntimeError(f"the built ViT's widths {got} are not the "
                           f"configuration's {want}")


def counters(net):
    """The program's row counters, or None where it has none."""
    if not hasattr(net, "grad_rows"):
        return None
    return net.rows, net.grad_rows


class Cell(tracker.Cell):
    def __init__(self, ctx):
        c = ctx.config
        super().__init__(dataclasses.replace(
            ctx, config=dict(c, ppo=dict(c["ppo"], actor_net="dm_vit"))))
        self._window_steps = 0
        self._count = self._rows = None

    def _build(self):
        super()._build()
        check_widths(self.agent.net, self.ctx.config["vit"])

    def setup(self):
        super().setup()
        self._count = counters(self.agent.net)

    def step(self, traced: bool = False) -> float:
        if not traced:
            self._window_steps += 1
        return super().step(traced)

    def phases(self) -> dict:
        # the window has closed: the rows it took, an iteration
        now = counters(self.agent.net)
        self._rows = (None if now is None else
                      [(b - a) / self._window_steps
                       for a, b in zip(self._count, now)])
        return super().phases()

    def work(self) -> dict:
        if self._rows is None:
            return {}
        vit, layout = self.ctx.config["vit"], self.env.obs_layout
        segments = [s for n, s in zip(layout.names, layout.sizes)
                    if n != "hf_obs"]
        a = self.env.action_dim
        return {"vit_rows": self._rows[0], "vit_grad_rows": self._rows[1],
                "vit_forward_flops": vit_counts.forward_flops(vit, segments,
                                                              a),
                "vit_backward_flops": vit_counts.backward_flops(vit, segments,
                                                                a)}

    def reference(self, control: bool = False) -> dict:
        """The reference's readings over the same first iterations (with
        ``control``, the fp8 control's)."""
        from reference import vit_tracker as ref
        from reference.tracker import float32_exact
        ctx, w = self.ctx, self.ctx.workload
        with float32_exact():
            agent, lib, state = ref.build(
                self.clips, ctx.config["env"], ctx.config["sim"],
                ctx.config["ppo"], w["num_envs"], ctx.seed, ctx.device,
                w["check"]["micro_rows"], control=control)
            check_widths(agent.net, ctx.config["vit"])
            _, got = tracker.follow(agent, lib, state, w["check"]["steps"],
                                    agent.cfg, first_mean=True)
        return got


def fault_attention_scale():
    """The encoder's attention without the 1 / sqrt(head_dim) scale of its
    scores (the program's EncoderLayer._attention less that one
    division)."""
    from parc_torch.diffusion.transformer import EncoderLayer

    def make(orig):
        def _attention(self, x, generator):
            b, n, d = x.shape
            h = self.num_heads

            def heads(t):
                return t.reshape(b, n, h, d // h).transpose(1, 2)

            q, k, v = (heads(f(x)) for f in (self.query, self.key,
                                             self.value))
            w = torch.softmax((q @ k.transpose(-1, -2)).float(), dim=-1)
            return self.out((w @ v).transpose(1, 2).reshape(b, n, d))
        return _attention
    return tracker._patched(EncoderLayer, "_attention", make)


FAULTS = dict(tracker.FAULTS, attention_scale=fault_attention_scale)
EXTRA_FAULTS = tracker.EXTRA_FAULTS
