"""parc_torch.tools.fidelity (open-loop PD replay of the fidelity clip
set, the sweeps, the markdown table) against parc_tpu.tools.fidelity, on
the four synthetic clips cut with slice_motion to 13 frames (11 control
steps), under the default and the penalty_limits sweeps. The JAX package
replays through its XLA path on the CPU (``use_pallas=False``), the port
through the plain version of the control-step kernel.

The JAX replays compile at XLA's backend optimization level 0, as
tests/test_torch_diffusion.py::jit compiles its references, and the JAX
env's reset (which pd_replay calls eagerly, a few hundred ops each
compiled alone) runs jitted.

Tolerances (f32): failed flags and survival exact; mean rewards 2e-4
absolute and mean tracking errors 1e-3 absolute. A replay runs free for
11 control steps through contact switches (the platform clip's step
edge), so f32 rounding grows past the one-step tolerance of 2e-4
(tests/test_pallas.py:190-193): under penalty_limits the platform clip's
tracking error is 2.8e-4 and its reward 8.1e-5 apart, every other case
under 1.2e-5.
"""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from parc_tpu.anim import motion_edit as jme
from parc_tpu.data.humanoid import humanoid_spec as jspec
from parc_tpu.envs import deepmimic as jdm
from parc_tpu.tools import fidelity as jfid
from parc_torch.anim import motion_edit as tme
from parc_torch.data.humanoid import humanoid_spec as tspec
from parc_torch.physics import engine as te
from parc_torch.tools import fidelity as tfid
from test_torch_diffusion import jax_jit_opt0  # noqa: F401

torch.set_num_threads(1)

FRAMES = 13


def _clips():
    want = {k: jme.slice_motion(c, 0, FRAMES)
            for k, c in jfid.fidelity_clips(include_reference=False).items()}
    got = {k: tme.slice_motion(c, 0, FRAMES)
           for k, c in tfid.fidelity_clips(include_reference=False).items()}
    return got, want


def _same(got, want, what):
    assert [r.clip for r in got] == [r.clip for r in want]
    for g, w in zip(got, want):
        assert g.failed == w.failed, (what, w.clip)
        assert g.survival == w.survival, (what, w.clip)
        assert abs(g.mean_reward - w.mean_reward) <= 2e-4, (what, w.clip,
                                                            g.mean_reward,
                                                            w.mean_reward)
        np.testing.assert_allclose(g.tracking_error, w.tracking_error,
                                   rtol=0, atol=1e-3,
                                   err_msg=f"{what} {w.clip}")


def test_clip_set():
    got, want = _clips()
    assert list(got) == list(want) == ["stand", "walk", "platform",
                                       "gap_jump"]
    for k in got:
        np.testing.assert_array_equal(got[k].frames, want[k].frames)
        np.testing.assert_array_equal(got[k].contacts, want[k].contacts)
        np.testing.assert_array_equal(got[k].terrain.hf, want[k].terrain.hf)
    assert list(tfid.default_sweeps()) == list(jfid.default_sweeps())
    for name, p in tfid.default_sweeps().items():
        q = jfid.default_sweeps()[name]
        for f in dataclasses.fields(p):
            assert getattr(p, f.name) == getattr(q, f.name), (name, f.name)


@pytest.mark.parametrize("sweep", ["default", "penalty_limits"])
def test_pd_replay(sweep, monkeypatch, jax_jit_opt0):
    got_clips, want_clips = _clips()
    jparams = dataclasses.replace(jfid.default_sweeps()[sweep],
                                  use_pallas=False)
    reset = jdm.DeepMimicEnv.reset

    def jitted_reset(self, lib, rng, num_envs=None, motion_ids=None):
        return jax.jit(lambda l, r, i: reset(self, l, r, num_envs, i))(
            lib, rng, motion_ids)
    monkeypatch.setattr(jdm.DeepMimicEnv, "reset", jitted_reset)
    want = jfid.pd_replay(jspec().build(), jparams, want_clips)
    got = tfid.pd_replay(tspec().build(device="cpu"),
                         tfid.default_sweeps()[sweep], got_clips,
                         device="cpu")
    _same(got, want, sweep)
    # the markdown table of both
    assert tfid.format_markdown({sweep: got}).splitlines()[:2] == \
        jfid.format_markdown({sweep: want}).splitlines()[:2]


def test_copies_and_sweeps(monkeypatch):
    """pd_replay's copies replay each clip in several envs with the same
    result; run_sweeps runs every sweep (here two) on the clip set."""
    got_clips, _ = _clips()
    model = tspec().build(device="cpu")
    one = tfid.pd_replay(model, te.SimParams(), got_clips, device="cpu")
    three = tfid.pd_replay(model, te.SimParams(), got_clips, device="cpu",
                           copies=3)
    assert [r.clip for r in three] == [r.clip for r in one] * 3
    for i, r in enumerate(three):
        o = one[i % len(one)]
        assert (r.mean_reward, r.survival, r.failed) == (
            o.mean_reward, o.survival, o.failed)
        np.testing.assert_array_equal(r.tracking_error, o.tracking_error)
    monkeypatch.setattr(tfid, "fidelity_clips", lambda inc: got_clips)
    sweeps = {k: v for k, v in tfid.default_sweeps().items()
              if k in ("default", "friction_0.5")}
    res = tfid.run_sweeps(sweeps=sweeps, device="cpu",
                          include_reference=False)
    assert list(res) == list(sweeps)
    for r, o in zip(res["default"], one):
        assert r.mean_reward == o.mean_reward
