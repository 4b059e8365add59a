"""Each frozen reference agrees with the port's plain path on the CPU at a
tiny size, and nothing the benchmark imports is JAX or the JAX package; the
reference imports nothing of the port."""

import math
import subprocess
import sys
import time

import pytest
import torch

from conftest import HERE, tiny
from harness import core, traffic

CELLS = [w["name"] for w in core.load_json(core.ROOT / "BENCHMARK.json")
         ["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_sound_tiny_run_is_correct(bench, name):
    """The whole run at a tiny size on the CPU, where the program runs its
    plain path: every number compared is 0 to rounding."""
    res = core.measure(tiny(bench, name), 0.5, time.perf_counter())
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert all(c["value"] <= 1e-6 for c in res["checks"].values())
    assert list(res)[-1] == "checks"
    for m in core.end_to_end_metrics(bench, name):
        assert math.isfinite(res["metrics"][m["name"]]["value"])


def _clips():
    p = dict(core.load_json(HERE / "traffic" / "boxes.json"), clips=4)
    return traffic.make(p, 7)


def test_frozen_control_step_is_the_ports_plain_step():
    """One control step of 8 envs over the traffic's terrains: the port's
    plain version and the frozen copy agree bit for bit."""
    from parc_torch.anim import motion_data as pmd
    from parc_torch.anim import motion_lib as pml
    from parc_torch.data.humanoid import humanoid_spec as p_spec
    from parc_torch.physics import engine as peng
    from parc_torch.physics import substep as psub
    from parc_torch.utils import terrain as pterrain
    from reference.anim import motion_lib as rml
    from reference.data.humanoid import humanoid_spec as r_spec
    from reference.physics import engine as reng
    from reference.tracker import clip_data
    from reference.utils import terrain as rterrain
    clips = _clips()
    p_data = [pmd.MotionData(
        frames=c.frames, fps=c.fps, contacts=c.contacts,
        terrain=pmd.HostTerrain(hf=c.hf, min_point=c.min_point, dxdy=c.dxdy,
                                hf_maxmin=c.hf_maxmin)) for c in clips]
    sides = ((p_spec, pml, peng, pterrain, p_data,
              {"step_fn": psub.control_step_packed_reference}),
             (r_spec, rml, reng, rterrain, clip_data(clips), {}))
    outs = []
    for spec, ml, eng, tl, data, kw in sides:
        model = spec().build(device="cpu")
        lib = ml.build_motion_lib(model, data, device="cpu")
        ids = torch.arange(8) % 4
        fr = ml.calc_motion_frame(lib, ids, torch.linspace(0.0, 2.0, 8))
        st = eng.create_state(model, fr.root_pos, fr.root_rot, fr.joint_rot,
                              fr.root_vel, fr.root_ang_vel, fr.dof_vel,
                              device="cpu")
        act = 0.3 * torch.randn((8, model.dof_size),
                                generator=torch.Generator().manual_seed(3))
        terrain = tl.Terrain(hf=lib.terrain_hf,
                             hf_mask=torch.zeros_like(lib.terrain_hf,
                                                      dtype=torch.bool),
                             hf_maxmin=lib.terrain_maxmin,
                             min_point=lib.terrain_min_point,
                             dxdy=lib.terrain_dxdy)
        outs.append(eng.control_step(model, eng.SimParams(), terrain, st,
                                     act, terrain_idx=ids, **kw))
    for k in vars(outs[0]):
        assert torch.equal(getattr(outs[0], k), getattr(outs[1], k)), k


def test_frozen_denoiser_is_the_ports():
    from parc_torch.diffusion.transformer import MDMTransformer as P
    from reference.diffusion.transformer import MDMTransformer as R
    nets = [cls(frame_dim=91, d_model=64, num_heads=4, d_hid=64,
                num_layers=2, generator=torch.Generator().manual_seed(5))
            for cls in (P, R)]
    g = torch.Generator().manual_seed(6)
    x = torch.randn((3, 15, 91), generator=g)
    t = torch.tensor([1, 500, 1000])
    prev = torch.randn((3, 2, 91), generator=g)
    hf = torch.randn((3, 31, 31), generator=g)
    tgt = torch.randn((3, 2), generator=g)
    a, b = (n(x, t, prev, hf, tgt) for n in nets)
    assert torch.equal(a, b)


def test_imports_are_clean():
    """The reference pulls in no parc_torch; the harness, every driver and
    metric and the reference pull in no JAX and no JAX package."""
    ref = """
import sys
sys.path.insert(0, {here!r})
import reference.tracker, reference.mdm, reference.fp8
bad = {{m.split('.')[0] for m in sys.modules}} & {{'parc_torch', 'parc_tpu',
    'jax', 'jaxlib', 'flax', 'optax', 'orbax'}}
assert not bad, bad
"""
    everything = """
import sys, time
sys.path.insert(0, {here!r}); sys.path.insert(1, {root!r})
sys.path.insert(0, {here!r} + '/tests')
from harness import core
from conftest import tiny
bench = core.load_json(core.ROOT / 'BENCHMARK.json')
for w in bench['workloads']:
    core.measure(tiny(bench, w['name'], trace=True), 0.2, time.perf_counter())
for m in bench['per_layer']:
    core.metric_reader(m['name'])
import reference.fp8, harness.compare, harness.counts, harness.trace
assert not core.forbidden_modules(), core.forbidden_modules()
assert 'parc_torch' in sys.modules
"""
    for code in (ref, everything):
        out = subprocess.run(
            [sys.executable, "-c", code.format(here=str(HERE),
                                               root=str(HERE.parent))],
            capture_output=True, text=True, timeout=900)
        assert out.returncode == 0, out.stderr[-3000:]
