"""The port stands alone: no module of parc_torch, and not chip_smoke.py,
imports JAX, flax, optax, orbax or anything of parc_tpu (found by an AST
scan of every import statement, including ones inside functions), and a
fresh interpreter that imports every MDM and kin-gen module, the
data-parallel module and the tools and retargeting modules, trains an MDM
a step, samples from it, runs a tiny kin-gen with it, loads the quadruped
from its MJCF export, exports a BVH and an HTML viewer and builds the
studio's state has none of them loaded. The entry points that build a
character, run a tool, export a viewer or open a studio default to the
card: without CUDA they raise and name ``device='cpu'``."""

import ast
import pathlib
import subprocess
import sys
import textwrap

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "parc_tpu")
FILES = sorted(ROOT.glob("parc_torch/**/*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_files_found():
    assert len(FILES) > 30
    for module in ("physics/substep.py", "learning/ppo.py",
                   "learning/distributions.py", "learning/rl_util.py",
                   "learning/diagnostics.py", "utils/checkpoint.py",
                   "utils/logger.py", "utils/profiling.py",
                   "pipeline/cli.py", "pipeline/train_tracker.py",
                   "pipeline/record.py", "pipeline/dataset.py",
                   "diffusion/schedules.py", "diffusion/rot_changer.py",
                   "diffusion/sampler.py", "diffusion/transformer.py",
                   "diffusion/mdm.py", "diffusion/guidance.py",
                   "diffusion/gen.py", "pipeline/train_mdm.py",
                   "utils/terrain.py", "procgen/astar.py",
                   "procgen/mdm_path.py", "opt/motion_opt.py",
                   "anim/motion_edit.py", "anim/motion_data.py",
                   "pipeline/kin_gen.py", "pipeline/augment.py",
                   "parallel/__init__.py", "parallel/mesh.py",
                   "data/quadruped.py", "anim/char_model.py",
                   "tools/metrics.py", "tools/convert.py",
                   "tools/fidelity.py", "tools/validation.py",
                   "retarget/keypoint_ik.py", "retarget/urdf.py",
                   "utils/geom.py", "viewer/html_viewer.py",
                   "viewer/render.py", "viewer/studio.py",
                   "viewer/studio_page.py"):
        assert (ROOT / "parc_torch" / module) in FILES, module


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_parc_tpu_import(path):
    bad = sorted({r for r in _imported_roots(path) if r in FORBIDDEN})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_no_forbidden_module_after_an_mdm_runs():
    script = textwrap.dedent("""
        import sys
        import torch
        import parc_torch.diffusion.gen, parc_torch.diffusion.guidance
        import parc_torch.diffusion.rot_changer, parc_torch.pipeline.cli
        import parc_torch.pipeline.train_mdm, parc_torch.convert
        from parc_torch.anim import motion_lib as ml
        from parc_torch.data import synthetic
        from parc_torch.data.humanoid import humanoid_spec
        from parc_torch.diffusion import sampler
        from parc_torch.diffusion.mdm import MDM, MDMConfig
        torch.set_num_threads(1)
        model = humanoid_spec().build(device="cpu")
        lib = ml.build_motion_lib(model, [synthetic.standing_clip(n=30)],
                                  device="cpu")
        mdm = MDM(model, MDMConfig(diffusion_timesteps=11, batch_size=2,
                                   d_model=16, num_heads=2, d_hid=16,
                                   num_layers=1), device="cpu")
        g = torch.Generator().manual_seed(0)
        state, _ = mdm.train_step(lib, mdm.init(lib, g, stats_samples=8))
        b = sampler.sample_batch(model, mdm.scfg, lib, g, 2)
        mdm.ddim_sample(state, g, b.prev_states, b.hf, b.target_dir)
        import tempfile
        from parc_torch.opt import motion_opt
        from parc_torch.pipeline import augment, kin_gen
        from parc_torch.procgen import mdm_path
        cfg = kin_gen.KinGenConfig(
            num_rollouts=2, top_k=1, terrain_dim=8,
            max_contact_loss=1e9, max_pen_loss=1e9, max_total_loss=1e9,
            opt_cfg=motion_opt.MotionOptConfig(iters=2),
            path_cfg=mdm_path.PathGenSettings(max_seconds=0.5))
        assert kin_gen.run_kin_gen(mdm, state, 1, tempfile.mkdtemp(), cfg)
        import os
        from parc_torch.anim import char_model
        from parc_torch.data.quadruped import quadruped_spec
        from parc_torch.parallel import mesh
        assert mesh.check_param_sync(state.net.parameters(), None) == 0.0
        path = os.path.join(tempfile.mkdtemp(), "quadruped.xml")
        with open(path, "w") as f:
            f.write(char_model.export_mjcf(quadruped_spec()))
        assert char_model.load_char_file(path, device="cpu").dof_size == 12
        import parc_torch.tools.fidelity, parc_torch.tools.validation
        import parc_torch.retarget.urdf
        from parc_torch.tools import convert
        from parc_torch.data.synthetic import walking_clip
        convert.motion_to_bvh(model, walking_clip(n=5),
                              os.path.join(tempfile.mkdtemp(), "w.bvh"))
        import parc_torch.viewer.render, parc_torch.viewer.studio_page
        from parc_torch.viewer import html_viewer, studio
        html_viewer.export(model, walking_clip(n=5),
                           os.path.join(tempfile.mkdtemp(), "w.html"),
                           device="cpu")
        studio.Studio(model, walking_clip(n=5), device="cpu").state()
        print(sorted({m.split(".")[0] for m in sys.modules}))
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert "parc_torch" in loaded
    assert not loaded & set(FORBIDDEN), sorted(loaded & set(FORBIDDEN))


def test_entry_points_default_to_the_card(tmp_path):
    """Without CUDA, building a character, loading one, running the
    fidelity sweeps, retargeting, exporting a viewer or opening a studio
    with the default device raises and says how to run on the CPU."""
    import numpy as np
    import torch

    from parc_torch.anim import char_model
    from parc_torch.data.humanoid import humanoid_spec
    from parc_torch.retarget import keypoint_ik, urdf
    from parc_torch.data.synthetic import walking_clip
    from parc_torch.tools import fidelity
    from parc_torch.viewer import html_viewer, studio
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the defaults run")
    path = tmp_path / "h.xml"
    path.write_text(char_model.export_mjcf(humanoid_spec()))
    model = humanoid_spec().build(device="cpu")
    robot = urdf.parse_urdf("""<robot name="r"><link name="a"/><link
        name="b"/><joint name="j" type="revolute"><parent link="a"/><child
        link="b"/></joint></robot>""")
    for call in (lambda: humanoid_spec().build(),
                 lambda: char_model.build_char_model(humanoid_spec()),
                 lambda: char_model.load_char_file(str(path)),
                 lambda: fidelity.run_sweeps(include_reference=False),
                 lambda: keypoint_ik.retarget_keypoints(
                     model, np.zeros((3, 24, 3), np.float32)),
                 lambda: urdf.retarget_keypoints_to_robot(
                     robot, np.zeros((3, 24, 3), np.float32)),
                 lambda: studio.Studio(),
                 lambda: studio.Studio(model),
                 lambda: html_viewer.export(model, walking_clip(n=5),
                                            str(tmp_path / "w.html"))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
