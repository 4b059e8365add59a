"""parc_torch.tools (motion metrics, dataset statistics, guidance limits,
the CLI's metrics stage, BVH and keypoint export, clip inspection, MDM
validation) against parc_tpu.tools, on the same clips.

Tolerances (f32):
- motion metrics and dataset statistics: 1e-4 relative per value (FK in
  float32; jerk is a third difference scaled by fps^3); the motion
  length, the jerk-frame counts and a tagged body without contact points
  (inf in both) exact;
- the metrics stage's CSV: the same rows, values 1e-4 relative;
- BVH text: every line equal, numbers to within 2e-4 (printed with 4
  decimals; euler angles in degrees from float32 quaternions);
- exported keypoints: 1e-5 absolute; inspect output: equal;
- run_validation on one fixture (the small MDM of
  tests/test_torch_kin_gen.py, the JAX key's draws handed to the port):
  rollout order, fixture names, motion lengths and the
  frames-over-threshold counts equal; contact and penetration losses and
  the final-node distance within 1e-4 of the largest value; jerk terms
  1e-4 relative (measured 9.3e-7: the generated frames agree to about
  1e-7 here, though a third difference at 30 fps multiplies a frame's
  error by up to 8 x 27,000).
"""

import csv
import dataclasses
import io

import numpy as np
import jax
import pytest
import torch

from parc_tpu.anim import motion_data as jmd
from parc_tpu.data import synthetic as jsyn
from parc_tpu.data.humanoid import humanoid_spec as jspec
from parc_tpu.pipeline import cli as jcli
from parc_tpu.tools import convert as jconv
from parc_tpu.tools import metrics as jmet
from parc_tpu.tools import validation as jval
from parc_torch.anim import motion_data as tmd
from parc_torch.data.humanoid import humanoid_spec as tspec
from parc_torch.pipeline import cli
from parc_torch.procgen import mdm_path as tmp
from parc_torch.tools import convert as tconv
from parc_torch.tools import metrics as tmet
from parc_torch.tools import validation as tval
from test_torch_kin_gen import B, PATH, _terrains, jax_draws
from test_torch_kin_gen import setup  # noqa: F401  (the MDMs' fixture)

torch.set_num_threads(1)

REL = 1e-4


@pytest.fixture(scope="module")
def models():
    return jspec().build(), tspec().build(device="cpu")


def _clips():
    walk = jsyn.walking_clip(seed=1, n=40)
    plat = jsyn.platform_clip(n=40)
    bare = dataclasses.replace(jsyn.walking_clip(seed=2, n=40),
                               terrain=None)
    return {"walk": walk, "platform": plat, "bare": bare}


def _port_clip(c):
    t = None if c.terrain is None else tmd.HostTerrain(
        hf=c.terrain.hf, min_point=c.terrain.min_point, dxdy=c.terrain.dxdy)
    return tmd.MotionData(frames=c.frames, fps=c.fps, contacts=c.contacts,
                          terrain=t)


def _rel(got, want, rel=REL, what=""):
    for k, w in want.items():
        g = got[k]
        if w is None or not np.isfinite(w):
            assert g == w, (what, k, g, w)
        else:
            assert abs(g - w) <= rel * max(abs(w), 1e-6), (what, k, g, w)


def test_motion_metrics(models):
    jm, tm = models
    node = np.asarray([2.0, 0.3, 0.0], np.float32)
    for name, c in _clips().items():
        want = jmet.compute_motion_metrics(jm, c, final_node_xyz=node)
        got = tmet.compute_motion_metrics(tm, _port_clip(c),
                                          final_node_xyz=node)
        assert got.motion_length == want.motion_length
        assert got.frames_with_jerk_over == want.frames_with_jerk_over
        _rel(got.as_dict(), want.as_dict(), what=name)
        low = tmet.compute_motion_metrics(tm, _port_clip(c),
                                          jerk_threshold=50.0)
        assert low.frames_with_jerk_over == jmet.compute_motion_metrics(
            jm, c, jerk_threshold=50.0).frames_with_jerk_over > 0
    # body 2 without contact points: its per-body minimum is inf, so a
    # frame tagging it in contact makes the contact loss inf in both
    keep = np.asarray(jm.contact_point_body) != 2
    jm2 = jm.replace(contact_point_body=jm.contact_point_body[keep],
                     contact_point_offset=jm.contact_point_offset[keep],
                     contact_point_radius=jm.contact_point_radius[keep])
    tkeep = torch.as_tensor(keep)
    tm2 = tm.replace(contact_point_body=tm.contact_point_body[tkeep],
                     contact_point_offset=tm.contact_point_offset[tkeep],
                     contact_point_radius=tm.contact_point_radius[tkeep])
    c = _clips()["walk"]
    for tag in (0.0, 1.0):
        contacts = c.contacts.copy()
        contacts[5, 2] = tag
        c2 = dataclasses.replace(c, contacts=contacts)
        want = jmet.compute_motion_metrics(jm2, c2)
        got = tmet.compute_motion_metrics(tm2, _port_clip(c2))
        assert np.isinf(want.contact_loss) == bool(tag)
        _rel(got.as_dict(), want.as_dict(), what=f"tag {tag}")


def test_dataset_statistics_and_guidance(models):
    jm, tm = models
    clips = list(_clips().values())
    want = jmet.dataset_statistics(jm, clips)
    got = tmet.dataset_statistics(tm, [_port_clip(c) for c in clips])
    assert set(got) == set(want)
    _rel(got, want, what="statistics")
    gw, gg = (jmet.guidance_params_from_stats(want),
              tmet.guidance_params_from_stats(want))
    for f in dataclasses.fields(gg):
        assert getattr(gg, f.name) == getattr(gw, f.name), f.name


def test_metrics_stage_csv(models, tmp_path):
    jm, tm = models
    d = tmp_path / "clips"
    d.mkdir()
    for name, c in _clips().items():
        if c.terrain is not None:
            tmd.save_motion_data(str(d / f"{name}.npz"), _port_clip(c))
    rows, stats = cli.main(["metrics", "--motions_dir", str(d), "--out",
                            str(tmp_path / "t.csv"), "--device", "cpu"])
    jcli.stage_metrics({"motions_dir": str(d),
                        "out": str(tmp_path / "j.csv")})
    with open(tmp_path / "t.csv") as f:
        got = list(csv.DictReader(f))
    with open(tmp_path / "j.csv") as f:
        want = list(csv.DictReader(f))
    assert [r["file"] for r in got] == [r["file"] for r in want] \
        == [r["file"] for r in rows] == ["platform.npz", "walk.npz"]
    for g, w in zip(got, want):
        _rel({k: float(v) for k, v in g.items() if k != "file" and v},
             {k: float(v) for k, v in w.items() if k != "file" and v},
             what=w["file"])
    _rel(stats, jmet.dataset_statistics(
        jm, [jmd.load_motion_data(str(d / r["file"])) for r in want]))


def _same_text(got: str, want: str, tol: float):
    gl, wl = got.splitlines(), want.splitlines()
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        gt, wt = g.split(), w.split()
        assert len(gt) == len(wt), (g, w)
        for a, b in zip(gt, wt):
            if a != b:
                assert abs(float(a) - float(b)) <= tol, (g, w)


def test_bvh_export(models, tmp_path):
    jm, tm = models
    for name, c in _clips().items():
        jconv.motion_to_bvh(jm, c, str(tmp_path / f"{name}_j.bvh"))
        tconv.motion_to_bvh(tm, _port_clip(c), str(tmp_path / f"{name}.bvh"))
        _same_text((tmp_path / f"{name}.bvh").read_text(),
                   (tmp_path / f"{name}_j.bvh").read_text(), 2e-4)


def test_keypoints_inspect_and_main(models, tmp_path, capsys):
    jm, tm = models
    c = _clips()["walk"]
    want = jconv.motion_to_keypoints(jm, c, str(tmp_path / "j.npz"))
    got = tconv.motion_to_keypoints(tm, _port_clip(c),
                                    str(tmp_path / "t.npz"))
    assert got["names"] == want["names"]
    np.testing.assert_allclose(got["keypoints"], want["keypoints"], rtol=0,
                               atol=1e-5)
    gz, wz = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    assert sorted(gz.files) == sorted(wz.files)
    for k in ("names", "fps", "smpl_joint_names"):
        np.testing.assert_array_equal(gz[k], wz[k])
    path = str(tmp_path / "clip.npz")
    tmd.save_motion_data(path, _port_clip(c))
    gbuf, wbuf = io.StringIO(), io.StringIO()
    assert tconv.inspect_motion(path, gbuf) == jconv.inspect_motion(path,
                                                                    wbuf)
    assert gbuf.getvalue() == wbuf.getvalue()
    tconv.main(["bvh", path, "--output", str(tmp_path / "m.bvh"),
                "--device", "cpu"])
    tconv.main(["keypoints", path, "--device", "cpu"])
    tconv.main(["inspect", path])
    out = capsys.readouterr().out
    assert out.count("wrote") == 2
    jconv.motion_to_bvh(jm, c, str(tmp_path / "m_j.bvh"))
    _same_text((tmp_path / "m.bvh").read_text(),
               (tmp_path / "m_j.bvh").read_text(), 2e-4)
    assert (tmp_path / "clip_keypoints.npz").exists()


def test_run_validation(setup, tmp_path):
    """One fixture (kin-gen's 20 x 20 box terrain and its A* path), top 2
    of B rollouts, seed 3: the JAX package's PRNGKey(3) draws."""
    jmdm, tmdm, s0, ts = (setup[k] for k in ("jmdm", "tmdm", "s0", "ts"))
    jt, tt = _terrains(setup["hfs"][1])
    nodes = setup["paths"][1]
    want = jval.run_validation(
        jmdm, s0, [jval.ValidationFixture("boxes", jt, nodes)],
        output_dir=str(tmp_path / "j"), seed=3, path_cfg=PATH, top_k=2)
    draws = [jax_draws(jax.random.PRNGKey(3), (), (B, 15, 91),
                       tmp.max_windows(tmdm, PATH))]
    got = tval.run_validation(
        tmdm, ts, [tval.ValidationFixture("boxes", tt, nodes)],
        output_dir=str(tmp_path / "t"), seed=3, path_cfg=PATH, top_k=2,
        draws=draws)
    assert len(got) == len(want) == 2
    scale = max(max(abs(r[k]) for r in want)
                for k in ("contact_loss", "pen_loss", "final_node_dist"))
    for g, w in zip(got, want):
        for k in ("fixture", "rollout", "motion_length"):
            assert g[k] == w[k], k
        for k in ("contact_loss", "pen_loss", "final_node_dist"):
            assert abs(g[k] - w[k]) <= 1e-4 * scale, (k, g[k], w[k])
        for k in ("mean_jerk", "max_jerk"):
            assert abs(g[k] - w[k]) <= 1e-4 * abs(w[k]), (k, g[k], w[k])
        assert g["frames_with_jerk_over"] == w["frames_with_jerk_over"]
        saved = tmd.load_motion_data(
            str(tmp_path / "t" / f"boxes_{g['rollout']:03d}.npz"))
        again = tmet.compute_motion_metrics(
            tmdm.model, saved, final_node_xyz=nodes[-1]).as_dict()
        assert again == {k: g[k] for k in again}
    summary = tval.summarize(got)
    _rel(summary, {k: v for k, v in jval.summarize(got).items()},
         rel=1e-12, what="summarize")
