"""parc_torch.viewer.studio's Studio against parc_tpu.viewer.studio's, op
by op from the same clip and seed, on the CPU; the live sim session
against the JAX functions that the JAX studio's compiled chunk calls,
and ``track`` against the port's own record stage (tests/
test_torch_trainer.py holds that against JAX).

Tolerances:
- state(): as tests/test_torch_viewer.py holds the exported DATA (body
  positions 1e-4 + 2e-6, centre 1e-3 + 2e-6, the rest equal), with the
  title ``parc_torch studio``;
- the 7 procgen kinds, edit_cells, the 4 terrain filters and
  snap_discrete: equal heightfields (the generators draw from the same
  numpy Generator);
- astar: the same grid path; the world path within 1e-6;
- flip: equal frames and contacts (tests/test_torch_kin_gen.py); slice:
  equal; resample: 1e-4 (tests/test_torch_motion_edit.py); the contacts
  recomputed from geometry, set_contact and the stitch's match frames:
  equal; the stitched frames 1e-4 (the resampled clip, rigidly moved);
- optimize(iters=5): frames within 2 lr (tests/test_torch_motion_opt.py);
- the live sim's first chunk of 8 frames: SIM_TOL, from
  tests/test_torch_fidelity.py's 1e-3 on pd_replay (8 control steps of a
  3-layer policy through f32 physics on two stacks); contact flags equal;
- track: equal to record_motions on the same restored state.
"""

import http.client
import json
import threading
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from parc_tpu.anim import char_model as jcm
from parc_tpu.anim import motion_data as jmd
from parc_tpu.diffusion.mdm import MDM as JMDM
from parc_tpu.diffusion.mdm import MDMConfig as JCfg
from parc_tpu.diffusion.mdm import MDMState as JState
from parc_tpu.envs import base as jbase
from parc_tpu.envs import deepmimic as jdm
from parc_tpu.learning import normalizer as jnorm
from parc_tpu.learning import ppo as jppo
from parc_tpu.physics import engine as je
from parc_tpu.utils import rotation as jrot
from parc_tpu.viewer import studio as jstudio
from parc_torch import convert
from parc_torch.anim import motion_data as tmd
from parc_torch.anim import motion_lib as tml
from parc_torch.data import synthetic as tsyn
from parc_torch.diffusion import sampler as tsam
from parc_torch.pipeline import cli as tcli
from parc_torch.pipeline import record as trec
from parc_torch.procgen import mdm_path as tmp
from parc_torch.utils import checkpoint as tck
from parc_torch.viewer import studio as tstudio
from test_torch_diffusion import SCFG, _np, jax_jit_opt0, jit  # noqa: F401
from test_torch_trainer import _jax_lib
from test_torch_viewer import _jclip, assert_same_data, models  # noqa: F401

torch.set_num_threads(1)

SMALL = dict(actor_net="fc_2layers_512units",
             critic_net="fc_2layers_512units")
SIM_TOL = 1e-3
LR = 1e-3  # MotionOptConfig().lr in both packages


def _pair(models, clip, **kw):
    """A JAX and a port studio over copies of ``clip``."""
    jm, tm = models
    tclip = tmd.MotionData(
        frames=clip.frames.copy(), fps=clip.fps, loop_mode=clip.loop_mode,
        contacts=None if clip.contacts is None else clip.contacts.copy(),
        terrain=None if clip.terrain is None else tmd.HostTerrain(
            hf=clip.terrain.hf.copy(),
            min_point=clip.terrain.min_point.copy(),
            dxdy=clip.terrain.dxdy.copy()))
    return (jstudio.Studio(jm, _jclip(tclip), **kw),
            tstudio.Studio(tm, tclip, device="cpu", **kw))


def assert_same_state(got, want):
    assert got["title"] == "parc_torch studio"
    assert want["title"] == "parc_tpu studio"
    assert got["status"] == want["status"]
    assert_same_data({**got, "title": None}, {**want, "title": None})


def _same_terrain(js, ts):
    jt, tt = js.motion.terrain, ts.motion.terrain
    for f in ("hf", "hf_mask", "hf_maxmin", "min_point", "dxdy"):
        w, g = getattr(jt, f), getattr(tt, f)
        assert (w is None) == (g is None), f
        if w is not None:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=f)


def test_state_terrain_ops_match_jax(models):
    """state(), then the 7 procgen kinds, edit_cells, the 4 filters and
    snap_discrete in sequence, each leaving both studios the same
    heightfield."""
    js, ts = _pair(models, tsyn.walking_clip(seed=0), seed=3)
    assert_same_state(ts.state(), js.state())
    ops = [("procgen", dict(kind=k, x_dim=16, y_dim=16)) for k in (
        "flat", "boxes", "stairs", "paths", "perlin", "parkour", "cave")]
    ops += [("procgen", dict(kind="flat", x_dim=8, y_dim=8)),
            ("edit_cells", dict(cells=[[2, 3], [4, 4], [9, 9]], dh=0.5)),
            ("edit_cells", dict(cells=[[2, 3]], set_h=1.25)),
            ("procgen", dict(kind="boxes", x_dim=16, y_dim=16))]
    ops += [("terrain_filter", dict(kind=k)) for k in (
        "remove_sharp_lines", "flat_maxpool_2x2", "flat_maxpool_3x3",
        "downsample")]
    ops += [("procgen", dict(kind="flat", x_dim=20, y_dim=20)),
            ("snap_discrete", dict(heights=[-2.0, -1.0, 0.0, 1.0]))]
    for op, kw in ops:
        got, want = ts.handle(op, dict(kw)), js.handle(op, dict(kw))
        _same_terrain(js, ts)
        assert got["terrain"] == want["terrain"], (op, kw)
        assert got["status"] == want["status"]
    hf = ts.motion.terrain.hf
    assert (hf > -2.0).any() and (hf == -2.0).any()
    assert_same_state(ts.state(), js.state())
    for s, error in ((js, jstudio.StudioError), (ts, tstudio.StudioError)):
        with pytest.raises(error, match="unknown procgen kind"):
            s.handle("procgen", {"kind": "nope"})


def test_astar_matches_jax(models):
    """The walled terrain of tests/test_studio.py: the same grid path and
    world path, and a failed plan in both."""
    js, ts = _pair(models, tsyn.walking_clip(seed=0))
    for s in (js, ts):
        s.procgen(kind="flat", x_dim=12, y_dim=12)
        s.edit_cells(cells=[[6, j] for j in range(11)], set_h=3.0)
    got, want = ts.astar(start=[1, 1], end=[10, 10]), js.astar(
        start=[1, 1], end=[10, 10])
    np.testing.assert_array_equal(ts.path_grid, js.path_grid)
    np.testing.assert_allclose(ts.path_world, js.path_world, rtol=0,
                               atol=1e-6)
    assert_same_state(got, want)
    assert (ts.path_grid[:, 0] == 6).sum() >= 1  # through the gap
    for s in (js, ts):
        s.edit_cells(cells=[[6, 11]], set_h=3.0)
        s.astar(start=[1, 1], end=[10, 10], max_jump_dist=0.0)
        assert s.path_world is None and s.status == "A*: no path found"


def test_edit_ops_match_jax(models, tmp_path):
    """flip, slice, resample, recompute_contacts, set_contact, then a
    stitch onto a saved copy, in both studios."""
    js, ts = _pair(models, tsyn.walking_clip(seed=0))
    for s, name in ((js, "j"), (ts, "t")):
        (tmp_path / name).mkdir()
        s.workspace = str(tmp_path / name)

    def same(what, frames_tol=0.0):
        jm, tm = js.motion, ts.motion
        assert tm.fps == jm.fps, what
        np.testing.assert_allclose(tm.frames, np.asarray(jm.frames), rtol=0,
                                   atol=frames_tol, err_msg=what)
        assert (tm.contacts is None) == (jm.contacts is None), what
        if jm.contacts is not None:
            np.testing.assert_array_equal(tm.contacts,
                                          np.asarray(jm.contacts), what)
        _same_terrain(js, ts)

    for op, kw, tol in (("recompute_contacts", {}, 0.0),
                        ("flip", {}, 0.0),
                        ("slice", dict(start=5, end=65), 0.0),
                        ("resample", dict(fps=20.0), 1e-4),
                        ("recompute_contacts", dict(threshold=0.05), 1e-4),
                        ("set_contact", dict(frame=0, body=3, value=1.0),
                         1e-4)):
        got, want = ts.handle(op, kw), js.handle(op, kw)
        assert got["status"] == want["status"], op
        same(op, tol)
        assert_same_state(got, want)
    assert ts.motion.contacts[0, 3] == 1.0

    for s in (js, ts):
        s.save(path="b.npz")
        s.resample(fps=30.0)
    n = ts.motion.frames.shape[0]
    got = ts.handle("stitch", {"path": "b.npz",
                               "range_a": [n // 2, n // 2 + 6]})
    want = js.handle("stitch", {"path": "b.npz",
                                "range_a": [n // 2, n // 2 + 6]})
    assert got["status"].split(" (")[0] == want["status"].split(" (")[0]
    assert "stitched b.npz at A[" in got["status"]
    same("stitch", 1e-4)
    for s in (js, ts):
        with pytest.raises(ValueError, match="outside the studio workspace"):
            s.save(path="/etc/clip.npz")
        with pytest.raises(ValueError, match="bad arguments"):
            s.handle("save", {"bogus_arg": 1})


def test_optimize_and_accept_match_jax(models):
    """optimize(iters=5) against the JAX studio's, then accept_overlay.
    (The JAX optimizer compiles at XLA's default level here: at level 0 its
    Adam scan returns NaN frames on this input.)"""
    js, ts = _pair(models, tsyn.walking_clip(seed=1, n=40))
    for s in (js, ts):
        s.procgen(kind="boxes", x_dim=16, y_dim=16)
        s.recompute_contacts()
    got, want = ts.optimize(iters=5), js.optimize(iters=5)
    assert ts.overlay_label == js.overlay_label == "optimized"
    np.testing.assert_allclose(ts.overlay.frames, np.asarray(
        js.overlay.frames), rtol=0, atol=2 * LR)
    assert len(got["clips"]) == 2 and got["clips"][1]["label"] == "optimized"
    assert_same_data({**got, "title": None, "clips": got["clips"][:1]},
                     {**want, "title": None, "clips": want["clips"][:1]})
    optimized = ts.overlay
    s = ts.accept_overlay()
    assert ts.overlay is None and len(s["clips"]) == 1
    assert ts.motion is optimized
    with pytest.raises(tstudio.StudioError):
        ts.accept_overlay()


@pytest.fixture(scope="module")
def tracker(models, tmp_path_factory):
    """A JAX tracker state (small nets, a normalizer that has seen spread
    data, fail rates of three motions) carried into a port checkpoint:
    (JAX agent, its state, tracker_dir)."""
    jm, _ = models
    jenv = jdm.DeepMimicEnv(jm, je.SimParams(),
                            jbase.EnvConfig(num_envs=1, rand_reset=False))
    jagent = jppo.PPOAgent(jenv, jppo.PPOConfig(**SMALL))
    obs_dim = jenv.obs_dim
    params = jit(jagent.net.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, obs_dim)))
    rng = np.random.default_rng(2)
    spread = rng.normal(0.5, 2.0, (256, obs_dim)).astype(np.float32)
    mask = (~jenv.obs_layout.non_norm_mask()).astype(np.float32)
    jstate = jppo.AgentState(
        params=params, opt_state=jagent.tx.init(params),
        obs_norm=jnorm.update(jnorm.create(obs_dim, mask), spread),
        env_state=types.SimpleNamespace(
            fail_rates=jnp.asarray([0.3, 0.7, 0.5])),
        rng=jax.random.PRNGKey(0), sample_count=jnp.asarray(256.0))
    out = tmp_path_factory.mktemp("tracker")
    tck.save(str(out / "checkpoints"), 1, convert.persistent_from_numpy(
        _np(jppo.persistent_state(jstate))))
    return jagent, jstate, str(out)


def test_sim_session_matches_jax(models, tracker, jax_jit_opt0):
    """sim_start / sim_step from the carried-across tracker: the first
    chunk's frames and contact flags against the JAX studio's chunk
    (parc_tpu/viewer/studio.py:545-560) on the same state; then a second
    chunk (3 steps round up to 8), the stop and the StudioError paths."""
    jm, tm = models
    jagent, jstate, tracker_dir = tracker
    clip = tsyn.standing_clip()
    ts = tstudio.Studio(tm, clip, tracker_dir=tracker_dir,
                        tracker_config=SMALL, device="cpu")
    for op in ("sim_step", "sim_stop"):
        with pytest.raises(tstudio.StudioError):
            ts.handle(op, {})
    assert "live sim started (trained policy)" in ts.sim_start()["status"]
    s = ts.sim_step(steps=8)
    assert ts.overlay_label == "live sim" and s["status"] == \
        "live sim: 8 frames"
    got_f, got_c = ts.overlay.frames, ts.overlay.contacts

    jenv = jagent.env
    jlib = _jax_lib(tml.build_motion_lib(tm, [clip], device="cpu"))

    def chunk(lib, es):
        def step_fn(es, _):
            frame34 = jnp.concatenate([
                es.sim.root_pos, jrot.quat_to_exp_map(es.sim.root_rot),
                jcm.rot_to_dof(jm, es.sim.joint_rot)], axis=-1)
            contacts = (jnp.linalg.norm(es.sim.contact_forces, axis=-1)
                        > 1e-3).astype(jnp.float32)
            norm_obs = jnorm.normalize(jstate.obs_norm, es.obs)
            mean, _ = jagent.net.apply(jstate.params, norm_obs,
                                       method="actor")
            es = jenv.step(lib, es, jagent.a_mid + jagent.a_scale * mean)
            return es, (frame34, contacts)
        return jax.lax.scan(step_fn, es, None, length=8)[1]

    es = jit(lambda l, r: jenv.reset(l, r, num_envs=1))(
        jlib, jax.random.PRNGKey(0))
    want_f, want_c = (np.asarray(x[:, 0]) for x in jit(chunk)(jlib, es))
    assert got_f.shape == (8, 34) and got_c.shape == (8, 15)
    err = float(np.abs(got_f - want_f).max())
    print(f"live sim, first chunk: max abs frame error {err:.3e}")
    assert err <= SIM_TOL, err
    np.testing.assert_array_equal(got_c, want_c)
    assert got_c.any()  # the feet touch the ground

    s = ts.handle("sim_step", {"steps": 3})
    assert ts.overlay.frames.shape == (16, 34) and len(s["clips"]) == 2
    np.testing.assert_array_equal(ts.overlay.frames[:8], got_f)
    ts.handle("sim_stop", {})
    assert ts.overlay is not None
    with pytest.raises(tstudio.StudioError):
        ts.sim_stop()


def test_track_matches_record(models, tracker):
    """track(num_steps=8) on a 5-frame clip is the record stage's rollout
    from the same restored state, overlaid on the clip's terrain."""
    _, tm = models
    _, _, tracker_dir = tracker
    clip = tsyn.standing_clip(n=5)
    ts = tstudio.Studio(tm, clip, tracker_dir=tracker_dir,
                        tracker_config=SMALL, device="cpu")
    s = ts.track(num_steps=8)
    assert ts.overlay_label == "tracked" and ts.overlay.terrain is clip.terrain

    lib = tml.build_motion_lib(tm, [clip], device="cpu")
    env = tcli._tracking_env(tm, {}, "cpu", num_envs=1, rand_reset=False)
    agent, state = tcli._restored_agent(
        {"tracker_dir": tracker_dir, **SMALL}, lib, env, seed=0)
    assert state.env_state.fail_rates.tolist() == pytest.approx([0.3])
    want = trec.record_motions(agent, lib, state, trec.RecordConfig(
        start_fractions=(0.0,), max_steps=8))[0]
    assert s["status"] == (f"tracked {want.frames.shape[0]} frames "
                           "(trained policy)")
    np.testing.assert_array_equal(ts.overlay.frames, want.frames)
    np.testing.assert_array_equal(ts.overlay.contacts, want.contacts)


def test_mdm_gen_keeps_best_row(models, tmp_path, monkeypatch):
    """mdm_gen from a tiny MDM carried across from JAX: A* first, then the
    rollouts along the path, the best row of total_loss kept."""
    jm, tm = models
    tiny = dict(diffusion_timesteps=11, d_model=32, num_heads=2, d_hid=32,
                num_layers=1, dropout=0.0)
    clip = tsyn.walking_clip(seed=0)
    jmdm = JMDM(jm, JCfg(**tiny))
    params = jit(jmdm.net.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 15, 91)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, 2, 91)),
        jnp.zeros((1, 31, 31)), jnp.zeros((1, 2)))
    mean, std = tsam.compute_feature_stats_exact(
        tm, SCFG, tml.build_motion_lib(tm, [clip], device="cpu"))
    s0 = JState(params=params, ema_params=params,
                opt_state=jmdm.tx.init(params), mean=jnp.asarray(mean),
                std=jnp.asarray(std), rng=jax.random.PRNGKey(1),
                step=jnp.zeros((), jnp.int32))
    tck.save(str(tmp_path / "mdm" / "checkpoints"), 1,
             convert.mdm_state_from_numpy(_np(s0)))

    ts = tstudio.Studio(tm, clip, mdm_config=tiny, device="cpu",
                        mdm_dir=str(tmp_path / "mdm"))
    with pytest.raises(tstudio.StudioError, match="run A\\* first"):
        ts.mdm_gen()
    with pytest.raises(tstudio.StudioError, match="no MDM checkpoint"):
        tstudio.Studio(tm, clip, device="cpu").mdm_gen()
    ts.procgen(kind="flat", x_dim=12, y_dim=12)
    ts.astar(start=[2, 2], end=[9, 9])
    results = []
    gen = tmp.generate_frames_along_path
    monkeypatch.setattr(tmp, "generate_frames_along_path",
                        lambda *a, **k: results.append(gen(*a, **k))
                        or results[-1])
    s = ts.mdm_gen(batch_size=2, max_seconds=1.0, seed=4)
    assert s["status"].startswith("mdm_gen: kept best of 2 rollouts")
    (r,) = results
    best = int(np.argmin(r.total_loss))
    n = int(r.lengths[best])
    assert ts.motion.frames.shape == (n, 34)
    assert np.isfinite(ts.motion.frames).all()
    np.testing.assert_array_equal(ts.motion.frames, r.frames34[best, :n])
    np.testing.assert_array_equal(ts.motion.contacts, r.contacts[best, :n])
    assert ts.motion.terrain.hf.shape == (12, 12)


def test_http_server(models, tmp_path, monkeypatch):
    """The CLI's studio stage builds the studio it serves from its flags;
    then the server on port 0: the page, the state, a procgen, a 400 for a
    bad astar and for a path outside the workspace, and a 500 whose body
    names only the exception's class."""
    _, tm = models
    clip = tmp_path / "clip.npz"
    tmd.save_motion_data(str(clip), tsyn.walking_clip(seed=1))
    served = []
    monkeypatch.setattr(tstudio, "run_studio",
                        lambda st, **kw: served.append((st, kw)))
    tcli.main(["studio", "--input", str(clip), "--workspace", str(tmp_path),
               "--port", "0", "--host", "::1", "--tracker_dir", "T",
               "--mdm_dir", "M", "--device", "cpu"])
    (st, kw), = served
    assert kw == dict(port=0, host="::1", allow_remote=False)
    assert st.device == torch.device("cpu") and st.model.device == st.device
    assert (st.tracker_dir, st.mdm_dir) == ("T", "M")
    assert st.workspace == str(tmp_path.resolve())
    np.testing.assert_array_equal(st.motion.frames,
                                  tsyn.walking_clip(seed=1).frames)
    st = tstudio.Studio(tm, tsyn.walking_clip(seed=1), device="cpu",
                        workspace=str(tmp_path))
    with pytest.raises(ValueError, match="refusing non-local bind"):
        tstudio.make_server(st, port=0, host="0.0.0.0")
    server = tstudio.make_server(st, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = server.server_address
        conn = http.client.HTTPConnection(host, port, timeout=60)

        def post(op, body):
            conn.request("POST", f"/api/{op}", body=json.dumps(body),
                         headers={"Content-Type": "application/json"})
            r = conn.getresponse()
            return r.status, json.loads(r.read())

        conn.request("GET", "/")
        page = conn.getresponse().read().decode()
        assert "parc_torch studio" in page and "parc_tpu" not in page
        for marker in ("render()", "body_pos", "setInterval", "toggleLive"):
            assert marker in page
        conn.request("GET", "/api/state")
        state = json.loads(conn.getresponse().read())
        assert np.asarray(state["clips"][0]["body_pos"]).shape == (90, 15, 3)
        code, out = post("procgen", {"kind": "boxes", "x_dim": 8,
                                     "y_dim": 8})
        assert code == 200 and np.asarray(out["terrain"]["hf"]).shape == (
            8, 8)
        code, out = post("astar", {"start": [0, 0]})
        assert code == 400 and "bad arguments for astar" in out["error"]
        code, out = post("save", {"path": "../escape.npz"})
        assert code == 400 and "outside the studio workspace" in out["error"]
        assert not (tmp_path.parent / "escape.npz").exists()
        code, out = post("load", {"path": "missing.npz"})
        assert code == 500
        assert out == {"error": "internal error (FileNotFoundError); see "
                                "server log"}
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
