"""parc_torch.viewer's HTML export, its matplotlib stills and the CLI's
``view`` stage against parc_tpu.viewer's, on the same clips.

Tolerances: the exported page's DATA equal but for the body positions,
within 1e-4 + 2e-6 (both round f32 FK to 4 decimals, and f32 FK agrees
at 1e-5, tests/test_torch_char_model.py, so a value can land one
rounding step apart) and the centre, within 1e-3 + 2e-6 (their mean,
rounded to 3 decimals); the page outside DATA is the JAX page with
``parc_tpu`` replaced by ``parc_torch``. The body positions under the
stills: 1e-5, as tests/test_torch_char_model.py holds FK.
"""

import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from parc_tpu.anim import motion_data as jmd
from parc_tpu.data.humanoid import humanoid_spec as jspec
from parc_tpu.pipeline import cli as jcli
from parc_tpu.viewer import html_viewer as jhv
from parc_tpu.viewer import render as jrender
from parc_torch.anim import motion_data as tmd
from parc_torch.data import synthetic as tsyn
from parc_torch.data.humanoid import humanoid_spec as tspec
from parc_torch.pipeline import cli as tcli
from parc_torch.viewer import html_viewer as thv
from parc_torch.viewer import render as trender

torch.set_num_threads(1)

BODY_TOL = 1e-4 + 2e-6
CENTER_TOL = 1e-3 + 2e-6
DATA_RE = re.compile(r"const DATA = (.*?);\n", re.S)


@pytest.fixture(scope="module")
def models():
    return jspec().build(), tspec().build(device="cpu")


def _clips():
    """Two walks of different lengths, the first on a box terrain with
    contact flags."""
    a = tsyn.walking_clip(seed=0)
    b = tsyn.walking_clip(seed=1, n=60)
    rng = np.random.default_rng(3)
    hf = np.round(rng.uniform(0.0, 0.6, (16, 12)), 2).astype(np.float32)
    a.terrain = tmd.HostTerrain(hf=hf, min_point=np.asarray([-3.0, -2.4],
                                                            np.float32),
                                dxdy=np.asarray([0.4, 0.4], np.float32))
    a.contacts = (rng.random((a.frames.shape[0], 15)) > 0.7).astype(
        np.float32)
    return a, b


def _jclip(clip):
    """The JAX package's MotionData holding the same arrays."""
    t = clip.terrain
    return jmd.MotionData(
        frames=clip.frames, fps=clip.fps, loop_mode=clip.loop_mode,
        contacts=clip.contacts,
        terrain=None if t is None else jmd.HostTerrain(
            hf=t.hf, min_point=t.min_point, dxdy=t.dxdy))


def _page(path):
    """(DATA, the page with DATA cut out) of an exported HTML file."""
    html = open(path).read()
    m = DATA_RE.search(html)
    return json.loads(m.group(1)), html[:m.start(1)] + html[m.end(1):]


def assert_same_data(got, want):
    """DATA of the port's page against the JAX page's."""
    assert set(got) == set(want)
    for k in ("title", "fps", "parents", "terrain", "path"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["center"], want["center"], rtol=0,
                               atol=CENTER_TOL)
    assert len(got["clips"]) == len(want["clips"])
    for g, w in zip(got["clips"], want["clips"]):
        assert set(g) == set(w)
        for k in ("label", "color", "contacts"):
            assert g[k] == w[k], k
        np.testing.assert_allclose(np.asarray(g["body_pos"]),
                                   np.asarray(w["body_pos"]), rtol=0,
                                   atol=BODY_TOL)


def test_export_compare_matches_jax(models, tmp_path):
    """Two clips with a terrain and a path through export_compare in both
    stacks: the same DATA and the same page around it."""
    jm, tm = models
    a, b = _clips()
    nodes = np.asarray([[-2.0, -1.5, 0.1], [0.4, 0.3, 0.25],
                        [2.2, 1.9, 0.5]], np.float32)
    kw = dict(labels=["reference", "recorded"], path_nodes=nodes,
              title="compare")
    jhv.export_compare(jm, [_jclip(a), _jclip(b)], str(tmp_path / "j.html"),
                       **kw)
    thv.export_compare(tm, [a, b], str(tmp_path / "t.html"), device="cpu",
                       **kw)
    got, got_page = _page(tmp_path / "t.html")
    want, want_page = _page(tmp_path / "j.html")
    assert_same_data(got, want)
    assert len(got["clips"][1]["body_pos"]) == 60
    assert got["terrain"] is not None and got["path"] is not None
    assert "parc_tpu" not in got_page
    assert got_page == want_page.replace("parc_tpu", "parc_torch")

    # one clip: export is export_compare under the label "motion"
    jhv.export(jm, _jclip(b), str(tmp_path / "j1.html"))
    thv.export(tm, b, str(tmp_path / "t1.html"), device="cpu")
    assert_same_data(_page(tmp_path / "t1.html")[0],
                     _page(tmp_path / "j1.html")[0])


def test_body_positions_match_jax(models):
    jm, tm = models
    frames = np.asarray(_clips()[0].frames, np.float32)
    got = trender._body_positions(tm, frames)
    assert isinstance(got, np.ndarray) and got.shape == (90, 15, 3)
    np.testing.assert_allclose(got, jrender._body_positions(jm, frames),
                               rtol=0, atol=1e-5)


def test_renders_write_pngs(models, tmp_path):
    _, tm = models
    a = _clips()[0]
    nodes = np.asarray([[-3, -3, 0], [3, 3, 0]], np.float32)
    trender.render_motion_strip(tm, a, str(tmp_path / "s.png"),
                                path_nodes=nodes, device="cpu")
    trender.render_pose_3d(tm, a, 10, str(tmp_path / "p.png"), device="cpu")
    for name in ("s.png", "p.png"):
        assert (tmp_path / name).stat().st_size > 5000, name


def _write_pair(tmp_path):
    a, b = _clips()
    pa, pb = str(tmp_path / "ref.npz"), str(tmp_path / "rec.npz")
    tmd.save_motion_data(pa, a)
    tmd.save_motion_data(pb, b)
    return pa, pb


def test_cli_view_compare_matches_jax(tmp_path, capsys):
    """``view --compare --device cpu`` writes the page and the strip, and
    its DATA matches the JAX stage's."""
    pa, pb = _write_pair(tmp_path)
    jout, tout = str(tmp_path / "j.html"), str(tmp_path / "t.html")
    jcli.stage_view({"input": pa, "compare": pb, "out": jout})
    written = tcli.main(["view", "--input", pa, "--compare", pb, "--out",
                         tout, "--device", "cpu"])
    assert written == [tout, str(tmp_path / "t.png")]
    assert os.path.getsize(tmp_path / "t.png") > 5000
    assert f"wrote {tout} (+ .png strip)" in capsys.readouterr().out
    got, want = _page(tout)[0], _page(jout)[0]
    assert [c["label"] for c in got["clips"]] == ["ref.npz", "rec.npz"]
    assert_same_data(got, want)


def test_cli_view_without_matplotlib(tmp_path, monkeypatch, capsys):
    """Where matplotlib cannot be imported, ``view`` still writes the page,
    draws no strip and says so."""
    pa, _ = _write_pair(tmp_path)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    written = tcli.main(["view", "--input", pa, "--device", "cpu"])
    out = str(tmp_path / "ref.html")
    assert written == [out]
    assert not (tmp_path / "ref.png").exists()
    assert (f"wrote {out} (no .png strip: matplotlib is not installed)"
            in capsys.readouterr().out)
    data = _page(out)[0]
    assert [c["label"] for c in data["clips"]] == ["motion"]
    assert data["title"] == "ref.npz"
