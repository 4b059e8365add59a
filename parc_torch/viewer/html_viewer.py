"""Self-contained HTML motion viewer (MOTION_FORGE's viewing core).

The reference ships a ~5.7k-LoC Polyscope/imgui desktop app (MOTION_FORGE/)
for inspecting terrains, paths, and motions. A GPU server has no GL stack
and no display, so this exports a single offline HTML file with an
embedded software renderer (vanilla JS + canvas, no network, no
dependencies): orbit camera, play/pause/scrub, terrain heightfield,
skeleton with contact highlighting, and the A* path if given.

The skeleton's body positions come from forward kinematics on ``device``
(the card unless the caller asks for the CPU), one host copy per clip.

Usage:
    from parc_torch.viewer import html_viewer
    html_viewer.export(model, motion, "out.html", path_nodes=nodes)
"""

from __future__ import annotations

import json
from typing import Optional, Sequence

import numpy as np
import torch

from parc_torch import resolve_device
from parc_torch.anim import char_model as cm
from parc_torch.anim import motion_data as md
from parc_torch.utils import rotation as rot


_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>parc_torch viewer</title>
<style>
 body { margin:0; background:#16161d; color:#ddd;
        font:13px system-ui, sans-serif; }
 #hud { position:fixed; top:8px; left:8px; user-select:none; }
 #bar { position:fixed; bottom:8px; left:8px; right:8px; display:flex;
        gap:8px; align-items:center; }
 #scrub { flex:1; }
 button { background:#333; color:#ddd; border:1px solid #555;
          border-radius:4px; padding:2px 10px; }
</style></head><body>
<canvas id="c"></canvas>
<div id="hud"></div>
<div id="bar"><button id="play">pause</button>
<input type="range" id="scrub" min="0" value="0" step="1">
<span id="t"></span></div>
<script>
const DATA = __DATA__;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let W, H; function resize(){ W=cv.width=innerWidth; H=cv.height=innerHeight; }
resize(); addEventListener('resize', resize);
const T = Math.max(...DATA.clips.map(c=>c.body_pos.length)),
      NB = DATA.clips[0].body_pos[0].length;
const hf = DATA.terrain ? DATA.terrain.hf : null;
let yaw = 0.8, pitch = 0.5, dist = 9, target = DATA.center.slice();
let frame = 0, playing = true;
const scrub = document.getElementById('scrub'); scrub.max = T-1;
document.getElementById('play').onclick = e => {
  playing = !playing; e.target.textContent = playing ? 'pause' : 'play'; };
scrub.oninput = e => { frame = +e.target.value; playing = false;
  document.getElementById('play').textContent = 'play'; };
let drag = null;
cv.onmousedown = e => drag = [e.clientX, e.clientY];
addEventListener('mouseup', () => drag = null);
addEventListener('mousemove', e => { if (!drag) return;
  yaw -= (e.clientX-drag[0])*0.008; pitch += (e.clientY-drag[1])*0.008;
  pitch = Math.max(0.05, Math.min(1.5, pitch)); drag = [e.clientX,e.clientY];});
cv.onwheel = e => { dist *= Math.exp(e.deltaY*0.001); e.preventDefault(); };
function proj(p) {
  const cy=Math.cos(yaw), sy=Math.sin(yaw), cp=Math.cos(pitch),
        sp=Math.sin(pitch);
  let x=p[0]-target[0], y=p[1]-target[1], z=p[2]-target[2];
  let x1 = cy*x + sy*y, y1 = -sy*x + cy*y;           // yaw about z
  let y2 = cp*y1 - sp*z, z2 = sp*y1 + cp*z;          // pitch
  const d = y2 + dist;
  if (d < 0.1) return null;
  const f = 0.9*Math.min(W,H)/d;
  return [W/2 + f*x1, H/2 - f*z2, d];
}
function quad(a,b,c,d2,fill,stroke) {
  const pts=[a,b,c,d2].map(proj); if (pts.some(p=>!p)) return null;
  return {z:(pts[0][2]+pts[2][2])/2, draw(){
    ctx.beginPath(); ctx.moveTo(pts[0][0],pts[0][1]);
    for (let i=1;i<4;i++) ctx.lineTo(pts[i][0],pts[i][1]);
    ctx.closePath(); ctx.fillStyle=fill; ctx.fill();
    if (stroke){ctx.strokeStyle=stroke; ctx.stroke();} }};
}
function render() {
  ctx.fillStyle = '#16161d'; ctx.fillRect(0,0,W,H);
  const items = [];
  if (hf) {
    const [mx,my]=DATA.terrain.min_point, [dx,dy]=DATA.terrain.dxdy;
    const hmin=DATA.terrain.hmin, hspan=Math.max(DATA.terrain.hmax-hmin,1e-3);
    for (let i=0;i<hf.length;i++) for (let j=0;j<hf[0].length;j++) {
      const z=hf[i][j], x=mx+i*dx, y=my+j*dy;
      const s = 30+110*(z-hmin)/hspan;
      const q = quad([x-dx/2,y-dy/2,z],[x+dx/2,y-dy/2,z],
                     [x+dx/2,y+dy/2,z],[x-dx/2,y+dy/2,z],
                     `rgb(${s*0.5},${s*0.75},${s})`, '#0003');
      if (q) items.push(q);
    }
  }
  if (DATA.path) {
    const pts = DATA.path.map(proj).filter(p=>p);
    items.push({z:0.01, draw(){ ctx.beginPath(); ctx.strokeStyle='#ffb338';
      ctx.lineWidth=2; pts.forEach((p,i)=> i?ctx.lineTo(p[0],p[1])
                                          :ctx.moveTo(p[0],p[1]));
      ctx.stroke(); ctx.lineWidth=1; }});
  }
  for (const clip of DATA.clips) {
    const f = Math.min(frame, clip.body_pos.length-1);   // CLAMP playback
    const bp = clip.body_pos[f];
    const contacts = clip.contacts ? clip.contacts[f] : null;
    for (let j=1;j<NB;j++) {
      const a=proj(bp[DATA.parents[j]]), b=proj(bp[j]);
      if (!a||!b) continue;
      items.push({z:Math.min(a[2],b[2])-0.02, draw(){
        ctx.beginPath(); ctx.moveTo(a[0],a[1]); ctx.lineTo(b[0],b[1]);
        ctx.strokeStyle=clip.color; ctx.lineWidth=3; ctx.stroke();
        ctx.lineWidth=1; }});
    }
    for (let j=0;j<NB;j++) {
      const p=proj(bp[j]); if (!p) continue;
      const hot = contacts && contacts[j] > 0.5;
      items.push({z:p[2]-0.03, draw(){ ctx.beginPath();
        ctx.arc(p[0],p[1],hot?6:4,0,7);
        ctx.fillStyle=hot?'#ff5f56':'#e3e3e3'; ctx.fill(); }});
    }
  }
  items.sort((a,b)=>b.z-a.z).forEach(it=>it.draw());
  const legend = DATA.clips.length > 1
    ? '  |  ' + DATA.clips.map(c=>c.label+' ('+c.color+')').join('  ') : '';
  document.getElementById('hud').textContent =
    `${DATA.title} — frame ${frame+1}/${T}` + legend +
    ` (drag to orbit, wheel to zoom)`;
  document.getElementById('t').textContent =
    (frame/DATA.fps).toFixed(2)+'s';
  scrub.value = frame;
}
setInterval(()=>{ if (playing) frame=(frame+1)%T; render(); },
            1000/DATA.fps);
</script></body></html>
"""


_CLIP_COLORS = ("#7ee787", "#79c0ff", "#ffa657", "#d2a8ff", "#f2cc60")


def body_positions(model: cm.CharModel, frames34) -> torch.Tensor:
    """(T, 34) frames -> (T, B, 3) world body positions by forward
    kinematics on the model's device."""
    frames = torch.as_tensor(np.asarray(frames34, np.float32),
                             device=model.device)
    body_pos, _ = cm.forward_kinematics(
        model, frames[:, 0:3], rot.exp_map_to_quat(frames[:, 3:6]),
        cm.dof_to_rot(model, frames[:, 6:]))
    return body_pos


def _clip_payload(model: cm.CharModel, motion: md.MotionData,
                  label: str, color: str) -> dict:
    body_pos = body_positions(model, motion.frames).cpu().numpy()
    return {
        "label": label, "color": color,
        "body_pos": np.round(body_pos.astype(np.float64), 4).tolist(),
        "contacts": (np.asarray(motion.contacts).round(1).tolist()
                     if motion.contacts is not None else None),
    }


def export_compare(model: cm.CharModel, motions: Sequence[md.MotionData],
                   out_path: str, labels: Optional[Sequence[str]] = None,
                   path_nodes: Optional[np.ndarray] = None,
                   title: str = "motion", device="cuda") -> None:
    """Write a standalone HTML viewer for one or more clips on a shared
    terrain (e.g. kinematic reference vs physics-recorded motion — the
    MOTION_FORGE stitcher/compare workflow).  The terrain and fps come
    from the first clip that has them; playback clamps shorter clips.
    Forward kinematics runs on ``device``."""
    model = model.to(resolve_device(device))
    labels = list(labels) if labels else [f"clip{i}"
                                          for i in range(len(motions))]
    clips = [_clip_payload(model, m, lab,
                           _CLIP_COLORS[i % len(_CLIP_COLORS)])
             for i, (m, lab) in enumerate(zip(motions, labels))]
    all_pos = np.concatenate(
        [np.asarray(c["body_pos"]).reshape(-1, 3) for c in clips])

    data = {
        "title": title,
        "fps": float(motions[0].fps),
        "parents": list(model.parent_indices),
        "clips": clips,
        "center": np.round(all_pos.mean(axis=0), 3).tolist(),
        "path": (np.round(np.asarray(path_nodes, np.float64), 3).tolist()
                 if path_nodes is not None else None),
    }
    terrain = next((m.terrain for m in motions if m.terrain is not None),
                   None)
    if terrain is not None:
        hf = np.asarray(terrain.hf, np.float64)
        data["terrain"] = {
            "hf": np.round(hf, 3).tolist(),
            "min_point": np.asarray(terrain.min_point,
                                    np.float64).tolist(),
            "dxdy": np.asarray(terrain.dxdy, np.float64).tolist(),
            "hmin": float(hf.min()), "hmax": float(hf.max()),
        }
    else:
        data["terrain"] = None

    html = _TEMPLATE.replace("__DATA__", json.dumps(data))
    with open(out_path, "w") as f:
        f.write(html)


def export(model: cm.CharModel, motion: md.MotionData, out_path: str,
           path_nodes: Optional[np.ndarray] = None,
           title: str = "motion", device="cuda") -> None:
    """Write a standalone HTML viewer for one clip."""
    export_compare(model, [motion], out_path, labels=["motion"],
                   path_nodes=path_nodes, title=title, device=device)
