"""Front-end page for the interactive studio (see studio.py).

One self-contained HTML page: the html_viewer software renderer (orbit
camera, scrub, terrain, skeletons) extended with an operations panel and
terrain cell picking.  Talks JSON to the studio server's /api endpoints.
"""

PAGE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>parc_torch studio</title>
<style>
 body { margin:0; background:#16161d; color:#ddd;
        font:13px system-ui, sans-serif; overflow:hidden; }
 #hud { position:fixed; top:8px; left:8px; user-select:none; max-width:60%;
        text-shadow:0 1px 2px #000; }
 #bar { position:fixed; bottom:8px; left:8px; right:300px; display:flex;
        gap:8px; align-items:center; }
 #scrub { flex:1; }
 #panel { position:fixed; top:0; right:0; bottom:0; width:280px;
          background:#1e1e26; border-left:1px solid #333; padding:10px;
          overflow-y:auto; box-sizing:border-box; }
 #panel h3 { margin:12px 0 4px; font-size:12px; color:#9aa;
             text-transform:uppercase; letter-spacing:1px; }
 #panel .row { display:flex; gap:4px; margin:3px 0; align-items:center; }
 button { background:#333; color:#ddd; border:1px solid #555;
          border-radius:4px; padding:3px 10px; cursor:pointer; }
 button:hover { background:#3c3c46; }
 button.on { background:#3b5b9e; border-color:#6b8bd6; }
 input, select { background:#26262e; color:#ddd; border:1px solid #555;
          border-radius:4px; padding:2px 6px; width:70px; }
 select { width:auto; }
 #status { position:fixed; bottom:36px; left:8px; right:300px;
           color:#8fc; text-shadow:0 1px 2px #000; }
 #err { color:#f88; }
</style></head><body>
<canvas id="c"></canvas>
<div id="hud"></div>
<div id="status"></div>
<div id="bar"><button id="play">pause</button>
<input type="range" id="scrub" min="0" value="0" step="1" style="width:auto">
<span id="t"></span></div>
<div id="panel">
 <h3>mode</h3>
 <div class="row">
  <button class="mode on" data-m="orbit">orbit</button>
  <button class="mode" data-m="raise">raise</button>
  <button class="mode" data-m="lower">lower</button>
 </div>
 <div class="row">
  <button class="mode" data-m="start">pick start</button>
  <button class="mode" data-m="end">pick end</button>
  <label>dh <input id="dh" value="0.2"></label>
 </div>
 <h3>io</h3>
 <div class="row"><input id="path" style="flex:1;width:auto"
      placeholder="clip.npz"></div>
 <div class="row"><button onclick="api('load',{path:v('path')})">load</button>
  <button onclick="api('save',{path:v('path')})">save</button></div>
 <h3>terrain</h3>
 <div class="row">
  <select id="pg"><option>boxes</option><option>stairs</option>
   <option>paths</option><option>perlin</option><option>parkour</option>
   <option>cave</option><option>flat</option></select>
  <label>n <input id="pgn" value="24" style="width:40px"></label>
  <button onclick="api('procgen',{kind:v('pg'),x_dim:+v('pgn'),y_dim:+v('pgn')})">
   generate</button>
 </div>
 <div class="row">
  <button onclick="api('snap_discrete',{})">snap to discrete heights</button>
 </div>
 <div class="row">
  <select id="tf"><option>remove_sharp_lines</option>
   <option>flat_maxpool_2x2</option><option>flat_maxpool_3x3</option>
   <option>downsample</option></select>
  <button onclick="api('terrain_filter',{kind:v('tf')})">filter</button>
 </div>
 <h3>planning</h3>
 <div class="row"><span id="se">start: — &nbsp; end: —</span></div>
 <div class="row"><button onclick="runAstar()">run A*</button></div>
 <h3>diffusion</h3>
 <div class="row"><input id="mdmdir" style="flex:1;width:auto"
      placeholder="mdm dir (optional)"></div>
 <div class="row">
  <button onclick="api('mdm_gen', v('mdmdir')?{mdm_dir:v('mdmdir')}:{})">
   generate along path</button></div>
 <h3>optimize</h3>
 <div class="row"><label>iters <input id="oi" value="300"></label>
  <button onclick="api('optimize',{iters:+v('oi')})">run</button>
  <button onclick="api('accept_overlay',{})">accept</button></div>
 <h3>edit</h3>
 <div class="row"><button onclick="api('flip',{})">mirror XZ</button>
  <label>fps <input id="rf" value="30" style="width:40px"></label>
  <button onclick="api('resample',{fps:+v('rf')})">resample</button></div>
 <div class="row"><label>slice <input id="s0" value="0" style="width:40px">
  <input id="s1" value="30" style="width:40px"></label>
  <button onclick="api('slice',{start:+v('s0'),end:+v('s1')})">cut</button>
 </div>
 <div class="row"><label>stitch <input id="stp" placeholder="clip.npz"
  style="flex:1;width:auto"></label>
  <button onclick="api('stitch',{path:v('stp')})">stitch</button></div>
 <div class="row">
  <button onclick="api('recompute_contacts',{})">recompute contacts</button>
 </div>
 <h3>physics tracking</h3>
 <div class="row"><input id="trkdir" style="flex:1;width:auto"
      placeholder="tracker dir (optional)"></div>
 <div class="row">
  <button onclick="api('track', v('trkdir')?{tracker_dir:v('trkdir')}:{})">
   track clip</button>
  <button onclick="api('accept_overlay',{})">accept</button></div>
 <div class="row">
  <button id="live" onclick="toggleLive()">live sim</button>
  <span id="livest"></span></div>
</div>
<script>
let DATA = {clips:[],terrain:null,path:null,parents:[],fps:30,
            center:[0,0,0],title:'parc_torch studio',status:'connecting'};
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let W, H;
function resize(){ W=cv.width=innerWidth-280; H=cv.height=innerHeight; }
resize(); addEventListener('resize', resize);
let yaw = 0.8, pitch = 0.5, dist = 12, target = [0,0,0];
let frame = 0, playing = true, mode = 'orbit';
let pickStart = null, pickEnd = null;
const scrub = document.getElementById('scrub');
document.getElementById('play').onclick = e => {
  playing = !playing; e.target.textContent = playing ? 'pause' : 'play'; };
scrub.oninput = e => { frame = +e.target.value; playing = false;
  document.getElementById('play').textContent = 'play'; };
for (const b of document.querySelectorAll('.mode'))
  b.onclick = () => { mode = b.dataset.m;
    document.querySelectorAll('.mode').forEach(x=>
      x.classList.toggle('on', x===b)); };
function v(id){ return document.getElementById(id).value; }
function setStatus(s, err){ const el=document.getElementById('status');
  el.textContent = s; el.className = err ? 'err' : ''; el.id='status'; }
async function api(op, payload){
  setStatus(op + ' ...');
  try {
    const r = await fetch('/api/'+op, {method:'POST',
      headers:{'Content-Type':'application/json'},
      body: JSON.stringify(payload||{})});
    const j = await r.json();
    if (j.error) { setStatus(j.error, true); return; }
    applyState(j);
  } catch(e) { setStatus(''+e, true); }
}
function applyState(j){
  DATA = j; setStatus(j.status||'');
  const T = maxT();
  scrub.max = Math.max(T-1, 0);
  if (frame >= T) frame = 0;
  if (DATA.center) target = DATA.center.slice();
}
function maxT(){ return DATA.clips.length
  ? Math.max(...DATA.clips.map(c=>c.body_pos.length)) : 1; }
// live physics stepping (MOTION_FORGE IG-in-the-loop): sim_start once,
// then sim_step in a loop while enabled — the overlay grows as the
// simulation runs and playback follows the newest frame
let live = false, liveBusy = false;
async function toggleLive(){
  live = !live;
  document.getElementById('live').classList.toggle('on', live);
  if (live) {
    await api('sim_start', v('trkdir') ? {tracker_dir: v('trkdir')} : {});
    liveLoop();
  } else { api('sim_stop', {}); }
}
async function liveLoop(){
  while (live) {
    if (!liveBusy) {
      liveBusy = true;
      try { await api('sim_step', {steps: 8}); frame = maxT() - 1; }
      finally { liveBusy = false; }
    }
    await new Promise(r => setTimeout(r, 120));
  }
}
function runAstar(){
  if (!pickStart || !pickEnd) { setStatus('pick start and end first', true);
    return; }
  api('astar', {start:pickStart, end:pickEnd});
}
function proj(p) {
  const cy=Math.cos(yaw), sy=Math.sin(yaw), cp=Math.cos(pitch),
        sp=Math.sin(pitch);
  let x=p[0]-target[0], y=p[1]-target[1], z=p[2]-target[2];
  let x1 = cy*x + sy*y, y1 = -sy*x + cy*y;
  let y2 = cp*y1 - sp*z, z2 = sp*y1 + cp*z;
  const d = y2 + dist;
  if (d < 0.1) return null;
  const f = 0.9*Math.min(W,H)/d;
  return [W/2 + f*x1, H/2 - f*z2, d];
}
function cellQuadPts(i, j){
  const t = DATA.terrain, [mx,my]=t.min_point, [dx,dy]=t.dxdy;
  const z=t.hf[i][j], x=mx+i*dx, y=my+j*dy;
  return [[x-dx/2,y-dy/2,z],[x+dx/2,y-dy/2,z],
          [x+dx/2,y+dy/2,z],[x-dx/2,y+dy/2,z]];
}
function pickCell(mx, my){
  if (!DATA.terrain) return null;
  const hf = DATA.terrain.hf;
  let best = null;
  for (let i=0;i<hf.length;i++) for (let j=0;j<hf[0].length;j++){
    const pts = cellQuadPts(i,j).map(proj);
    if (pts.some(p=>!p)) continue;
    let inside = true;
    for (let k=0;k<4;k++){
      const a=pts[k], b=pts[(k+1)%4];
      if ((b[0]-a[0])*(my-a[1])-(b[1]-a[1])*(mx-a[0]) > 0) {inside=false;break;}
    }
    if (!inside){
      inside = true;
      for (let k=0;k<4;k++){
        const a=pts[k], b=pts[(k+1)%4];
        if ((b[0]-a[0])*(my-a[1])-(b[1]-a[1])*(mx-a[0]) < 0){inside=false;break;}
      }
    }
    if (inside){
      const z = (pts[0][2]+pts[2][2])/2;
      if (!best || z < best.z) best = {i,j,z};
    }
  }
  return best;
}
let drag = null, dragged = false;
cv.onmousedown = e => { drag = [e.clientX, e.clientY]; dragged = false; };
addEventListener('mouseup', e => {
  if (drag && !dragged && mode !== 'orbit') {
    const c = pickCell(e.clientX, e.clientY);
    if (c) {
      if (mode === 'raise') api('edit_cells',{cells:[[c.i,c.j]],dh:+v('dh')});
      else if (mode === 'lower')
        api('edit_cells',{cells:[[c.i,c.j]],dh:-v('dh')});
      else if (mode === 'start') { pickStart=[c.i,c.j]; updateSE(); }
      else if (mode === 'end') { pickEnd=[c.i,c.j]; updateSE(); }
    }
  }
  drag = null;
});
function updateSE(){ document.getElementById('se').textContent =
  `start: ${pickStart? pickStart.join(','):'—'}   end: ${
    pickEnd? pickEnd.join(','):'—'}`; }
addEventListener('mousemove', e => { if (!drag) return;
  if (Math.abs(e.clientX-drag[0])+Math.abs(e.clientY-drag[1]) > 3)
    dragged = true;
  if (mode !== 'orbit' && !e.shiftKey) return;
  yaw -= (e.clientX-drag[0])*0.008; pitch += (e.clientY-drag[1])*0.008;
  pitch = Math.max(0.05, Math.min(1.5, pitch));
  drag = [e.clientX,e.clientY]; });
cv.onwheel = e => { dist *= Math.exp(e.deltaY*0.001); e.preventDefault(); };
// MOTION_FORGE hotkeys (reference README): A terrain height, N waypoint,
// G generate; plus O orbit, space play/pause
addEventListener('keydown', e => {
  if (e.target.tagName === 'INPUT' || e.target.tagName === 'SELECT') return;
  const setMode = m => { mode = m;
    document.querySelectorAll('.mode').forEach(x =>
      x.classList.toggle('on', x.dataset.m === m)); };
  if (e.key === 'a' || e.key === 'A') setMode(e.shiftKey ? 'lower' : 'raise');
  else if (e.key === 'n' || e.key === 'N')
    setMode(mode === 'start' ? 'end' : 'start');
  else if (e.key === 'g' || e.key === 'G')
    api('mdm_gen', v('mdmdir') ? {mdm_dir: v('mdmdir')} : {});
  else if (e.key === 'o' || e.key === 'O') setMode('orbit');
  else if (e.key === ' ') { playing = !playing;
    document.getElementById('play').textContent = playing ? 'pause' : 'play';
    e.preventDefault(); }
});
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
  if (DATA.terrain) {
    const t = DATA.terrain, hf = t.hf;
    const hmin=t.hmin, hspan=Math.max(t.hmax-hmin,1e-3);
    for (let i=0;i<hf.length;i++) for (let j=0;j<hf[0].length;j++) {
      const s = 30+110*(hf[i][j]-hmin)/hspan;
      let fill = `rgb(${s*0.5},${s*0.75},${s})`;
      if (pickStart && pickStart[0]==i && pickStart[1]==j)
        fill = '#3fa34d';
      if (pickEnd && pickEnd[0]==i && pickEnd[1]==j) fill = '#b33939';
      const p = cellQuadPts(i,j);
      const q = quad(p[0],p[1],p[2],p[3], fill, '#0003');
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
  const NB = DATA.clips.length ? DATA.clips[0].body_pos[0].length : 0;
  for (const clip of DATA.clips) {
    const f = Math.min(frame, clip.body_pos.length-1);
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
  const T = maxT();
  const legend = DATA.clips.length > 1
    ? '  |  ' + DATA.clips.map(c=>c.label+' ('+c.color+')').join('  ') : '';
  document.getElementById('hud').textContent =
    `${DATA.title} — frame ${frame+1}/${T}` + legend +
    ` (drag=orbit, shift+drag in edit modes)`;
  document.getElementById('t').textContent =
    (frame/DATA.fps).toFixed(2)+'s';
  scrub.value = frame;
}
setInterval(()=>{ if (playing && DATA.clips.length)
  frame=(frame+1)%maxT(); render(); }, 1000/30);
fetch('/api/state').then(r=>r.json()).then(applyState)
  .catch(e=>setStatus(''+e, true));
</script></body></html>
"""
