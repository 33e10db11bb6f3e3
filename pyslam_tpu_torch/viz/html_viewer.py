"""Self-contained interactive 3D map viewer (single HTML file).
(port of ``pyslam_tpu/viz/html_viewer.py``: the same code and page).

Replaces the reference's pangolin GL viewer surface for environments
without a display stack (``pyslam/viz/viewer3D.py``): exports the sparse
map, keyframe frusta, trajectory, covisibility/spanning-tree/loop edges
and an optional dense cloud into ONE dependency-free HTML file with an
inline vanilla-JS orbit renderer (no CDN, zero egress) — open it in any
browser, drag to orbit, wheel to zoom, checkboxes toggle layers (the
same toggles the reference exposes as pangolin checkboxes).
"""

from __future__ import annotations

import json

import numpy as np

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>pyslam_tpu map</title>
<style>
 body{margin:0;background:#111;color:#ddd;font:12px sans-serif;overflow:hidden}
 #hud{position:fixed;top:8px;left:8px;background:#000a;padding:8px;border-radius:6px}
 label{display:block;margin:2px 0;cursor:pointer}
 canvas{display:block}
</style></head><body>
<div id="hud">
 <b>pyslam_tpu map</b><br>__STATS__
 <label><input type="checkbox" id="cb_pts" checked> map points</label>
 <label><input type="checkbox" id="cb_dense" checked> dense cloud</label>
 <label><input type="checkbox" id="cb_traj" checked> trajectory</label>
 <label><input type="checkbox" id="cb_kf" checked> keyframe frusta</label>
 <label><input type="checkbox" id="cb_cov"> covisibility</label>
 <label><input type="checkbox" id="cb_span" checked> spanning tree</label>
 <label><input type="checkbox" id="cb_loop" checked> loop edges</label>
 <small>drag: orbit &middot; shift-drag: pan &middot; wheel: zoom</small>
</div>
<canvas id="c"></canvas>
<script>
const DATA = __DATA__;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let W, H; function resize(){W=cv.width=innerWidth;H=cv.height=innerHeight;}
resize(); addEventListener('resize', ()=>{resize(); draw();});
let yaw=-0.6, pitch=-0.5, dist=DATA.radius*3.0, cx=DATA.center, pan=[0,0];
function project(p){
  const sy=Math.sin(yaw), cyw=Math.cos(yaw), sp=Math.sin(pitch), cp=Math.cos(pitch);
  let x=p[0]-cx[0], y=p[1]-cx[1], z=p[2]-cx[2];
  let x1=cyw*x+sy*z, z1=-sy*x+cyw*z;
  let y1=cp*y-sp*z1, z2=sp*y+cp*z1+dist;
  if(z2<0.05) return null;
  const f=0.9*Math.min(W,H);
  return [W/2+f*x1/z2+pan[0], H/2+f*y1/z2+pan[1], z2];
}
function drawPts(pts, color, size){
  ctx.fillStyle=color;
  for(let i=0;i<pts.length;i++){const q=project(pts[i]); if(!q) continue;
    const s=Math.max(size*8/q[2], 0.6); ctx.fillRect(q[0]-s/2,q[1]-s/2,s,s);}
}
function drawLines(segs, color, w){
  ctx.strokeStyle=color; ctx.lineWidth=w; ctx.beginPath();
  for(const s of segs){const a=project(s[0]), b=project(s[1]); if(!a||!b) continue;
    ctx.moveTo(a[0],a[1]); ctx.lineTo(b[0],b[1]);}
  ctx.stroke();
}
function frustumSegs(T){ // T: 4x4 row-major camera-to-world
  const s=DATA.radius*0.03;
  const loc=[[0,0,0],[-s,-s,1.6*s],[s,-s,1.6*s],[s,s,1.6*s],[-s,s,1.6*s]];
  const w=loc.map(p=>[
    T[0]*p[0]+T[1]*p[1]+T[2]*p[2]+T[3],
    T[4]*p[0]+T[5]*p[1]+T[6]*p[2]+T[7],
    T[8]*p[0]+T[9]*p[1]+T[10]*p[2]+T[11]]);
  return [[w[0],w[1]],[w[0],w[2]],[w[0],w[3]],[w[0],w[4]],
          [w[1],w[2]],[w[2],w[3]],[w[3],w[4]],[w[4],w[1]]];
}
const on=id=>document.getElementById(id).checked;
function draw(){
  ctx.fillStyle='#111'; ctx.fillRect(0,0,W,H);
  if(on('cb_dense')&&DATA.dense.length) drawPts(DATA.dense,'#3a6ea5',1.2);
  if(on('cb_pts')) drawPts(DATA.points,'#aaa',1.5);
  if(on('cb_traj')&&DATA.traj.length>1){
    const segs=[]; for(let i=1;i<DATA.traj.length;i++) segs.push([DATA.traj[i-1],DATA.traj[i]]);
    drawLines(segs,'#4da6ff',2);}
  if(on('cb_cov')) drawLines(DATA.cov,'#444',0.5);
  if(on('cb_span')) drawLines(DATA.span,'#2d8a2d',1);
  if(on('cb_loop')) drawLines(DATA.loops,'#d33',1.5);
  if(on('cb_kf')) for(const T of DATA.kf_poses) drawLines(frustumSegs(T),'#e66',1);
}
for(const el of document.querySelectorAll('input')) el.onchange=draw;
let drag=null;
cv.onmousedown=e=>drag=[e.clientX,e.clientY,e.shiftKey];
onmouseup=()=>drag=null;
onmousemove=e=>{if(!drag)return;
  const dx=e.clientX-drag[0], dy=e.clientY-drag[1];
  if(drag[2]){pan[0]+=dx;pan[1]+=dy;}else{yaw+=dx*0.008;pitch+=dy*0.008;}
  drag=[e.clientX,e.clientY,drag[2]]; draw();};
cv.onwheel=e=>{dist*=Math.pow(1.1,e.deltaY>0?1:-1); draw(); e.preventDefault();};
draw();
</script></body></html>
"""


def build_map_snapshot(slam, dense_points=None, max_points: int = 60000,
                       covis_min_weight: int = 30):
    """Collect the viewer scene (points/trajectory/frusta/graph edges) as a
    JSON-ready dict — shared by the static HTML export and the live viewer."""
    st = slam.map.points
    pids = st.alive_ids()
    pts = np.asarray(st.pos[pids], np.float32)
    if len(pts) > max_points:
        pts = pts[np.random.default_rng(0).choice(
            len(pts), max_points, replace=False)]
    kms = [slam.map.keyframes[k] for k in slam.map.keyframe_order]
    kf_poses = [np.asarray(kf.Twc, np.float32)[:3].reshape(-1) for kf in kms]
    centers = {kf.kid: np.asarray(kf.Ow, np.float32) for kf in kms}
    ts, poses = slam.get_final_trajectory()
    traj = poses[:, :3, 3] if len(ts) else np.zeros((0, 3))
    cov, span, loops = [], [], []
    for kf in kms:
        for other, w in getattr(kf, "connected_keyframes", {}).items():
            if w >= covis_min_weight and other in centers \
                    and other > kf.kid:
                cov.append([centers[kf.kid].tolist(),
                            centers[other].tolist()])
        parent = getattr(kf, "parent", None)
        if parent is not None and parent in centers:
            span.append([centers[kf.kid].tolist(), centers[parent].tolist()])
        for other in getattr(kf, "loop_edges", ()):  # set of kids
            if other in centers and other > kf.kid:
                loops.append([centers[kf.kid].tolist(),
                              centers[other].tolist()])
    allp = pts if len(pts) else np.zeros((1, 3))
    center = allp.mean(0)
    radius = float(np.percentile(
        np.linalg.norm(allp - center, axis=1), 90) + 1e-3)
    dense = np.asarray(dense_points, np.float32) \
        if dense_points is not None else np.zeros((0, 3))
    if len(dense) > max_points:
        dense = dense[np.random.default_rng(1).choice(
            len(dense), max_points, replace=False)]
    return {
        "points": np.round(pts, 3).tolist(),
        "dense": np.round(dense, 3).tolist(),
        "traj": np.round(np.asarray(traj, np.float32), 3).tolist(),
        "kf_poses": [np.round(p, 4).tolist() for p in kf_poses],
        "cov": cov, "span": span, "loops": loops,
        "center": np.round(center, 3).tolist(),
        "radius": radius,
        "n_points": int(slam.map.num_points()),
        "n_kfs": len(kf_poses),
        "n_loops": len(loops),
    }


def export_html_map(slam, out_path: str, dense_points=None,
                    max_points: int = 60000, covis_min_weight: int = 30):
    """Write a standalone interactive viewer for the SLAM map."""
    data = build_map_snapshot(slam, dense_points=dense_points,
                              max_points=max_points,
                              covis_min_weight=covis_min_weight)
    stats = (f"{data['n_points']} pts &middot; {data['n_kfs']} kfs &middot; "
             f"{data['n_loops']} loops<br>")
    html = _TEMPLATE.replace("__DATA__", json.dumps(data)) \
                    .replace("__STATS__", stats)
    with open(out_path, "w") as f:
        f.write(html)
    return out_path
