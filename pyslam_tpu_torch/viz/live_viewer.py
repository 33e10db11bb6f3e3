"""Live interactive 3D viewer + SLAM-loop controls over localhost HTTP.
(port of ``pyslam_tpu/viz/live_viewer.py``: the same code, page and protocol).

Replacement for the reference's pangolin ``Viewer3D`` GUI thread
(``pyslam/viz/viewer3D.py:371-428`` draw loop, ``:711-722`` GUI controls
consumed by ``main_slam.py:449-478``): instead of a GL window the viewer
serves the framework's inline orbit renderer at ``http://127.0.0.1:<port>``
from a daemon thread.  The browser polls ``/state.json`` for live map
snapshots (version-gated, so an unchanged map costs a few bytes) and POSTs
``/control`` commands — **pause / resume / step / save / gba / reset /
quit** — which the main loop consumes between frames via the same control
surface the reference exposes as pangolin buttons/checkboxes
(``is_paused`` / ``do_step`` / ``do_save`` / ``do_gba`` / ``do_reset`` /
``is_closed``).

Everything is standard library (``http.server`` + ``threading``): no display
stack, no GL, zero egress.  The heavy lifting (snapshot assembly) happens on
the SLAM thread inside :meth:`LiveViewer3D.update`, throttled to
``min_snapshot_interval`` so the per-frame cost stays bounded; HTTP threads
only serialize the cached dict.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from pyslam_tpu_torch.viz.html_viewer import build_map_snapshot

_LIVE_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>pyslam_tpu live</title>
<style>
 body{margin:0;background:#111;color:#ddd;font:12px sans-serif;overflow:hidden}
 #hud{position:fixed;top:8px;left:8px;background:#000a;padding:8px;border-radius:6px}
 #ctrl{position:fixed;top:8px;right:8px;background:#000a;padding:8px;border-radius:6px}
 #ctrl button{display:block;width:100%;margin:2px 0;background:#222;color:#ddd;
   border:1px solid #555;border-radius:4px;padding:4px 10px;cursor:pointer}
 #ctrl button:hover{background:#333}
 label{display:block;margin:2px 0;cursor:pointer}
 canvas{display:block}
</style></head><body>
<div id="hud">
 <b>pyslam_tpu live</b><br><span id="stats">connecting...</span><br>
 <label><input type="checkbox" id="cb_pts" checked> map points</label>
 <label><input type="checkbox" id="cb_dense" checked> dense cloud</label>
 <label><input type="checkbox" id="cb_traj" checked> trajectory</label>
 <label><input type="checkbox" id="cb_kf" checked> keyframe frusta</label>
 <label><input type="checkbox" id="cb_cov"> covisibility</label>
 <label><input type="checkbox" id="cb_span" checked> spanning tree</label>
 <label><input type="checkbox" id="cb_loop" checked> loop edges</label>
 <small>drag: orbit &middot; shift-drag: pan &middot; wheel: zoom</small>
</div>
<div id="ctrl">
 <button id="bt_pause">pause</button>
 <button onclick="cmd('step')">step</button>
 <button onclick="cmd('save')">save map</button>
 <button onclick="cmd('gba')">run GBA</button>
 <button onclick="cmd('reset')">reset</button>
 <button onclick="cmd('quit')">quit</button>
</div>
<canvas id="c"></canvas>
<script>
let DATA={points:[],dense:[],traj:[],kf_poses:[],cov:[],span:[],loops:[],
          center:[0,0,0],radius:1};
let version=-1, paused=false;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let W, H; function resize(){W=cv.width=innerWidth;H=cv.height=innerHeight;}
resize(); addEventListener('resize', ()=>{resize(); draw();});
let yaw=-0.6, pitch=-0.5, dist=3.0, cx=[0,0,0], pan=[0,0], userCam=false;
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
function frustumSegs(T){
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
  if(DATA.kf_poses.length){ // highlight the latest camera
    drawLines(frustumSegs(DATA.kf_poses[DATA.kf_poses.length-1]),'#0f0',2);}
}
for(const el of document.querySelectorAll('input')) el.onchange=draw;
let drag=null;
cv.onmousedown=e=>drag=[e.clientX,e.clientY,e.shiftKey];
onmouseup=()=>drag=null;
onmousemove=e=>{if(!drag)return;
  const dx=e.clientX-drag[0], dy=e.clientY-drag[1];
  if(drag[2]){pan[0]+=dx;pan[1]+=dy;}else{yaw+=dx*0.008;pitch+=dy*0.008;}
  userCam=true; drag=[e.clientX,e.clientY,drag[2]]; draw();};
cv.onwheel=e=>{dist*=Math.pow(1.1,e.deltaY>0?1:-1); userCam=true; draw();
  e.preventDefault();};
function cmd(c){fetch('/control',{method:'POST',body:JSON.stringify({cmd:c})});}
document.getElementById('bt_pause').onclick=()=>cmd(paused?'resume':'pause');
async function poll(){
  try{
    const r = await fetch('/state.json?v='+version);
    const st = await r.json();
    paused = st.paused;
    document.getElementById('bt_pause').textContent = paused?'resume':'pause';
    document.getElementById('stats').textContent = st.status;
    if(st.scene){
      DATA = st.scene; version = st.version;
      if(!userCam){cx=DATA.center; dist=DATA.radius*3.0;}
      draw();
    }
  }catch(e){document.getElementById('stats').textContent='disconnected';}
  setTimeout(poll, 500);
}
poll(); draw();
</script></body></html>
"""


class LiveViewer3D:
    """HTTP live viewer whose controls the SLAM main loop consumes.

    Main-loop contract (mirrors reference ``main_slam.py:449-478``)::

        viewer = LiveViewer3D(port=0)          # 0 = ephemeral port
        for i in range(len(dataset)):
            slam.track(...)
            viewer.update(slam, status=f"frame {i}")
            viewer.wait_if_paused()            # blocks while paused; 'step'
                                               # releases one iteration
            for req in viewer.take_requests(): # 'save' | 'gba' | 'reset'
                ...
            if viewer.should_quit():
                break
        viewer.close()
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 min_snapshot_interval: float = 0.25,
                 max_points: int = 60000):
        self._lock = threading.Lock()
        self._scene: dict | None = None
        self._version = 0
        self._status = "waiting for first frame"
        self._last_snapshot_t = 0.0
        self._min_interval = min_snapshot_interval
        self._max_points = max_points

        self._paused = threading.Event()
        self._step = threading.Semaphore(0)
        self._quit = threading.Event()
        self._requests: list[str] = []

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _json(self, obj, code=200):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.startswith("/state.json"):
                    try:
                        client_v = int(self.path.split("v=")[1])
                    except (IndexError, ValueError):
                        client_v = -1
                    with viewer._lock:
                        st = {
                            "version": viewer._version,
                            "paused": viewer._paused.is_set(),
                            "status": viewer._status,
                            "scene": viewer._scene
                            if client_v != viewer._version else None,
                        }
                    self._json(st)
                elif self.path == "/" or self.path.startswith("/index"):
                    body = _LIVE_PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self._json({"error": "not found"}, 404)

            def do_POST(self):
                if not self.path.startswith("/control"):
                    self._json({"error": "not found"}, 404)
                    return
                n = int(self.headers.get("Content-Length", 0))
                try:
                    cmd = json.loads(self.rfile.read(n) or b"{}").get("cmd")
                except json.JSONDecodeError:
                    cmd = None
                ok = viewer._handle_command(cmd)
                self._json({"ok": ok, "cmd": cmd})

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.url = f"http://{host}:{self._server.server_address[1]}"
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="live-viewer-http",
        )
        self._thread.start()

    # ------------------------------------------------------------- commands
    def _handle_command(self, cmd: str | None) -> bool:
        if cmd == "pause":
            self._paused.set()
        elif cmd == "resume":
            self._paused.clear()
        elif cmd == "step":
            self._paused.set()      # stepping implies staying paused after
            self._step.release()
        elif cmd in ("save", "gba", "reset"):
            with self._lock:
                if cmd not in self._requests:
                    self._requests.append(cmd)
        elif cmd == "quit":
            self._quit.set()
            self._paused.clear()    # release a paused loop so it can exit
        else:
            return False
        return True

    # ------------------------------------- control surface for the SLAM loop
    def is_paused(self) -> bool:
        return self._paused.is_set()

    def should_quit(self) -> bool:
        return self._quit.is_set()

    def take_requests(self) -> list[str]:
        """Drain queued one-shot commands ('save' / 'gba' / 'reset')."""
        with self._lock:
            reqs, self._requests = self._requests, []
        return reqs

    def wait_if_paused(self, poll: float = 0.05):
        """Block while paused; a queued 'step' releases ONE iteration."""
        while self._paused.is_set() and not self._quit.is_set():
            if self._step.acquire(blocking=False):
                return
            time.sleep(poll)

    # ------------------------------------------------------------- snapshots
    def update(self, slam, status: str | None = None, dense_points=None,
               force: bool = False):
        """Publish a fresh scene snapshot (throttled; call every frame)."""
        if status is not None:
            with self._lock:
                self._status = status
        now = time.monotonic()
        if not force and now - self._last_snapshot_t < self._min_interval:
            return
        self._last_snapshot_t = now
        scene = build_map_snapshot(slam, dense_points=dense_points,
                                   max_points=self._max_points)
        with self._lock:
            self._scene = scene
            self._version += 1

    def close(self):
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=2.0)
