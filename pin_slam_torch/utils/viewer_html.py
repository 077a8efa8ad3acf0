"""Self-contained interactive 3-D viewer: one HTML file, zero dependencies,
the port's copy of ``pin_slam_tpu/utils/viewer_html.py`` (numpy only).  It
writes the same bytes as the JAX package's module for the same arrays, page
text included (its hint for serving live controls names that package's
server; this package's is ``python -m pin_slam_torch.utils.viewer_server``).

The run is headless, so instead of an interactive window (the reference's
Open3D visualizer, utils/visualizer.py:25-665) this emits a ``viewer.html``
artifact rendered by a hand-written WebGL2 orbit viewer (no CDN fetches,
works from ``file://`` on any machine).

Two modes:

* **snapshot** (default): ONE self-contained file, layers embedded as base64.
* **live** (``live=True``): ``viewer.html`` is written once with a poller
  that re-loads a sidecar ``viewer_data.js`` (written every refresh) via a
  cache-busted ``<script>`` tag — works from ``file://`` and any static HTTP
  server.  Camera pose, layer toggles and point size survive each refresh,
  and a status line shows frame id / map size / loop count, so a running
  SLAM process can be watched from a browser (the reference equivalent is
  the live Open3D window's per-frame update loop,
  utils/visualizer.py:421-526).

Key bindings mirror the reference visualizer's
(utils/visualizer.py:211-242): M mesh, P neural points, S scan, T trajectory,
D SDF slice, +/- point size, R reset view.
"""

from __future__ import annotations

import base64
import json
import os
from typing import Dict, Optional

import numpy as np

_HTML_TEMPLATE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>PIN-SLAM-TPU viewer</title>
<style>
 body { margin:0; overflow:hidden; background:#101014; color:#ddd;
        font:12px/1.4 system-ui, sans-serif; }
 #hud { position:fixed; top:8px; left:8px; background:rgba(16,16,20,.8);
        padding:8px 10px; border-radius:6px; pointer-events:none; }
 #hud b { color:#fff; }
 canvas { display:block; }
</style></head><body>
<div id="hud"></div><canvas id="gl"></canvas>
<script>
"use strict";
const LIVE = __LIVE__;
const EMBEDDED = __LAYERS_JSON__;
const EMBEDDED_META = __META_JSON__;

function decode(b64, dtype) {
  const bin = atob(b64); const n = bin.length;
  const buf = new ArrayBuffer(n); const view = new Uint8Array(buf);
  for (let i = 0; i < n; i++) view[i] = bin.charCodeAt(i);
  return dtype === "u8" ? new Uint8Array(buf)
       : dtype === "u32" ? new Uint32Array(buf) : new Float32Array(buf);
}

const canvas = document.getElementById("gl");
const gl = canvas.getContext("webgl2", {antialias:true});
const VS = `#version 300 es
 layout(location=0) in vec3 pos; layout(location=1) in vec3 col;
 uniform mat4 mvp; uniform float psize; out vec3 vcol;
 void main(){ gl_Position = mvp*vec4(pos,1.0); gl_PointSize = psize; vcol = col; }`;
const FS = `#version 300 es
 precision mediump float; in vec3 vcol; out vec4 frag; uniform float alpha;
 void main(){ frag = vec4(vcol, alpha); }`;
function shader(type, src) { const s = gl.createShader(type); gl.shaderSource(s, src);
  gl.compileShader(s); if (!gl.getShaderParameter(s, gl.COMPILE_STATUS))
  throw gl.getShaderInfoLog(s); return s; }
const prog = gl.createProgram();
gl.attachShader(prog, shader(gl.VERTEX_SHADER, VS));
gl.attachShader(prog, shader(gl.FRAGMENT_SHADER, FS));
gl.linkProgram(prog); gl.useProgram(prog);
const uMVP = gl.getUniformLocation(prog, "mvp");
const uPS = gl.getUniformLocation(prog, "psize");
const uA = gl.getUniformLocation(prog, "alpha");

let scene = {}; let meta = {}; let haveView = false;
const bbox = {lo:[1e9,1e9,1e9], hi:[-1e9,-1e9,-1e9]};
let center = [0,0,0], radius = 1;
let yaw=0.8, pitch=0.5, dist=2.2, pan=[0,0,0], psize=2.0;
function resetView(){ yaw=0.8; pitch=0.5; dist=radius*2.2; pan=[0,0,0]; }

function freeLayer(s) { if (!s) return;
  gl.deleteVertexArray(s.vao); gl.deleteBuffer(s.vb); gl.deleteBuffer(s.cb);
  if (s.idx) gl.deleteBuffer(s.idx); }

function loadScene(LAYERS, META) {
  // keep user toggles across live refreshes
  const prevOn = {}; for (const [n,s] of Object.entries(scene)) prevOn[n] = s.on;
  for (const s of Object.values(scene)) freeLayer(s);
  scene = {}; meta = META || {};
  bbox.lo = [1e9,1e9,1e9]; bbox.hi = [-1e9,-1e9,-1e9];
  for (const [name, L] of Object.entries(LAYERS)) {
    const pos = decode(L.pos, "f32");
    let col;
    if (L.col) { const c8 = decode(L.col, "u8");
      col = new Float32Array(c8.length); for (let i=0;i<c8.length;i++) col[i]=c8[i]/255; }
    else { col = new Float32Array(pos.length);
      for (let i=0;i<pos.length;i+=3){ col[i]=L.rgb[0]; col[i+1]=L.rgb[1]; col[i+2]=L.rgb[2]; } }
    const vao = gl.createVertexArray(); gl.bindVertexArray(vao);
    const vb = gl.createBuffer(); gl.bindBuffer(gl.ARRAY_BUFFER, vb);
    gl.bufferData(gl.ARRAY_BUFFER, pos, gl.STATIC_DRAW);
    gl.enableVertexAttribArray(0); gl.vertexAttribPointer(0,3,gl.FLOAT,false,0,0);
    const cb = gl.createBuffer(); gl.bindBuffer(gl.ARRAY_BUFFER, cb);
    gl.bufferData(gl.ARRAY_BUFFER, col, gl.STATIC_DRAW);
    gl.enableVertexAttribArray(1); gl.vertexAttribPointer(1,3,gl.FLOAT,false,0,0);
    let idx = null, nidx = 0;
    if (L.faces) { const f = decode(L.faces, "u32");
      idx = gl.createBuffer(); gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, idx);
      gl.bufferData(gl.ELEMENT_ARRAY_BUFFER, f, gl.STATIC_DRAW); nidx = f.length; }
    const on = name in prevOn ? prevOn[name] : L.on;
    scene[name] = {vao, vb, cb, n:pos.length/3, idx, nidx, mode:L.mode, on, key:L.key};
    for (let i=0;i<pos.length;i+=3) for (let a=0;a<3;a++) {
      if (pos[i+a]<bbox.lo[a]) bbox.lo[a]=pos[i+a];
      if (pos[i+a]>bbox.hi[a]) bbox.hi[a]=pos[i+a]; }
  }
  center = [0,1,2].map(a=>(bbox.lo[a]+bbox.hi[a])/2);
  radius = Math.max(1, Math.hypot(bbox.hi[0]-bbox.lo[0],
    bbox.hi[1]-bbox.lo[1], bbox.hi[2]-bbox.lo[2]) / 2);
  if (!haveView) { resetView(); haveView = true; }   // keep camera when live
  if (egoFollow && meta.sensor) {                    // ref ego view toggle
    pan = [meta.sensor[0]-center[0], meta.sensor[1]-center[1],
           meta.sensor[2]-center[2]]; }
  requestAnimationFrame(draw);
}

function mat(){ // perspective * lookAt(orbit around center+pan)
  const cx=center[0]+pan[0], cy=center[1]+pan[1], cz=center[2]+pan[2];
  const ex=cx+dist*Math.cos(pitch)*Math.cos(yaw),
        ey=cy+dist*Math.cos(pitch)*Math.sin(yaw),
        ez=cz+dist*Math.sin(pitch);
  const f=norm([cx-ex,cy-ey,cz-ez]), up=[0,0,1];
  const s=norm(cross(f,up)), u=cross(s,f);
  const V=[s[0],u[0],-f[0],0, s[1],u[1],-f[1],0, s[2],u[2],-f[2],0,
           -(s[0]*ex+s[1]*ey+s[2]*ez), -(u[0]*ex+u[1]*ey+u[2]*ez),
            (f[0]*ex+f[1]*ey+f[2]*ez), 1];
  const a=canvas.width/canvas.height, fy=1/Math.tan(0.4), zn=0.05, zf=radius*40;
  const P=[fy/a,0,0,0, 0,fy,0,0, 0,0,(zf+zn)/(zn-zf),-1, 0,0,2*zf*zn/(zn-zf),0];
  return mul(P,V);
}
function norm(v){const l=Math.hypot(...v)||1;return v.map(x=>x/l);}
function cross(a,b){return [a[1]*b[2]-a[2]*b[1], a[2]*b[0]-a[0]*b[2], a[0]*b[1]-a[1]*b[0]];}
function mul(A,B){ const C=new Float32Array(16);
  for(let i=0;i<4;i++)for(let j=0;j<4;j++){let s=0;
    for(let k2=0;k2<4;k2++) s+=A[k2*4+j]*B[i*4+k2]; C[i*4+j]=s;} return C; }

let egoFollow = false;
function hud(){
  const rows = [];
  if (LIVE) rows.push(`<b>LIVE</b> frame <b>${meta.frame ?? "?"}</b>` +
    (meta.map_points !== undefined ? ` · map <b>${meta.map_points.toLocaleString()}</b> pts` : "") +
    (meta.loops ? ` · loops <b>${meta.loops}</b>` : "") +
    (meta.paused ? " · <b style='color:#fa0'>PAUSED</b>" : "") +
    (meta.stale ? " · <b>stale?</b>" : ""));
  for (const [n,s] of Object.entries(scene)) rows.push(
    `[${s.key.toUpperCase()}] ${n}: <b>${s.on?"on":"off"}</b> (${s.n.toLocaleString()} pts)`);
  rows.push(`[E] ego-follow: <b>${egoFollow?"on":"off"}</b>`);
  rows.push("[+/-] point size", "[R] reset view", "drag orbit · shift-drag pan · wheel zoom");
  if (LIVE) rows.push(
    `<span id="ctl" style="pointer-events:auto">` +
    `<button onclick="ctl({pause:true})">pause</button> ` +
    `<button onclick="ctl({pause:false})">resume</button> ` +
    `<button onclick="ctl({step:1})">step</button> ` +
    `<button onclick="ctl({mesh_now:true})">mesh now</button></span>`);
  document.getElementById("hud").innerHTML = rows.join("<br>");
}
// run control (pause / step / mesh-now): POST to /control when served by
// utils/viewer_server.py; from file:// show the equivalent shell command
// (a static page cannot write the run dir). The pipeline polls control.json
// between frames (ref utils/visualizer.py:344-346 pause-at-loop debugging).
window.ctl = (patch) => {
  fetch("control", {method:"POST", body: JSON.stringify(patch)})
    .catch(() => alert(
      "Viewing from file:// — write the control file instead:\n\n" +
      "echo '" + JSON.stringify(patch) + "' > <run_dir>/control.json\n\n" +
      "(or serve live controls via: python -m pin_slam_tpu.utils.viewer_server <run_dir>)"));
};

function draw(){
  canvas.width = innerWidth; canvas.height = innerHeight;
  gl.viewport(0,0,canvas.width,canvas.height);
  gl.enable(gl.DEPTH_TEST); gl.clearColor(0.06,0.06,0.08,1);
  gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
  gl.uniformMatrix4fv(uMVP, false, mat()); gl.uniform1f(uPS, psize);
  for (const s of Object.values(scene)) { if (!s.on) continue;
    gl.bindVertexArray(s.vao);
    if (s.mode === "mesh") { gl.uniform1f(uA, 1.0);
      gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, s.idx);
      gl.drawElements(gl.TRIANGLES, s.nidx, gl.UNSIGNED_INT, 0); }
    else if (s.mode === "lines") { gl.uniform1f(uA, 1.0);
      gl.drawArrays(gl.LINE_STRIP, 0, s.n); }
    else { gl.uniform1f(uA, 0.95); gl.drawArrays(gl.POINTS, 0, s.n); } }
  hud();
}

let drag=null;
canvas.onmousedown = e => drag = {x:e.clientX, y:e.clientY, shift:e.shiftKey};
onmouseup = () => drag = null;
onmousemove = e => { if (!drag) return;
  const dx=e.clientX-drag.x, dy=e.clientY-drag.y; drag.x=e.clientX; drag.y=e.clientY;
  if (drag.shift) { const s=dist/600;
    pan[0]+=(-dx*Math.sin(yaw)+dy*Math.cos(yaw)*Math.sin(pitch))*s;
    pan[1]+=( dx*Math.cos(yaw)+dy*Math.sin(yaw)*Math.sin(pitch))*s;
    pan[2]+=dy*Math.cos(pitch)*s; }
  else { yaw -= dx*0.005; pitch = Math.min(1.55, Math.max(-1.55, pitch+dy*0.005)); }
  requestAnimationFrame(draw); };
onwheel = e => { dist *= Math.exp(e.deltaY*0.001); requestAnimationFrame(draw); };
onkeydown = e => { const k = e.key.toLowerCase();
  for (const s of Object.values(scene)) if (s.key === k) s.on = !s.on;
  if (k === "+" || k === "=") psize = Math.min(12, psize+1);
  if (k === "-") psize = Math.max(1, psize-1);
  if (k === "r") resetView();
  if (k === "e") { egoFollow = !egoFollow;
    if (egoFollow && meta.sensor) pan = [meta.sensor[0]-center[0],
      meta.sensor[1]-center[1], meta.sensor[2]-center[2]]; }
  requestAnimationFrame(draw); };
onresize = () => requestAnimationFrame(draw);

if (LIVE) {
  // poll the sidecar via a cache-busted <script> tag: works from file://
  // (fetch() of local files is blocked in most browsers) and static HTTP.
  // viewer_data.js calls window.__PIN_DATA(layers, meta); rev guards
  // redundant GPU re-uploads between run-side refreshes.
  let lastRev = null, lastOk = Date.now();
  window.__PIN_DATA = (layers, m) => { lastOk = Date.now();
    if (m && m.rev === lastRev) { if (meta.stale) { meta.stale = false; hud(); } return; }
    lastRev = m ? m.rev : null; loadScene(layers, m); };
  function poll() {
    const s = document.createElement("script");
    s.src = "viewer_data.js?t=" + Date.now();
    s.onload = () => s.remove();
    s.onerror = () => { s.remove();
      if (Date.now() - lastOk > 15000) { meta.stale = true; hud(); } };
    document.body.appendChild(s);
  }
  poll(); setInterval(poll, 2000);
  draw();
} else {
  loadScene(EMBEDDED, EMBEDDED_META);
}
</script></body></html>
"""


def _b64(arr: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(arr).tobytes()).decode()


def _point_layer(points: np.ndarray, key: str, on: bool, rgb,
                 colors: Optional[np.ndarray] = None,
                 max_points: int = 1_500_000) -> Dict:
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    if pts.shape[0] > max_points:
        # prime-stride decimation keeps spatial coverage uniform (same idea as
        # the ROS publisher's, ref pin_slam_ros.py:278-391)
        stride = pts.shape[0] // max_points + 1
        pts = pts[::stride]
        colors = colors[::stride] if colors is not None else None
    layer = {"pos": _b64(pts), "mode": "points", "on": on, "key": key}
    if colors is not None:
        c = np.asarray(colors)
        if c.dtype != np.uint8:
            c = (np.clip(c, 0, 1) * 255).astype(np.uint8)
        layer["col"] = _b64(c.reshape(-1, 3))
    else:
        layer["rgb"] = list(rgb)
    return layer


def _build_layers(*, scan=None, neural_points=None, neural_point_colors=None,
                  mesh_verts=None, mesh_faces=None, mesh_colors=None,
                  trajectory=None, sdf_slice_points=None,
                  sdf_slice_colors=None, sensor_verts=None,
                  sensor_faces=None, pool_points=None,
                  pool_labels=None) -> Dict[str, Dict]:
    """Layer set mirrors the reference visualizer's toggles
    (utils/visualizer.py:211-242): scan [S], neural points [P], mesh [M],
    trajectory [T], SDF slice [D], sensor CAD [C], data pool [O]."""
    layers: Dict[str, Dict] = {}
    if sensor_verts is not None and sensor_faces is not None and len(sensor_verts):
        layers["sensor"] = {
            "pos": _b64(np.asarray(sensor_verts, np.float32)),
            "faces": _b64(np.asarray(sensor_faces, np.uint32)),
            "mode": "mesh", "on": True, "key": "c", "rgb": [0.9, 0.55, 0.15]}
    if scan is not None and len(scan):
        layers["scan"] = _point_layer(scan, "s", True, (0.75, 0.75, 0.2))
    if neural_points is not None and len(neural_points):
        layers["neural points"] = _point_layer(
            neural_points, "p", mesh_verts is None, (0.35, 0.55, 0.95),
            colors=neural_point_colors)
    if mesh_verts is not None and mesh_faces is not None and len(mesh_verts):
        layer = {"pos": _b64(np.asarray(mesh_verts, np.float32)),
                 "faces": _b64(np.asarray(mesh_faces, np.uint32)),
                 "mode": "mesh", "on": True, "key": "m"}
        if mesh_colors is not None:
            c = np.asarray(mesh_colors)
            if c.dtype != np.uint8:
                c = (np.clip(c, 0, 1) * 255).astype(np.uint8)
            layer["col"] = _b64(c)
        else:
            layer["rgb"] = [0.7, 0.7, 0.7]
        layers["mesh"] = layer
    if trajectory is not None and len(trajectory):
        layers["trajectory"] = {
            "pos": _b64(np.asarray(trajectory, np.float32)), "mode": "lines",
            "on": True, "key": "t", "rgb": [1.0, 0.3, 0.3]}
    if sdf_slice_points is not None and len(sdf_slice_points):
        layers["sdf slice"] = _point_layer(
            sdf_slice_points, "d", False, (0.9, 0.4, 0.9),
            colors=sdf_slice_colors)
    if pool_points is not None and len(pool_points):
        # replay data pool (ref utils/visualizer.py data_pool layer): colored
        # by SDF-label sign — red in front of surface, blue behind
        lbl = (np.asarray(pool_labels, np.float32)
               if pool_labels is not None else None)
        cols = None
        if lbl is not None and len(lbl) == len(pool_points):
            t = np.clip(lbl / 0.3, -1.0, 1.0)
            cols = np.stack([0.5 + 0.5 * np.maximum(t, 0),
                             0.25 + 0.15 * (1 - np.abs(t)),
                             0.5 + 0.5 * np.maximum(-t, 0)], axis=1)
        layers["data pool"] = _point_layer(pool_points, "o", False,
                                           (0.4, 0.8, 0.6), colors=cols)
    return layers


def export_html(path: str, *,
                scan: Optional[np.ndarray] = None,
                neural_points: Optional[np.ndarray] = None,
                neural_point_colors: Optional[np.ndarray] = None,
                mesh_verts: Optional[np.ndarray] = None,
                mesh_faces: Optional[np.ndarray] = None,
                mesh_colors: Optional[np.ndarray] = None,
                trajectory: Optional[np.ndarray] = None,
                sdf_slice_points: Optional[np.ndarray] = None,
                sdf_slice_colors: Optional[np.ndarray] = None,
                sensor_verts: Optional[np.ndarray] = None,
                sensor_faces: Optional[np.ndarray] = None,
                pool_points: Optional[np.ndarray] = None,
                pool_labels: Optional[np.ndarray] = None,
                live: bool = False,
                meta: Optional[Dict] = None) -> str:
    """Write the viewer with whichever layers are given.

    ``live=False``: one self-contained HTML file (final artifact).
    ``live=True``: write/refresh the sidecar ``viewer_data.js`` next to
    ``path`` and create ``path`` itself (the polling shell) only if missing —
    call once per refresh during a run; an open browser tab follows along.
    ``meta`` (live): status shown in the HUD, e.g. {"frame": 120,
    "map_points": 40000, "loops": 2}; a "rev" key is added automatically.
    """
    layers = _build_layers(
        scan=scan, neural_points=neural_points,
        neural_point_colors=neural_point_colors, mesh_verts=mesh_verts,
        mesh_faces=mesh_faces, mesh_colors=mesh_colors, trajectory=trajectory,
        sdf_slice_points=sdf_slice_points, sdf_slice_colors=sdf_slice_colors,
        sensor_verts=sensor_verts, sensor_faces=sensor_faces,
        pool_points=pool_points, pool_labels=pool_labels)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    if live:
        meta = dict(meta or {})
        meta.setdefault("rev", meta.get("frame", 0))
        data_path = os.path.join(os.path.dirname(path) or ".",
                                 "viewer_data.js")
        tmp = data_path + ".tmp"
        with open(tmp, "w") as f:
            f.write("window.__PIN_DATA(%s, %s);"
                    % (json.dumps(layers), json.dumps(meta)))
        os.replace(tmp, data_path)         # atomic: the poller never sees a
        #                                    half-written file
        if not os.path.exists(path):
            html = (_HTML_TEMPLATE
                    .replace("__LIVE__", "true")
                    .replace("__LAYERS_JSON__", "{}")
                    .replace("__META_JSON__", "{}"))
            with open(path, "w") as f:
                f.write(html)
        return path

    html = (_HTML_TEMPLATE
            .replace("__LIVE__", "false")
            .replace("__LAYERS_JSON__", json.dumps(layers))
            .replace("__META_JSON__", json.dumps(meta or {})))
    with open(path, "w") as f:
        f.write(html)
    return path
