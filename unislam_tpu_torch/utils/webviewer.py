"""Interactive live map viewer over HTTP, the port's counterpart of
`unislam_tpu/utils/webviewer.py`.

A tiny zero-dependency HTTP server: it serves a self-contained WebGL page
(no external JS, works through an SSH port-forward) plus two JSON/binary
endpoints backed by the run's file-based live feed (`live.json` + mesh
snapshots, see playback.py).

  GET /            the viewer page (embedded single-file WebGL app)
  GET /state       run state: frame, trajectories, newest mesh name,
                   snapshot list (live.json if the run is active, else
                   synthesized from the latest checkpoint)
  GET /mesh/<name> binary PLY from `<output>/mesh/` (basename-sanitized)

The browser polls /state, redraws trajectory + camera-frustum actors every
tick, and re-downloads the mesh only when its name changes. A snapshot
scrubber replays map evolution post-hoc. Host code only: it reads files
and touches no tensor or device.

Usage: python -m unislam_tpu_torch.visualizer <config> --web [--port 8090]
       then open http://localhost:8090 (or SSH-forward the port).
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from unislam_tpu_torch.utils import playback


def _posthoc_state(output: str):
    """Synthesize a /state payload from the latest checkpoint (run over)."""
    from unislam_tpu_torch.utils.logger import (latest_checkpoint,
                                                 load_checkpoint)
    path = latest_checkpoint(os.path.join(output, "ckpts"))
    if path is None:
        return None
    ckpt = load_checkpoint(path)
    est, gt = ckpt["est_c2w"], ckpt["gt_c2w"]
    n = int(ckpt["meta"].get("idx", len(est) - 1)) + 1
    return {
        "frame": n - 1,
        "n_img": int(len(est)),
        "est_t": np.asarray(est[:n, :3, 3], np.float64).round(5).tolist(),
        "gt_t": np.asarray(gt[:n, :3, 3], np.float64).round(5).tolist(),
        "cur_c2w": np.asarray(est[n - 1], np.float64).tolist(),
        "mesh": playback.newest_mesh(os.path.join(output, "mesh")),
        "done": True,
    }


class _Handler(BaseHTTPRequestHandler):
    # set per-server via functools.partial-style subclassing in make_server
    output: str = "."

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _send(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Cache-Control", "no-store")
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (http.server API)
        try:
            self._route()
        except (BrokenPipeError, ConnectionResetError):
            pass

    def _route(self):
        path = self.path.split("?", 1)[0]
        if path == "/" or path == "/index.html":
            self._send(200, VIEWER_HTML.encode(), "text/html; charset=utf-8")
        elif path == "/state":
            state = (playback.read_live_state(self.output)
                     or _posthoc_state(self.output))
            if state is None:
                self._send(404, b'{"error": "no run data yet"}',
                           "application/json")
                return
            mesh_dir = os.path.join(self.output, "mesh")
            state = dict(state)
            state["mesh"] = (os.path.basename(state["mesh"])
                             if state.get("mesh") else None)
            state["meshes"] = sorted(
                f for f in os.listdir(mesh_dir)
                if f.endswith(".ply")) if os.path.isdir(mesh_dir) else []
            self._send(200, json.dumps(state).encode(), "application/json")
        elif path.startswith("/mesh/"):
            name = os.path.basename(path[len("/mesh/"):])  # no traversal
            full = os.path.join(self.output, "mesh", name)
            if not (name.endswith(".ply") and os.path.isfile(full)):
                self._send(404, b"not found", "text/plain")
                return
            with open(full, "rb") as f:
                self._send(200, f.read(), "application/octet-stream")
        else:
            self._send(404, b"not found", "text/plain")


def make_server(output: str, port: int = 8090,
                host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """Build (but don't start) the viewer server; port=0 picks a free one."""
    handler = type("Handler", (_Handler,), {"output": output})
    return ThreadingHTTPServer((host, port), handler)


def serve(output: str, port: int = 8090, host: str = "127.0.0.1"):
    """Blocking viewer server (ctrl-C to stop)."""
    srv = make_server(output, port, host)
    print(f"viewer: http://{host}:{srv.server_address[1]}  (output={output})")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()


def start_background(output: str, port: int = 0,
                     host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """Start the server on a daemon thread; returns it (see .server_address)."""
    srv = make_server(output, port, host)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


# ---------------------------------------------------------------------------
# the embedded single-file WebGL viewer (no external assets: the page must
# work on a host without egress, over a bare SSH port-forward)
# ---------------------------------------------------------------------------

VIEWER_HTML = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>unislam_tpu_torch live viewer</title>
<style>
  html,body{margin:0;height:100%;background:#15181d;color:#d5dae3;
    font:13px/1.45 system-ui,sans-serif;overflow:hidden}
  #gl{width:100%;height:100%;display:block;cursor:grab}
  #hud{position:fixed;top:10px;left:12px;background:rgba(21,24,29,.82);
    border:1px solid #2c3340;border-radius:8px;padding:10px 14px;
    max-width:330px}
  #hud b{color:#fff}
  #bar{height:5px;background:#2c3340;border-radius:3px;margin:7px 0}
  #fill{height:100%;width:0;background:#4c8dff;border-radius:3px}
  select{background:#1d222b;color:#d5dae3;border:1px solid #2c3340;
    border-radius:5px;padding:2px 5px;max-width:300px}
  .k{color:#8b94a5}
  .sw{display:inline-block;width:9px;height:9px;border-radius:2px;
    margin:0 4px 0 10px}
</style></head><body>
<canvas id="gl"></canvas>
<div id="hud">
  <b>unislam_tpu</b> <span id="status" class="k">connecting…</span>
  <div id="bar"><div id="fill"></div></div>
  <div><span class="k">frame</span> <span id="frame">–</span>
    <span class="k">mesh</span> <span id="minfo">–</span></div>
  <div><span class="sw" style="background:#4c8dff"></span>estimated
       <span class="sw" style="background:#ff9e4c"></span>ground truth</div>
  <div style="margin-top:6px"><span class="k">snapshot</span>
    <select id="snap"><option value="">latest (live)</option></select></div>
  <div class="k" style="margin-top:4px">drag rotate · wheel zoom ·
    right-drag pan</div>
</div>
<script>
"use strict";
// ---------- tiny matrix helpers (column-major, WebGL convention) ----------
function mat4mul(a,b){const o=new Float32Array(16);
  for(let c=0;c<4;c++)for(let r=0;r<4;r++){let s=0;
    for(let k=0;k<4;k++)s+=a[k*4+r]*b[c*4+k];o[c*4+r]=s}return o}
function persp(fov,asp,n,f){const t=1/Math.tan(fov/2);
  return new Float32Array([t/asp,0,0,0, 0,t,0,0,
    0,0,(f+n)/(n-f),-1, 0,0,2*f*n/(n-f),0])}
function lookAt(eye,ctr,up){
  const z=norm3(sub3(eye,ctr)),x=norm3(cross3(up,z)),y=cross3(z,x);
  return new Float32Array([x[0],y[0],z[0],0, x[1],y[1],z[1],0,
    x[2],y[2],z[2],0, -dot3(x,eye),-dot3(y,eye),-dot3(z,eye),1])}
function sub3(a,b){return [a[0]-b[0],a[1]-b[1],a[2]-b[2]]}
function dot3(a,b){return a[0]*b[0]+a[1]*b[1]+a[2]*b[2]}
function cross3(a,b){return [a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],
  a[0]*b[1]-a[1]*b[0]]}
function norm3(a){const l=Math.hypot(a[0],a[1],a[2])||1;
  return [a[0]/l,a[1]/l,a[2]/l]}

// ---------------------------- binary PLY parser ---------------------------
function parsePLY(buf){
  const u8=new Uint8Array(buf);
  const endTag="end_header\n";
  let hdrEnd=-1;
  const probe=new TextDecoder().decode(u8.subarray(0,Math.min(65536,u8.length)));
  hdrEnd=probe.indexOf(endTag);
  if(hdrEnd<0)throw "no PLY header";
  const header=probe.slice(0,hdrEnd).split("\n");
  let nv=0,nf=0,props=[],inVert=false,little=true;
  for(const line of header){
    const t=line.trim().split(/\s+/);
    if(t[0]==="format")little=t[1].includes("little");
    if(t[0]==="element"&&t[1]==="vertex"){nv=+t[2];inVert=true}
    else if(t[0]==="element"){if(t[1]==="face")nf=+t[2];inVert=false}
    else if(t[0]==="property"&&inVert)props.push([t[1],t[t.length-1]]);
  }
  const sz={float:4,float32:4,double:8,uchar:1,uint8:1,char:1,int8:1,
            short:2,ushort:2,int:4,uint:4,int32:4,uint32:4};
  let stride=0;const off={};
  for(const [ty,nm] of props){off[nm]=[stride,ty];stride+=sz[ty]}
  const dv=new DataView(buf,hdrEnd+endTag.length);
  const pos=new Float32Array(nv*3), col=new Uint8Array(nv*3);
  const hasC="red" in off;
  const rd=(ty,o)=>ty==="double"?dv.getFloat64(o,little):
    (ty==="float"||ty==="float32")?dv.getFloat32(o,little):dv.getUint8(o);
  for(let i=0;i<nv;i++){
    const b=i*stride;
    pos[i*3]=rd(off.x[1],b+off.x[0]);
    pos[i*3+1]=rd(off.y[1],b+off.y[0]);
    pos[i*3+2]=rd(off.z[1],b+off.z[0]);
    if(hasC){col[i*3]=dv.getUint8(b+off.red[0]);
      col[i*3+1]=dv.getUint8(b+off.green[0]);
      col[i*3+2]=dv.getUint8(b+off.blue[0]);}
    else{col[i*3]=col[i*3+1]=col[i*3+2]=190}
  }
  // faces: list <uchar> <int32> — tolerate polygons by fanning
  let o=nv*stride;const idx=[];
  for(let i=0;i<nf;i++){
    const k=dv.getUint8(o);o+=1;
    const f=[];for(let j=0;j<k;j++){f.push(dv.getInt32(o,little));o+=4}
    for(let j=2;j<k;j++)idx.push(f[0],f[j-1],f[j]);
  }
  return {pos,col,idx:new Uint32Array(idx),nv,nf};
}

// ------------------------------- GL setup ---------------------------------
const canvas=document.getElementById("gl");
const gl=canvas.getContext("webgl2",{antialias:true});
if(!gl){document.getElementById("status").textContent="WebGL2 unavailable";
  throw "no webgl2"}
function shader(vs,fs){
  const mk=(t,src)=>{const s=gl.createShader(t);gl.shaderSource(s,src);
    gl.compileShader(s);
    if(!gl.getShaderParameter(s,gl.COMPILE_STATUS))
      throw gl.getShaderInfoLog(s);return s};
  const p=gl.createProgram();
  gl.attachShader(p,mk(gl.VERTEX_SHADER,vs));
  gl.attachShader(p,mk(gl.FRAGMENT_SHADER,fs));
  gl.linkProgram(p);
  if(!gl.getProgramParameter(p,gl.LINK_STATUS))
    throw gl.getProgramInfoLog(p);
  return p}
// mesh: vertex colors, flat shading via screen-space derivatives (no
// per-vertex normals needed — cheap for multi-million-triangle meshes)
const meshProg=shader(`#version 300 es
  layout(location=0) in vec3 aPos; layout(location=1) in vec3 aCol;
  uniform mat4 uMVP, uMV;
  out vec3 vCol; out vec3 vEye;
  void main(){ gl_Position=uMVP*vec4(aPos,1.0);
    vEye=(uMV*vec4(aPos,1.0)).xyz; vCol=aCol; }`,
  `#version 300 es
  precision highp float;
  in vec3 vCol; in vec3 vEye; out vec4 frag;
  void main(){
    vec3 n=normalize(cross(dFdx(vEye),dFdy(vEye)));
    float l=0.35+0.65*abs(n.z);
    frag=vec4(vCol*l,1.0); }`);
// lines: trajectories + frustum
const lineProg=shader(`#version 300 es
  layout(location=0) in vec3 aPos; uniform mat4 uMVP;
  void main(){ gl_Position=uMVP*vec4(aPos,1.0); }`,
  `#version 300 es
  precision highp float; uniform vec3 uColor; out vec4 frag;
  void main(){ frag=vec4(uColor,1.0); }`);

const mesh={vao:null,n:0};
function uploadMesh(m){
  if(mesh.vao)gl.deleteVertexArray(mesh.vao);
  mesh.vao=gl.createVertexArray();gl.bindVertexArray(mesh.vao);
  const pb=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,pb);
  gl.bufferData(gl.ARRAY_BUFFER,m.pos,gl.STATIC_DRAW);
  gl.enableVertexAttribArray(0);gl.vertexAttribPointer(0,3,gl.FLOAT,false,0,0);
  const cb=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,cb);
  gl.bufferData(gl.ARRAY_BUFFER,m.col,gl.STATIC_DRAW);
  gl.enableVertexAttribArray(1);
  gl.vertexAttribPointer(1,3,gl.UNSIGNED_BYTE,true,0,0);
  const ib=gl.createBuffer();gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER,ib);
  gl.bufferData(gl.ELEMENT_ARRAY_BUFFER,m.idx,gl.STATIC_DRAW);
  mesh.n=m.idx.length;gl.bindVertexArray(null);
  // auto-fit camera to the mesh bounds on first load
  let mn=[1e9,1e9,1e9],mx=[-1e9,-1e9,-1e9];
  for(let i=0;i<m.pos.length;i+=3)for(let d=0;d<3;d++){
    mn[d]=Math.min(mn[d],m.pos[i+d]);mx[d]=Math.max(mx[d],m.pos[i+d])}
  if(!cam.fitted){cam.ctr=[(mn[0]+mx[0])/2,(mn[1]+mx[1])/2,(mn[2]+mx[2])/2];
    cam.dist=1.4*Math.hypot(mx[0]-mn[0],mx[1]-mn[1],mx[2]-mn[2]);
    cam.fitted=true}
}
function lineBuf(){return {buf:gl.createBuffer(),n:0}}
const estL=lineBuf(),gtL=lineBuf(),frusL=lineBuf();
function setLine(l,arr){gl.bindBuffer(gl.ARRAY_BUFFER,l.buf);
  gl.bufferData(gl.ARRAY_BUFFER,new Float32Array(arr.flat()),gl.DYNAMIC_DRAW);
  l.n=arr.length}

// ------------------------------- camera -----------------------------------
const cam={th:0.9,ph:0.5,dist:6,ctr:[0,0,0],fitted:false};
let drag=null;
canvas.addEventListener("mousedown",e=>{drag={x:e.clientX,y:e.clientY,
  b:e.button};e.preventDefault()});
window.addEventListener("mouseup",()=>drag=null);
window.addEventListener("mousemove",e=>{
  if(!drag)return;
  const dx=e.clientX-drag.x,dy=e.clientY-drag.y;
  drag.x=e.clientX;drag.y=e.clientY;
  if(drag.b===2){ // pan in view plane
    const s=cam.dist*0.0013;
    const z=[Math.cos(cam.ph)*Math.cos(cam.th),Math.sin(cam.ph),
             Math.cos(cam.ph)*Math.sin(cam.th)];
    const x=norm3(cross3([0,1,0],z)),y=cross3(z,x);
    for(let d=0;d<3;d++)cam.ctr[d]+=(-dx*x[d]+dy*y[d])*s;
  }else{cam.th+=dx*0.008;
    cam.ph=Math.min(1.5,Math.max(-1.5,cam.ph+dy*0.008))}});
canvas.addEventListener("wheel",e=>{cam.dist*=Math.exp(e.deltaY*0.0012);
  e.preventDefault()},{passive:false});
canvas.addEventListener("contextmenu",e=>e.preventDefault());

// ------------------------------- render -----------------------------------
function draw(){
  const w=canvas.clientWidth,h=canvas.clientHeight;
  if(canvas.width!==w||canvas.height!==h){canvas.width=w;canvas.height=h}
  gl.viewport(0,0,w,h);
  gl.clearColor(0.082,0.094,0.114,1);
  gl.enable(gl.DEPTH_TEST);
  gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
  const eye=[cam.ctr[0]+cam.dist*Math.cos(cam.ph)*Math.cos(cam.th),
             cam.ctr[1]+cam.dist*Math.sin(cam.ph),
             cam.ctr[2]+cam.dist*Math.cos(cam.ph)*Math.sin(cam.th)];
  const V=lookAt(eye,cam.ctr,[0,1,0]);
  const P=persp(0.9,w/h,0.01,1e3);
  const MVP=mat4mul(P,V);
  if(mesh.n){gl.useProgram(meshProg);
    gl.uniformMatrix4fv(gl.getUniformLocation(meshProg,"uMVP"),false,MVP);
    gl.uniformMatrix4fv(gl.getUniformLocation(meshProg,"uMV"),false,V);
    gl.bindVertexArray(mesh.vao);
    gl.drawElements(gl.TRIANGLES,mesh.n,gl.UNSIGNED_INT,0);
    gl.bindVertexArray(null)}
  gl.useProgram(lineProg);
  gl.uniformMatrix4fv(gl.getUniformLocation(lineProg,"uMVP"),false,MVP);
  const uC=gl.getUniformLocation(lineProg,"uColor");
  for(const [l,c,mode] of [[estL,[0.30,0.55,1.0],gl.LINE_STRIP],
                           [gtL,[1.0,0.62,0.30],gl.LINE_STRIP],
                           [frusL,[0.55,1.0,0.55],gl.LINES]]){
    if(!l.n)continue;
    gl.bindBuffer(gl.ARRAY_BUFFER,l.buf);
    gl.enableVertexAttribArray(0);
    gl.vertexAttribPointer(0,3,gl.FLOAT,false,0,0);
    gl.uniform3fv(uC,c);
    gl.drawArrays(mode,0,l.n)}
  requestAnimationFrame(draw)}
requestAnimationFrame(draw);

// --------------------------- state polling --------------------------------
let curMesh=null,pinned="";
const snapSel=document.getElementById("snap");
snapSel.addEventListener("change",()=>{pinned=snapSel.value;
  if(pinned)loadMesh(pinned)});
async function loadMesh(name){
  document.getElementById("minfo").textContent=name+" …";
  const r=await fetch("/mesh/"+name);
  if(!r.ok)return;
  const m=parsePLY(await r.arrayBuffer());
  uploadMesh(m);curMesh=name;
  document.getElementById("minfo").textContent=
    name+" ("+(m.nv/1e6).toFixed(2)+"M v)";
}
function frustumLines(c2w,s){
  // camera actor: apex + image-plane rectangle in world space
  const o=[c2w[0][3],c2w[1][3],c2w[2][3]],pts=[];
  const corners=[[-s,-s*0.62,-s*1.2],[s,-s*0.62,-s*1.2],
                 [s,s*0.62,-s*1.2],[-s,s*0.62,-s*1.2]];
  const W=c=>[o[0]+c2w[0][0]*c[0]+c2w[0][1]*c[1]+c2w[0][2]*c[2],
              o[1]+c2w[1][0]*c[0]+c2w[1][1]*c[1]+c2w[1][2]*c[2],
              o[2]+c2w[2][0]*c[0]+c2w[2][1]*c[1]+c2w[2][2]*c[2]];
  const cw=corners.map(W);
  for(let i=0;i<4;i++){pts.push(o,cw[i],cw[i],cw[(i+1)%4])}
  return pts}
async function poll(){
  try{
    const r=await fetch("/state");
    if(!r.ok)throw 0;
    const s=await r.json();
    document.getElementById("status").textContent=
      s.done?"run complete":"live";
    document.getElementById("frame").textContent=s.frame+" / "+s.n_img;
    document.getElementById("fill").style.width=
      (100*(s.frame+1)/s.n_img)+"%";
    setLine(estL,s.est_t);setLine(gtL,s.gt_t);
    if(s.cur_c2w)setLine(frusL,frustumLines(s.cur_c2w,0.12));
    // keep the snapshot dropdown in sync
    const have=new Set([...snapSel.options].map(o=>o.value));
    for(const m of s.meshes||[])if(!have.has(m)){
      const o=document.createElement("option");o.value=o.textContent=m;
      snapSel.appendChild(o)}
    const want=pinned||s.mesh;
    if(want&&want!==curMesh)await loadMesh(want);
  }catch(e){document.getElementById("status").textContent="waiting for run…"}
  setTimeout(poll,2000)}
poll();
</script></body></html>
"""
