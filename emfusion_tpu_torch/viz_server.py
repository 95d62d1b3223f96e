"""Live interactive model viewer over HTTP (a headless 3-D window).

Port of ``emfusion_tpu/viz_server.py``: the reference's ``cv::viz``
window and image windows (``EMFusion.cpp:162-233``,
``apps/EM-Fusion.cpp:169-186``) as a small stdlib HTTP server beside the
pipeline, with the same endpoints and pages:

  * ``/``            control page: live stream + orbit controls
  * ``/stream``      MJPEG stream of the per-frame model rendering
                     (``io.codecs.encode_jpeg``, quality 85)
  * ``/frame.png``   latest per-frame rendering
  * ``/view.png?yaw=0.5&pitch=-0.25&dist=1.0``
                     the CURRENT fused model from a virtual orbit camera
                     (``viz.render_orbit_view``: K4 from outside the
                     volume, the composite, Phong, box and frustum widgets)
  * ``/scene``       an inline WebGL viewer (no external JS) of
  * ``/mesh.bin``    the current meshes (background and objects, the
                     port's marching cubes, world frame): u32 n_meshes,
                     then per mesh u32 nv, u32 nt, f32 verts (nv, 3), f32
                     normals (nv, 3), u32 tris (nt, 3), little-endian
  * ``/mesh.ply``    the background mesh as PLY
  * ``/status``      JSON: frame index, active object ids, camera pose

and 404 elsewhere. It binds to loopback unless asked otherwise
(``--serve-host``): the stream shows the scene and the camera's poses
with no authentication.

Thread safety. The JAX viewer's handler threads read the pipeline's
immutable state freely. The port's kernels update the volumes in place,
so a render or a mesh extraction on a handler thread could read a
half-fused volume, or interleave its kernel launches with a frame's.
Every render, extraction and status read here therefore holds the
pipeline's ``lock``, which ``EMFusionPipeline.process_frame`` holds for
the whole frame (and :meth:`LiveViewer.publish` while it renders): each
sees one whole frame's state, and a request waits at most one frame.

A sharded run (a pipeline on a ``mesh`` of more than one rank). Rank 0
holds the viewer. ``/frame.png``, ``/stream`` and ``/status`` read what
rank 0 holds (the composite of the frame's own collective raycast, and
the host state, which every rank keeps whole) and are served as on one
rank. An orbit view gathers every rank's nearest object surface, and the
meshes come from the z-sharded marching cubes and the gathered pool: all
ranks must take part, and a handler thread never calls a collective. So
a handler queues such a request on rank 0 and waits; at each frame
boundary every rank calls :func:`serve_step`, in which rank 0 broadcasts
the queued requests (their number, then each one's kind and orbit; one
broadcast of 8 bytes when there is none), every rank runs them in order,
and rank 0 hands each result to its handler. A request waits at most one
frame, as on one rank. :func:`serve_close` ends a run: a last step, then
the viewer closes and every handler still waiting gets a 503. Without a
mesh both are no-ops beside :meth:`LiveViewer.close`.

Needs nothing beyond the standard library, numpy and the port. Enable
with ``apps.run_emfusion --serve PORT``.
"""

from __future__ import annotations

import json
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from emfusion_tpu_torch.distributed import comm
from emfusion_tpu_torch.io.codecs import encode_jpeg, encode_png
from emfusion_tpu_torch.io.writers import (
    background_mesh, object_meshes, ply_bytes,
)
from emfusion_tpu_torch.viz import render_orbit_view

_SCENE_PAGE = """<!doctype html>
<html><head><title>emfusion-tpu scene</title><style>
body { background:#111; color:#ddd; font-family: monospace; margin:0; }
#hud { position:fixed; top:8px; left:8px; }
canvas { display:block; }
a { color:#8cf; }
</style></head><body>
<div id="hud">emfusion-tpu 3-D scene — drag to orbit, wheel to zoom,
<a href="/mesh.ply">download .ply</a> <span id="st">loading mesh…</span></div>
<canvas id="c"></canvas>
<script>
const cv = document.getElementById('c');
cv.width = innerWidth; cv.height = innerHeight;
const gl = cv.getContext('webgl');
const VS = `attribute vec3 p; attribute vec3 n; uniform mat4 mvp, mv;
varying vec3 vn; varying float vk;
void main(){ gl_Position = mvp*vec4(p,1.0);
  vn = mat3(mv)*n; vk = p.y; }`;
const FS = `precision mediump float; varying vec3 vn; varying float vk;
void main(){ vec3 N = normalize(vn);
  float d = max(dot(N, normalize(vec3(0.3,0.6,0.8))), 0.0);
  vec3 base = mix(vec3(0.55,0.65,0.8), vec3(0.85,0.75,0.55),
                  clamp(vk*0.5+0.5, 0.0, 1.0));
  gl_FragColor = vec4(base*(0.25+0.75*d), 1.0); }`;
function sh(t,s){const o=gl.createShader(t);gl.shaderSource(o,s);
  gl.compileShader(o);return o;}
const pr = gl.createProgram();
gl.attachShader(pr, sh(gl.VERTEX_SHADER, VS));
gl.attachShader(pr, sh(gl.FRAGMENT_SHADER, FS));
gl.linkProgram(pr); gl.useProgram(pr);
gl.enable(gl.DEPTH_TEST);
let meshes = [], yaw=0.6, pitch=-0.4, dist=2.0, ctr=[0,0,0];
function mat(){
  const a=Math.cos(yaw),b=Math.sin(yaw),c=Math.cos(pitch),d=Math.sin(pitch);
  const eye=[ctr[0]+dist*b*c, ctr[1]-dist*d, ctr[2]-dist*a*c];
  const f=norm3(sub(ctr,eye)), r=norm3(cross(f,[0,-1,0])), u=cross(r,f);
  const V=[r[0],u[0],-f[0],0, r[1],u[1],-f[1],0, r[2],u[2],-f[2],0,
    -dot3(r,eye),-dot3(u,eye),dot3(f,eye),1];
  const asp=cv.width/cv.height, fov=1.0, zn=0.05, zf=100.0;
  const t=1/Math.tan(fov/2);
  const P=[t/asp,0,0,0, 0,t,0,0, 0,0,(zf+zn)/(zn-zf),-1,
    0,0,2*zf*zn/(zn-zf),0];
  return [m4mul(P,V), V];
}
function sub(a,b){return [a[0]-b[0],a[1]-b[1],a[2]-b[2]];}
function dot3(a,b){return a[0]*b[0]+a[1]*b[1]+a[2]*b[2];}
function cross(a,b){return [a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],
  a[0]*b[1]-a[1]*b[0]];}
function norm3(a){const l=Math.hypot(a[0],a[1],a[2])||1;
  return [a[0]/l,a[1]/l,a[2]/l];}
function m4mul(A,B){const o=new Array(16);
  for(let i=0;i<4;i++)for(let j=0;j<4;j++){let s=0;
    for(let k=0;k<4;k++)s+=A[k*4+j]*B[i*4+k];o[i*4+j]=s;}return o;}
function draw(){
  gl.viewport(0,0,cv.width,cv.height);
  gl.clearColor(0.07,0.07,0.07,1);
  gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
  const [MVP,MV]=mat();
  gl.uniformMatrix4fv(gl.getUniformLocation(pr,'mvp'),false,MVP);
  gl.uniformMatrix4fv(gl.getUniformLocation(pr,'mv'),false,MV);
  for(const m of meshes){
    gl.bindBuffer(gl.ARRAY_BUFFER,m.vb);
    const lp=gl.getAttribLocation(pr,'p');
    gl.enableVertexAttribArray(lp);
    gl.vertexAttribPointer(lp,3,gl.FLOAT,false,0,0);
    gl.bindBuffer(gl.ARRAY_BUFFER,m.nb);
    const ln=gl.getAttribLocation(pr,'n');
    gl.enableVertexAttribArray(ln);
    gl.vertexAttribPointer(ln,3,gl.FLOAT,false,0,0);
    gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER,m.ib);
    gl.drawElements(gl.TRIANGLES,m.nt*3,gl.UNSIGNED_INT,0);
  }
}
let drag=false,lx=0,ly=0;
cv.onmousedown=e=>{drag=true;lx=e.clientX;ly=e.clientY;};
onmouseup=()=>drag=false;
onmousemove=e=>{if(!drag)return;
  yaw+=(e.clientX-lx)*0.008; pitch+=(e.clientY-ly)*0.008;
  pitch=Math.max(-1.5,Math.min(1.5,pitch)); lx=e.clientX;ly=e.clientY;
  draw();};
cv.onwheel=e=>{dist*=e.deltaY>0?1.1:0.9; draw(); e.preventDefault();};
fetch('/mesh.bin').then(r=>r.arrayBuffer()).then(buf=>{
  gl.getExtension('OES_element_index_uint');
  const dv=new DataView(buf); let off=0;
  const nm=dv.getUint32(off,true); off+=4;
  let lo=[1e9,1e9,1e9], hi=[-1e9,-1e9,-1e9], tot=0;
  for(let i=0;i<nm;i++){
    const nv=dv.getUint32(off,true), nt=dv.getUint32(off+4,true); off+=8;
    const v=new Float32Array(buf,off,nv*3); off+=nv*12;
    const n=new Float32Array(buf,off,nv*3); off+=nv*12;
    const t=new Uint32Array(buf,off,nt*3); off+=nt*12;
    for(let k=0;k<nv*3;k+=3)for(let a=0;a<3;a++){
      lo[a]=Math.min(lo[a],v[k+a]); hi[a]=Math.max(hi[a],v[k+a]);}
    const vb=gl.createBuffer();
    gl.bindBuffer(gl.ARRAY_BUFFER,vb);
    gl.bufferData(gl.ARRAY_BUFFER,v,gl.STATIC_DRAW);
    const nb=gl.createBuffer();
    gl.bindBuffer(gl.ARRAY_BUFFER,nb);
    gl.bufferData(gl.ARRAY_BUFFER,n,gl.STATIC_DRAW);
    const ib=gl.createBuffer();
    gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER,ib);
    gl.bufferData(gl.ELEMENT_ARRAY_BUFFER,t,gl.STATIC_DRAW);
    meshes.push({vb,nb,ib,nt}); tot+=nv;
  }
  ctr=[(lo[0]+hi[0])/2,(lo[1]+hi[1])/2,(lo[2]+hi[2])/2];
  dist=1.6*Math.max(hi[0]-lo[0],hi[1]-lo[1],hi[2]-lo[2]);
  document.getElementById('st').textContent=
    ` ${nm} mesh(es), ${tot} verts`;
  draw();
}).catch(e=>{document.getElementById('st').textContent=' mesh load failed: '+e;});
</script></body></html>"""

_PAGE = """<!doctype html>
<html><head><title>emfusion-tpu live</title><style>
body { background:#111; color:#ddd; font-family: monospace; }
img { border: 1px solid #444; }
#controls { margin: 8px 0; }
button { background:#222; color:#ddd; border:1px solid #555;
         padding:4px 10px; margin-right:4px; }
</style></head><body>
<h3>emfusion-tpu live</h3>
<div id="controls">
  <button onclick="mode='stream';refresh()">camera view (live)</button>
  <button onclick="orbit(-0.3,0)">&#8592;</button>
  <button onclick="orbit(0.3,0)">&#8594;</button>
  <button onclick="orbit(0,-0.15)">&#8593;</button>
  <button onclick="orbit(0,0.15)">&#8595;</button>
  <button onclick="zoom(0.8)">+</button>
  <button onclick="zoom(1.25)">-</button>
  <a href="/scene" style="color:#8cf">3-D mesh scene</a>
  <span id="st"></span>
</div>
<img id="view" src="/stream" width="640">
<script>
let yaw=0, pitch=-0.25, dist=1.0, mode='stream';
function orbit(dy, dp) { yaw+=dy; pitch+=dp; mode='orbit'; refresh(); }
function zoom(f) { dist*=f; mode='orbit'; refresh(); }
function refresh() {
  const img = document.getElementById('view');
  img.src = (mode=='stream') ? '/stream'
    : `/view.png?yaw=${yaw}&pitch=${pitch}&dist=${dist}&t=${Date.now()}`;
}
document.addEventListener('keydown', e => {
  if (e.key=='ArrowLeft') orbit(-0.3,0);
  if (e.key=='ArrowRight') orbit(0.3,0);
  if (e.key=='ArrowUp') orbit(0,-0.15);
  if (e.key=='ArrowDown') orbit(0,0.15);
});
setInterval(async () => {
  const s = await (await fetch('/status')).json();
  document.getElementById('st').textContent =
    ` frame ${s.frame}  objects ${JSON.stringify(s.objects)}`;
}, 1000);
</script></body></html>"""


JPEG_QUALITY = 85   # the JAX viewer's (viz_server.py:214-219)

# the kinds of request that a sharded run's ranks run together
VIEW, SCENE = 1, 2


class Unavailable(Exception):
    """The viewer closed before it could answer (a 503)."""


class _Request:
    """A queued request of a sharded run's viewer: its kind, its orbit
    (yaw, pitch, dist; zeros for a scene), the handlers that wait for its
    result and the result (an exception raised instead, or
    :class:`Unavailable`)."""

    def __init__(self, kind: int, orbit=(0.0, 0.0, 0.0)):
        self.kind, self.orbit = kind, tuple(float(v) for v in orbit)
        self.done = threading.Event()
        self.also = []          # scene requests answered with this one's
        self.result = None

    def answer(self, result) -> None:
        for r in [self] + self.also:
            r.result = result
            r.done.set()


def scene_meshes(pipe):
    """The current meshes [(verts, norms, tris), ...]: the background and
    each live object (voxels with weight and, for an object, a foreground
    probability above 0.5), in the world frame, under the pipeline's lock.
    On a mesh every rank calls it (the background's marching cubes runs
    over the z-slabs and the pool is gathered) and rank 0 gets the meshes,
    the others None."""
    with pipe.lock:
        bg = background_mesh(pipe)
        objs = object_meshes(pipe)
        if not pipe.is_writer:
            return None
        v, n, t = bg
        bg_pose = pipe.state.bg_pose.numpy()
        meshes = [((v @ bg_pose[:3, :3].T + bg_pose[:3, 3]
                    ).astype(np.float32),
                   (n @ bg_pose[:3, :3].T).astype(np.float32),
                   t.astype(np.uint32))]
        poses = pipe.state.objs.pose.numpy()
        for oid, (v2, n2, t2) in objs.items():
            if not len(v2):
                continue
            T = poses[pipe._slot_of(oid)]
            meshes.append(((v2 @ T[:3, :3].T + T[:3, 3]).astype(np.float32),
                           (n2 @ T[:3, :3].T).astype(np.float32),
                           t2.astype(np.uint32)))
    return meshes


def orbit_view(pipe, yaw: float, pitch: float, dist: float):
    """The model from the orbit camera at ``dist`` x the default radius
    (:func:`~emfusion_tpu_torch.viz.render_orbit_view`; None on a mesh's
    ranks but 0, which take part in its raycast only)."""
    p = pipe.params
    base_r = 1.1 * max(p.globalVolumeDims) * p.globalVoxelSize
    return render_orbit_view(pipe, yaw, pitch=pitch, radius=dist * base_r)


def serve_step(pipe, viewer=None) -> int:
    """A sharded run's service step at a frame boundary (see the module's
    docstring): every rank of ``pipe.mesh`` calls it between frames, rank
    0 with its :class:`LiveViewer`, the others with None. Rank 0
    broadcasts the requests its handlers queued, every rank runs them in
    order, rank 0 answers them. Without a mesh it does nothing. Returns
    the requests run."""
    mesh = pipe.mesh
    if mesh is None:
        return 0
    jobs = viewer._take(pipe.frame) if viewer is not None else []
    n = comm.broadcast(mesh.world, torch.tensor([len(jobs)]), 0)
    if not int(n[0]):
        return 0
    spec = torch.tensor([[r.kind, *r.orbit] for r in jobs],
                        dtype=torch.float64) if jobs else \
        torch.zeros((int(n[0]), 4), dtype=torch.float64)
    comm.broadcast(mesh.world, spec, 0)
    for i, (kind, yaw, pitch, dist) in enumerate(spec.tolist()):
        try:
            out = (orbit_view(pipe, yaw, pitch, dist) if int(kind) == VIEW
                   else scene_meshes(pipe))
        except Exception as e:   # the handler answers a 500
            out = e
        if viewer is not None:
            if int(kind) == SCENE and not isinstance(out, Exception):
                viewer._scene_cache = (pipe.frame, out)
            jobs[i].answer(out)
    return len(spec)


def serve_close(pipe, viewer=None, final_step: bool = True) -> None:
    """The end of a run's viewer: with ``final_step`` (the frames ended
    without an error, so every rank is here), a last :func:`serve_step`;
    then rank 0's viewer closes, and every handler still waiting gets a
    503."""
    try:
        if final_step:
            serve_step(pipe, viewer)
    finally:
        if viewer is not None:
            viewer.close()


class LiveViewer:
    """Background HTTP viewer of a pipeline; call :meth:`publish` after
    each processed frame and :meth:`close` at the end."""

    def __init__(self, pipe, port: int = 0, host: str = "127.0.0.1"):
        self.pipe = pipe
        self._latest = None            # (jpeg bytes, the image)
        self._latest_seq = 0
        self._closed = False
        self._cond = threading.Condition()
        self._scene_cache = None
        self._queue = []               # a sharded run's requests
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                try:
                    if u.path == "/":
                        self._send(200, "text/html", _PAGE.encode())
                    elif u.path == "/frame.png":
                        self._send(200, "image/png",
                                   encode_png(viewer.latest_image()))
                    elif u.path == "/view.png":
                        q = parse_qs(u.query)

                        def f(k, d):
                            return float(q.get(k, [d])[0])

                        img = viewer.render_view(
                            f("yaw", 0.0), f("pitch", -0.25),
                            f("dist", 1.0))
                        self._send(200, "image/png", encode_png(img))
                    elif u.path == "/scene":
                        self._send(200, "text/html", _SCENE_PAGE.encode())
                    elif u.path == "/mesh.bin":
                        self._send(200, "application/octet-stream",
                                   viewer.mesh_bin())
                    elif u.path == "/mesh.ply":
                        self._send(200, "application/octet-stream",
                                   viewer.mesh_ply())
                    elif u.path == "/status":
                        self._send(200, "application/json",
                                   json.dumps(viewer.status()).encode())
                    elif u.path == "/stream":
                        self._stream()
                    else:
                        self._send(404, "text/plain", b"not found")
                except (BrokenPipeError, ConnectionResetError):
                    pass
                except Unavailable:
                    self._send(503, "text/plain", b"viewer closed")
                except Exception as e:  # keep the viewer alive
                    try:
                        self._send(500, "text/plain",
                                   f"{type(e).__name__}: {e}".encode())
                    except Exception:
                        pass

            def _stream(self):
                self.send_response(200)
                self.send_header(
                    "Content-Type", "multipart/x-mixed-replace; boundary=emf")
                self.end_headers()
                seq = -1
                while True:
                    with viewer._cond:
                        viewer._cond.wait_for(
                            lambda: viewer._latest_seq != seq
                            or viewer._closed, timeout=5.0)
                        if viewer._closed:
                            return
                        seq = viewer._latest_seq
                        latest = viewer._latest
                    data = (latest[0] if latest is not None else
                            encode_jpeg(viewer.latest_image(), JPEG_QUALITY))
                    self.wfile.write(b"--emf\r\n")
                    self.wfile.write(b"Content-Type: image/jpeg\r\n")
                    self.wfile.write(
                        f"Content-Length: {len(data)}\r\n\r\n".encode())
                    self.wfile.write(data)
                    self.wfile.write(b"\r\n")
                    self.wfile.flush()

        self.server = ThreadingHTTPServer((host, port), Handler)
        self.server.daemon_threads = True
        self.port = self.server.server_port
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    def publish(self, img: np.ndarray | None = None) -> None:
        """Publish the per-frame rendering (default: ``pipe.render()``,
        under the pipeline's lock) to ``/stream`` and ``/frame.png``."""
        if img is None:
            with self.pipe.lock:
                img = self.pipe.render()
        img = np.ascontiguousarray(img, np.uint8)
        data = encode_jpeg(img, JPEG_QUALITY)
        with self._cond:
            self._latest = (data, img)
            self._latest_seq += 1
            self._cond.notify_all()

    def latest_image(self) -> np.ndarray:
        """The last published rendering (black before the first)."""
        latest = self._latest
        if latest is not None:
            return latest[1]
        return np.zeros((self.pipe.H, self.pipe.W, 3), np.uint8)

    def render_view(self, yaw: float, pitch: float,
                    dist: float) -> np.ndarray:
        """The model from the orbit camera at ``dist`` x the default
        radius (:func:`orbit_view`, which holds the pipeline's lock); on
        a mesh, queued for the next :func:`serve_step`."""
        if self.pipe.mesh is not None:
            return self._ask(_Request(VIEW, (yaw, pitch, dist)))
        return orbit_view(self.pipe, yaw, pitch, dist)

    def _extract_scene(self):
        """The current meshes (:func:`scene_meshes`), cached per pipeline
        frame (a 512^3 extraction takes a tenth of a second on the card,
        seconds on a CPU); on a mesh, queued for the next
        :func:`serve_step`."""
        pipe = self.pipe
        if pipe.mesh is not None:
            return self._ask(_Request(SCENE))
        with pipe.lock:
            cached = self._scene_cache
            if cached is not None and cached[0] == pipe.frame:
                return cached[1]
            meshes = scene_meshes(pipe)
            self._scene_cache = (pipe.frame, meshes)
        return meshes

    def _ask(self, req: _Request):
        """Queue a sharded run's request and wait for its answer (a
        handler thread): raises :class:`Unavailable` once the viewer has
        closed, and what the request raised."""
        with self._cond:
            if self._closed:
                raise Unavailable()
            self._queue.append(req)
        req.done.wait()
        if isinstance(req.result, Exception):
            raise req.result
        return req.result

    def _take(self, frame: int):
        """The queued requests that :func:`serve_step` runs at pipeline
        frame ``frame`` (rank 0): a scene request is answered from the
        cache of this frame where there is one, and scene requests share
        one extraction."""
        with self._cond:
            reqs, self._queue = self._queue, []
        jobs, scene = [], None
        for r in reqs:
            if r.kind != SCENE:
                jobs.append(r)
            elif self._scene_cache is not None and \
                    self._scene_cache[0] == frame:
                r.answer(self._scene_cache[1])
            elif scene is None:
                scene = r
                jobs.append(r)
            else:
                scene.also.append(r)
        return jobs

    def queued(self) -> int:
        """The requests waiting for the next :func:`serve_step`."""
        with self._cond:
            return len(self._queue)

    def mesh_bin(self) -> bytes:
        """The scene in the inline WebGL viewer's format (``/mesh.bin``
        in the module docstring)."""
        meshes = self._extract_scene()
        parts = [struct.pack("<I", len(meshes))]
        for v, n, t in meshes:
            parts.append(struct.pack("<II", len(v), len(t)))
            parts.append(np.ascontiguousarray(v, "<f4").tobytes())
            parts.append(np.ascontiguousarray(n, "<f4").tobytes())
            parts.append(np.ascontiguousarray(t, "<u4").tobytes())
        return b"".join(parts)

    def mesh_ply(self) -> bytes:
        """The background mesh as an ASCII PLY file."""
        v, n, t = self._extract_scene()[0]
        return ply_bytes(v, n, t.astype(np.int64))

    def status(self) -> dict:
        pipe = self.pipe
        with pipe.lock:
            return {
                "frame": pipe.frame,
                "objects": pipe.active_object_ids,
                "cam_pose": [[float(v) for v in row]
                             for row in pipe.cam_pose],
            }

    def close(self) -> None:
        """Stop the server, end every open stream and answer every queued
        request with a 503."""
        with self._cond:
            self._closed = True
            reqs, self._queue = self._queue, []
            self._cond.notify_all()
        for r in reqs:
            r.answer(Unavailable())
        self.server.shutdown()
        self.server.server_close()
        self._thread.join()
