"""Interactive progressive viewer — the reference's GLUT window, headless.

The reference drives rendering through a GLUT window (main.scm:493-573):
each frame traces one scanline, re-uploads the framebuffer as a GL
texture, shows the pass count in the window title, and binds keys
'z' (toggle rendering, :549-550), 'S' (save PPM, :551-552) and a mouse
probe that logs the clicked pixel (:555-561).  An accelerator host is
headless, so the window becomes a **browser page served from the render
process**:

  * the render loop refines whole passes (the pool traces the full frame
    per chunk — scanlines are a serial-interpreter artifact, not an
    estimator choice) and publishes the tonemapped frame as a PNG;
  * the page polls the PNG and shows "pass N" as the title (the
    reference's window-title sample counter, :543);
  * key 'z' toggles rendering, 's' saves a PPM server-side — same
    bindings as the reference;
  * clicking the image probes the pixel: the reference logged
    (x, 199-y) to stderr; here the probe returns the pixel's actual
    accumulated radiance + display value (strictly more debug signal),
    and the full per-sample trace remains available via the `probe` CLI.

Everything is Python stdlib (http.server + a 20-line zlib PNG encoder) —
no GL, no display, no extra dependencies.  Run:

    python -m scheme_raytrace view --scene cornell --nx 256 --ny 256 \
        --light-sampling --port 8808
"""

from __future__ import annotations

import json
import struct
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np


# --- minimal PNG encoder (RGB8, no filtering) -------------------------------

def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def png_encode(img: np.ndarray) -> bytes:
    """u8 [ny, nx, 3], row 0 = image TOP (display order) -> PNG bytes."""
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw, 6))
            + _chunk(b"IEND", b""))


_PAGE = """<!doctype html><html><head><title>scheme_raytrace</title>
<style>body{background:#111;color:#ddd;font:14px monospace;margin:1em}
img{image-rendering:pixelated;border:1px solid #444;cursor:crosshair}
#log{white-space:pre;margin-top:.5em}</style></head><body>
<div id="title">connecting…</div>
<img id="frame" width="%(w)d" height="%(h)d">
<div id="log">z: toggle render &nbsp; s: save PPM &nbsp; click: probe pixel</div>
<script>
const img=document.getElementById('frame'),log=document.getElementById('log');
async function tick(){
  const st=await (await fetch('status')).json();
  document.getElementById('title').textContent=
    `${st.scene} — pass ${st.samples}`+(st.paused?' [paused]':'')
    +(st.rays_per_s?` — ${(st.rays_per_s/1e6).toFixed(1)} Mrays/s`:'');
  document.title=`pass ${st.samples}`;
  img.src='frame.png?t='+Date.now();
}
setInterval(tick,1000);tick();
img.onclick=async e=>{
  const r=img.getBoundingClientRect();
  const x=Math.floor((e.clientX-r.left)*%(w)d/r.width);
  const yTop=Math.floor((e.clientY-r.top)*%(h)d/r.height);
  const p=await (await fetch(`probe?x=${x}&y=${%(h)d-1-yTop}`)).json();
  log.textContent=JSON.stringify(p);
};
document.onkeydown=async e=>{
  if(e.key==='z') await fetch('toggle',{method:'POST'});
  if(e.key==='s'){const r=await (await fetch('save',{method:'POST'})).json();
                  log.textContent='saved '+r.path;}
};
</script></body></html>"""


class Viewer:
    """Progressive render loop + HTTP server sharing one frame buffer.

    The render loop (render_loop(), blocking) owns the JAX state; the
    server threads only read the latest published (u8 frame, stats) and
    set flags (paused / save / stop) — one lock, no tearing.
    """

    def __init__(self, scene, cam, config, scene_name="scene",
                 spp_target=0, out="view.ppm", host="127.0.0.1", port=0,
                 chunk=None):
        from . import render as R
        self._R = R
        self.scene, self.cam, self.config = scene, cam, config
        self.scene_name = scene_name
        self.spp_target = spp_target          # 0 = unbounded (reference UX)
        self.out = out
        self.chunk = chunk or config.spp
        self.lock = threading.Lock()
        self.frame_png = png_encode(
            np.zeros((config.ny, config.nx, 3), np.uint8))
        self.samples = 0
        self.rays_per_s = 0.0
        self.paused = False                   # 'z' (main.scm:549-550)
        self._mean = np.zeros((config.ny, config.nx, 3), np.float32)
        self._stop = threading.Event()

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):      # quiet server
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
                if u.path == "/":
                    page = _PAGE % {"w": config.nx, "h": config.ny}
                    self._send(200, "text/html", page.encode())
                elif u.path == "/frame.png":
                    with viewer.lock:
                        body = viewer.frame_png
                    self._send(200, "image/png", body)
                elif u.path == "/status":
                    with viewer.lock:
                        st = dict(scene=viewer.scene_name,
                                  samples=viewer.samples,
                                  rays_per_s=viewer.rays_per_s,
                                  paused=viewer.paused)
                    self._send(200, "application/json",
                               json.dumps(st).encode())
                elif u.path == "/probe":
                    q = parse_qs(u.query)
                    try:
                        x = int(q.get("x", ["0"])[0])
                        y = int(q.get("y", ["0"])[0])  # row 0 = image bottom
                    except ValueError:
                        self._send(400, "application/json", json.dumps(
                            dict(error="x/y must be integers")).encode())
                        return
                    x = min(max(x, 0), config.nx - 1)
                    y = min(max(y, 0), config.ny - 1)
                    with viewer.lock:
                        mean = viewer._mean[y, x].tolist()
                        n = viewer.samples
                    g = np.minimum(np.sqrt(np.maximum(mean, 0.0)), 1.0)
                    u8 = [int(c) for c in np.floor(255.99 * g)]
                    self._send(200, "application/json", json.dumps(
                        dict(x=x, y=y, samples=n, mean_radiance=mean,
                             display_u8=u8)).encode())
                else:
                    self._send(404, "text/plain", b"not found")

            def do_POST(self):
                if self.path == "/toggle":
                    with viewer.lock:
                        viewer.paused = not viewer.paused
                        paused = viewer.paused
                    self._send(200, "application/json",
                               json.dumps(dict(paused=paused)).encode())
                elif self.path == "/save":
                    # write directly here (not via a flag serviced by the
                    # render loop): a bounded run's loop may have exited,
                    # and the reply must mean "the file exists now"
                    with viewer.lock:
                        mean = viewer._mean.copy()
                    viewer._R.write_ppm(viewer.out, mean)
                    self._send(200, "application/json",
                               json.dumps(dict(path=viewer.out)).encode())
                else:
                    self._send(404, "text/plain", b"not found")

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self._server_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True)

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start_server(self):
        self._server_thread.start()

    def stop(self):
        self._stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()   # release the listening socket now

    def _publish(self, state, seg, dt):
        mean = np.asarray(state.raw_sum).reshape(
            self.config.ny, self.config.nx, 3)
        mean = mean / max(int(state.sample_count), 1)
        u8 = np.asarray(self._R.to_u8(mean))
        with self.lock:
            self._mean = mean
            self.frame_png = png_encode(u8[::-1])   # row 0 bottom -> top
            self.samples = int(state.sample_count)
            self.rays_per_s = int(seg) / max(dt, 1e-9)

    def render_loop(self):
        """Blocking progressive refinement until stop() or spp_target."""
        import jax
        R, config = self._R, self.config
        state = R.init_state(config)
        while not self._stop.is_set():
            with self.lock:
                paused = self.paused
            done = int(state.sample_count)
            if paused or (self.spp_target and done >= self.spp_target):
                if self.spp_target and done >= self.spp_target \
                        and not paused:
                    break                    # bounded run complete
                time.sleep(0.05)
                continue
            chunk = self.chunk
            if self.spp_target:
                chunk = min(chunk, self.spp_target - done)
            cc = config.replace(spp=chunk)
            t0 = time.perf_counter()
            state, seg, _ = R.render_with_stats(self.scene, self.cam, cc,
                                                state)
            jax.block_until_ready(state.raw_sum)
            self._publish(state, seg, time.perf_counter() - t0)
        return state
