"""Interactive viewer tests (viewer.py — the reference's GLUT progressive
window, main.scm:493-573, redesigned as a browser page served from the
render process).  Covers the pure-stdlib PNG encoder and the full HTTP
surface: page, frame, status/pass-counter, pixel probe ('mouse click',
:555-561), pause toggle ('z', :549-550) and PPM save ('S', :551-552)."""

import io
import json
import os
import urllib.request

import numpy as np

from scheme_raytrace import scenes
from scheme_raytrace.config import RenderConfig
from scheme_raytrace.scene import compile_scene
from scheme_raytrace.viewer import Viewer, png_encode


def test_png_encode_roundtrip():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (7, 5, 3), dtype=np.uint8)
    data = png_encode(img)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    try:
        from PIL import Image
    except ImportError:
        return                      # magic + structure checked above
    back = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(back, img)


def test_viewer_end_to_end(tmp_path):
    spec = scenes.cornell_box()
    scene = compile_scene(spec.objects, sky=spec.sky)
    cam = spec.camera(aspect=1.0)
    cfg = RenderConfig(nx=16, ny=16, spp=1, max_depth=4,
                       light_sampling=True, pool_rays=256)
    out = str(tmp_path / "view.ppm")
    v = Viewer(scene, cam, cfg, scene_name="cornell", spp_target=2,
               out=out, port=0, chunk=1)
    v.start_server()
    base = f"http://127.0.0.1:{v.port}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=30) as r:
            return r.read()

    def post(path):
        req = urllib.request.Request(base + path, method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.read()

    try:
        # page + endpoints serve before any pass completes
        assert b"scheme_raytrace" in get("/")
        assert json.loads(get("/status"))["samples"] == 0

        # 'z' toggle flips the paused flag both ways
        assert json.loads(post("/toggle"))["paused"] is True
        assert json.loads(post("/toggle"))["paused"] is False

        # queue an 'S' save, then run the bounded loop (2 passes)
        post("/save")
        state = v.render_loop()
        assert int(state.sample_count) == 2
        assert os.path.exists(out)          # save honored inside the loop

        st = json.loads(get("/status"))
        assert st["samples"] == 2 and st["scene"] == "cornell"
        assert st["rays_per_s"] > 0

        frame = get("/frame.png")
        assert frame[:8] == b"\x89PNG\r\n\x1a\n" and len(frame) > 100

        p = json.loads(get("/probe?x=8&y=8"))
        assert p["samples"] == 2 and len(p["mean_radiance"]) == 3
        assert all(0 <= c <= 255 for c in p["display_u8"])
        # a lit Cornell interior pixel accumulated something
        assert max(p["mean_radiance"]) > 0.0
    finally:
        v.stop()
