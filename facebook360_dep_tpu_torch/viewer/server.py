"""Interactive 6DoF viewer server, the GlViewer equivalent. The port of
``facebook360_dep_tpu/viewer/server.py``.

The reference GlViewer (``viewer/GlViewer.cpp:57``) is a GLFW window around
``RigScene``: per camera, the simplified equi-error mesh is displaced along
per-pixel rays by depth in a vertex shader, all cameras are accumulated into
an RGBA32F framebuffer with cone-alpha premultiplied blending, and a resolve
pass divides out the weight (``render/RigScene.cpp:195-320, 995-1035``).

The GL runtime here is the browser: this module serves the fused stream
(``fused.json`` + stripe files, through the same ``stream.fusion`` reader
the offline viewer uses) to an embedded WebGL2 page (``page.py``) that runs
the same pipeline: per-camera displaced meshes, cone-alpha accumulate into a
float framebuffer, resolve divide.

Host only, by design: the host does what the host did in the reference
(striped reads, BC7 decode, the per-vertex camera math on CPU float64
tensors, PNG encode with the port's own codec), and the GPU work is the
browser's. The server never looks for a card and takes no device.

Endpoints:
- ``/``                         the viewer page
- ``/scene.json``               rig + frame list + per-camera metadata
- ``/mesh/<frame>/<cam>.bin``   u32 V, u32 F, f32 pos[V*3], f32 uv[V*2], u32 idx[F*3]
- ``/bgmesh/<frame>/<cam>.bin`` the background layer's mesh, same layout
- ``/color/<frame>/<cam>.png``  decoded subframe color (BC7 -> RGB PNG on the host)

The cull probes of ``/scene.json`` sample each camera's frame at a 4x4
fractional grid scaled to its resolution: the JAX server passes the
fractions themselves as pixels of an unnormalized rig, so its 12 probes
all look through the top-left pixel.

    python -m facebook360_dep_tpu_torch.cli.gl_viewer --rig <rig.json> --catalog <fused>/fused.json
"""

from __future__ import annotations

import json
import logging
import os
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..core import camera as cam, png
from ..stream import fusion, native
from . import page

log = logging.getLogger("viewer")


def mesh_buffer(camera: cam.Camera, raw_vtx: bytes, raw_idx: bytes) -> bytes:
    """The world-space mesh buffer of one camera's fused .vtx/.idx: the
    cameraMeshVS displacement (RigScene.cpp:195-218: depth = focal / c,
    position = camera + depth * direction(a, b)) per vertex, in float64 on
    the host, written as float32."""
    verts = np.frombuffer(raw_vtx, np.float32).reshape(-1, 3).astype(np.float64)
    faces = np.frombuffer(raw_idx, np.uint32).reshape(-1, 3)
    camera = camera.to("cpu", torch.float64)
    res = camera.resolution.numpy()
    focal = float(camera.focal[0])
    dirs = cam.ray_dir(camera, torch.from_numpy(verts[:, :2])).numpy()
    depth = focal / np.maximum(verts[:, 2], 1e-9)
    pos = (camera.position.numpy() + dirs * depth[:, None]).astype(np.float32)
    uv = (verts[:, :2] / res).astype(np.float32)
    return struct.pack("<II", len(pos), len(faces)) + pos.tobytes() + uv.tobytes() + faces.astype(np.uint32).tobytes()


def cull_points(camera: cam.Camera, k: int = 3) -> list:
    """Per-camera frustum-culling probes: near-infinity world points at a
    (k+1)x(k+1) fractional grid of the frame minus its corners (isVisible,
    RigScene.cpp:1040-1066); the page culls a camera whose probes all fall
    outside the view frustum."""
    camera = camera.to("cpu", torch.float64)
    res = camera.resolution.numpy()
    fracs = [(xi / k, yi / k) for yi in range(k + 1) for xi in range(k + 1)
             if not ((yi in (0, k)) and (xi in (0, k)))]  # don't check the corners
    rays = cam.ray_dir(camera, torch.from_numpy(np.asarray(fracs, np.float64) * res)).numpy()
    return (camera.position.numpy() + rays * 1e4).tolist()


class SceneData:
    """Decoded-on-demand fused stream with a small readahead cache
    (AsyncLoader/VideoFile role, render/VideoFile.h:25-180)."""

    def __init__(self, rig_path: str, fused_dir: str, num_disks: int = 1, readahead: int = 3,
                 background_fused_dir: str | None = None):
        self.rig = cam.load_rig(rig_path)
        self.fused_dir = fused_dir
        self.num_disks = num_disks
        self.readahead = readahead
        with open(os.path.join(fused_dir, "fused.json")) as f:
            self.catalog = json.load(f)
        self.frames = sorted(self.catalog["frames"].keys())
        # optional separate background layer (RigScene.h backgroundSubframes;
        # drawn depth-tested after the foreground into each subframe)
        self.bg_fused_dir = background_fused_dir
        self.bg_catalog = None
        if background_fused_dir:
            with open(os.path.join(background_fused_dir, "fused.json")) as f:
                self.bg_catalog = json.load(f)
        self._cache: dict = {}
        self._lock = threading.Lock()

    def color_wh(self, frame: str, cam_id: str) -> tuple[int, int]:
        entry = self.catalog["frames"][frame][cam_id]
        if "color_wh" in entry:  # recorded by ConvertToBinary via fusion
            return tuple(entry["color_wh"])
        res = self.rig.camera(self.rig.ids.index(cam_id)).resolution.numpy().astype(np.float64)
        if ".bc7" in entry:
            # BC7 is 1 byte/texel; subframes keep the camera aspect
            texels = entry[".bc7"]["size"]
            w = int(round(np.sqrt(texels * res[0] / res[1]) / 4) * 4)
            return w, texels // max(w, 1)
        texels = entry[".rgba"]["size"] // 4
        w = int(round(np.sqrt(texels * res[0] / res[1])))
        return w, texels // max(w, 1)

    def _cached(self, key, make):
        with self._lock:
            if key in self._cache:
                return self._cache[key]
        data = make()
        with self._lock:
            self._cache[key] = data
            self._evict()
        return data

    def mesh(self, frame: str, cam_id: str, background: bool = False) -> bytes:
        """World-space mesh buffer of one camera (see :func:`mesh_buffer`)."""
        def make():
            fused_dir = self.bg_fused_dir if background else self.fused_dir
            catalog = self.bg_catalog if background else self.catalog
            # the background layer is a single static frame (reference
            # background_disp contract): serve its first frame for any request
            f = sorted(catalog["frames"].keys())[0] if background else frame
            raw_v = fusion.read_fused_entry(fused_dir, catalog, f, cam_id, ".vtx", self.num_disks)
            raw_i = fusion.read_fused_entry(fused_dir, catalog, f, cam_id, ".idx", self.num_disks)
            return mesh_buffer(self.rig.camera(self.rig.ids.index(cam_id)), raw_v, raw_i)

        return self._cached(("bgmesh" if background else "mesh", frame, cam_id), make)

    def color_rgba(self, frame: str, cam_id: str) -> np.ndarray:
        """(H, W, 4) uint8 subframe color decoded from the fused stream."""
        w, h = self.color_wh(frame, cam_id)
        entry = self.catalog["frames"][frame][cam_id]
        if ".bc7" in entry:
            raw = fusion.read_fused_entry(self.fused_dir, self.catalog, frame, cam_id, ".bc7", self.num_disks)
            return native.decompress_bc7(np.frombuffer(raw, np.uint8), w, h)
        raw = fusion.read_fused_entry(self.fused_dir, self.catalog, frame, cam_id, ".rgba", self.num_disks)
        return np.frombuffer(raw, np.uint8).reshape(h, w, 4)

    def color_png(self, frame: str, cam_id: str) -> bytes:
        """The subframe's RGB as PNG (the alpha is left out, as the JAX
        server's three-channel encode leaves it)."""
        return self._cached(("color", frame, cam_id), lambda: png.encode(self.color_rgba(frame, cam_id)[..., :3]))

    def _evict(self):
        # keep ~readahead frames' worth of entries per kind
        limit = max(2 * self.readahead * len(self.rig.ids), 8)
        while len(self._cache) > 2 * limit:
            self._cache.pop(next(iter(self._cache)))

    def scene_json(self) -> bytes:
        cams = []
        for i, cam_id in enumerate(self.rig.ids):
            c = self.rig.camera(i).to("cpu", torch.float64)
            cams.append({
                "id": cam_id,
                "position": c.position.numpy().tolist(),
                "forward": c.forward.numpy().tolist(),
                "cull_points": cull_points(c),
            })
        return json.dumps({
            "frames": self.frames,
            "cameras": cams,
            "readahead": self.readahead,
            "background": self.bg_catalog is not None,
        }).encode()


def make_handler(scene: SceneData):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route to our logger
            log.debug("http: " + fmt, *args)

        def _send(self, data: bytes, ctype: str):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.send_header("Cache-Control", "max-age=3600")
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            try:
                path = self.path.split("?")[0]
                if path == "/":
                    self._send(page.HTML.encode(), "text/html")
                elif path == "/scene.json":
                    self._send(scene.scene_json(), "application/json")
                elif path.startswith("/mesh/"):
                    _, _, frame, rest = path.split("/", 3)
                    self._send(scene.mesh(frame, rest[: -len(".bin")]), "application/octet-stream")
                elif path.startswith("/bgmesh/"):
                    _, _, frame, rest = path.split("/", 3)
                    self._send(scene.mesh(frame, rest[: -len(".bin")], background=True), "application/octet-stream")
                elif path.startswith("/color/"):
                    _, _, frame, rest = path.split("/", 3)
                    self._send(scene.color_png(frame, rest[: -len(".png")]), "image/png")
                else:
                    self.send_error(404)
            except Exception as e:  # noqa: BLE001
                log.warning("request %s failed: %s", self.path, e)
                try:
                    self.send_error(500, str(e))
                except Exception:  # noqa: BLE001 — client hung up
                    pass

    return Handler


def serve(rig_path: str, fused_dir: str, num_disks: int = 1, port: int = 0,
          readahead: int = 3, background_fused_dir: str | None = None) -> ThreadingHTTPServer:
    """Start the viewer server (returns immediately; .serve_forever() to block)."""
    scene = SceneData(rig_path, fused_dir, num_disks, readahead, background_fused_dir=background_fused_dir)
    httpd = ThreadingHTTPServer(("127.0.0.1", port), make_handler(scene))
    log.info(
        "6DoF viewer: http://127.0.0.1:%d/ (%d frames, %d cameras)",
        httpd.server_address[1], len(scene.frames), len(scene.rig.ids),
    )
    return httpd
