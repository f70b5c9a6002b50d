"""The port's 6DoF viewer server (viewer/server.py) over the golden fused
stream: the endpoint checks of tests/test_gl_viewer.py against the port's
server, then its buffers against the JAX server's on the same tree, the
page text, and the cull probes.

Tolerances: mesh positions within 1e-6 relative of the JAX server's (both
compute the per-vertex rays in float64 here, the port on CPU tensors, then
write float32); uv and face indices equal; the color PNG's bytes differ
(the port encodes with its own PNG codec, the JAX server with cv2) but it
decodes to the same RGB.
"""

import json
import os
import struct
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from facebook360_dep_tpu_torch.core import png
from facebook360_dep_tpu_torch.viewer import page as tpage
from facebook360_dep_tpu_torch.viewer import server

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens/publish_mini")
RIG = os.path.join(GOLDEN, "rigs/rig.json")
FUSED = os.path.join(GOLDEN, "fused")
POS_RTOL = 1e-6


def _serve(mod):
    httpd = mod.serve(RIG, FUSED)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def viewer():
    httpd, url = _serve(server)
    yield url
    httpd.shutdown()
    httpd.server_close()


@pytest.fixture(scope="module")
def jax_viewer():
    from facebook360_dep_tpu.viewer import server as jserver

    httpd, url = _serve(jserver)
    yield url
    httpd.shutdown()
    httpd.server_close()


def _get(url):
    return urllib.request.urlopen(url).read()


def _split_mesh(buf):
    nv, nf = struct.unpack_from("<II", buf)
    assert len(buf) == 8 + nv * 20 + nf * 12
    pos = np.frombuffer(buf, np.float32, nv * 3, 8).reshape(-1, 3)
    uv = np.frombuffer(buf, np.float32, nv * 2, 8 + nv * 12).reshape(-1, 2)
    idx = np.frombuffer(buf, np.uint32, nf * 3, 8 + nv * 20)
    return pos, uv, idx


# the endpoint checks of tests/test_gl_viewer.py


def test_scene_metadata(viewer):
    scene = json.load(urllib.request.urlopen(viewer + "/scene.json"))
    assert scene["frames"] == ["000000"]
    assert [c["id"] for c in scene["cameras"]] == ["cam0"]
    assert len(scene["cameras"][0]["position"]) == 3


def test_mesh_buffer(viewer):
    pos, uv, idx = _split_mesh(_get(viewer + "/mesh/000000/cam0.bin"))
    # golden disparity is 0.15 +- 0.05 -> world points 5-10 m out
    r = np.linalg.norm(pos, axis=1)
    assert 3.0 < r.min() and r.max() < 12.0
    assert (uv >= -0.01).all() and (uv <= 1.01).all()
    assert idx.max() < len(pos)


def test_color_png(viewer):
    img = png.decode(_get(viewer + "/color/000000/cam0.png"))
    assert img.shape == (48, 64, 3)
    assert img.std() > 10  # textured content survived BC7 + decode


def test_page_served(viewer):
    html = _get(viewer + "/").decode()
    for needle in (
        "webgl2", "EXT_color_buffer_float", "exp(30.0 * color.a) - 1.0",
        "blendFuncSeparate(gl.SRC_ALPHA, gl.ONE, gl.ONE, gl.ONE)",
        "fade * a.rgb / a.a", "cameraVisible", "DEPTH_COMPONENT24", "bgmesh",
    ):
        assert needle in html, needle
    assert urllib.request.urlopen(viewer + "/scene.json").status == 200


def test_scene_cull_points(viewer):
    scene = json.load(urllib.request.urlopen(viewer + "/scene.json"))
    pts = scene["cameras"][0]["cull_points"]
    # 4x4 fractional grid minus the 4 corners (isVisible, RigScene.cpp:1052)
    assert len(pts) == 12
    p0 = np.asarray(scene["cameras"][0]["position"])
    d = np.linalg.norm(np.asarray(pts) - p0, axis=1)
    assert (d > 9e3).all() and (d < 1.1e4).all()
    assert scene["background"] is False


def test_404(viewer):
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(viewer + "/nope")
    assert e.value.code == 404


# against the JAX server


def test_mesh_buffer_equals_jax(viewer, jax_viewer):
    pos, uv, idx = _split_mesh(_get(viewer + "/mesh/000000/cam0.bin"))
    jpos, juv, jidx = _split_mesh(_get(jax_viewer + "/mesh/000000/cam0.bin"))
    np.testing.assert_allclose(pos, jpos, rtol=POS_RTOL)
    assert np.array_equal(uv, juv) and np.array_equal(idx, jidx)


def test_mesh_buffer_equals_direct_computation():
    """The server's buffer is the port's mesh_buffer of the fused entries."""
    from facebook360_dep_tpu_torch.core import camera as cam
    from facebook360_dep_tpu_torch.stream import fusion

    scene = server.SceneData(RIG, FUSED)
    raw_v = fusion.read_fused_entry(FUSED, scene.catalog, "000000", "cam0", ".vtx")
    raw_i = fusion.read_fused_entry(FUSED, scene.catalog, "000000", "cam0", ".idx")
    assert scene.mesh("000000", "cam0") == server.mesh_buffer(cam.load_rig(RIG).camera(0), raw_v, raw_i)


def test_color_decodes_as_jax(viewer, jax_viewer):
    got = png.decode(_get(viewer + "/color/000000/cam0.png"))
    want = png.decode(_get(jax_viewer + "/color/000000/cam0.png"))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    rgba = server.SceneData(RIG, FUSED).color_rgba("000000", "cam0")
    assert np.array_equal(got, rgba[..., :3])


def test_scene_json_equals_jax_but_cull_points(viewer, jax_viewer):
    got = json.loads(_get(viewer + "/scene.json"))
    want = json.loads(_get(jax_viewer + "/scene.json"))
    for g, w in zip(got["cameras"], want["cameras"]):
        assert set(g) == set(w)
        np.testing.assert_allclose(g["position"], w["position"], rtol=0, atol=1e-12)
        np.testing.assert_allclose(g["forward"], w["forward"], rtol=0, atol=1e-12)
        g.pop("cull_points"), w.pop("cull_points")
    assert got == want


def _probe_spread_deg(scene_json):
    c = scene_json["cameras"][0]
    rays = np.asarray(c["cull_points"]) - np.asarray(c["position"])
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)
    cos = np.clip(rays @ rays.T, -1.0, 1.0)
    return float(np.degrees(np.arccos(cos.min())))


def test_cull_points_span_the_frame(viewer, jax_viewer):
    """The probes sample the frame at fractions 0, 1/3, 2/3, 1 of its width
    and height. The golden camera (64x48, focal 28.8) spans 108.5 degrees
    corner to corner and its probes 97.7; the JAX server's probes pass the
    fractions as pixels, all look through the top-left pixel and span 1.2
    degrees (ROADMAP queue C)."""
    got = _probe_spread_deg(json.loads(_get(viewer + "/scene.json")))
    jax_spread = _probe_spread_deg(json.loads(_get(jax_viewer + "/scene.json")))
    w, h, f = 64.0, 48.0, 28.8
    corner = 2 * np.degrees(np.arctan(np.hypot(w, h) / 2 / f))
    assert 0.8 * corner < got <= corner, (got, corner)
    assert jax_spread < 3.0, jax_spread


def test_page_text_equals_jax():
    from facebook360_dep_tpu.viewer import page as jpage

    assert tpage.HTML == jpage.HTML


def test_server_never_touches_cuda(monkeypatch):
    """Host only by design: building the scene, the mesh and the color
    calls no CUDA function."""
    import torch

    def forbidden(*a, **k):
        raise AssertionError("the viewer touched CUDA")

    monkeypatch.setattr(torch.cuda, "is_available", forbidden)
    monkeypatch.setattr(torch.cuda, "current_device", forbidden)
    scene = server.SceneData(RIG, FUSED)
    assert scene.mesh("000000", "cam0") and scene.color_png("000000", "cam0") and scene.scene_json()


def test_gl_viewer_import_starts_nothing():
    import importlib
    import sys

    sys.modules.pop("facebook360_dep_tpu_torch.cli.gl_viewer", None)
    before = threading.active_count()
    mod = importlib.import_module("facebook360_dep_tpu_torch.cli.gl_viewer")
    assert callable(mod.main) and threading.active_count() == before
