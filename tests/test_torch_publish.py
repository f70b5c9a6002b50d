"""The port's publish and playback CLIs (facebook360_dep_tpu_torch/cli/
convert_to_binary.py, view_fused.py) against the JAX package's.

- The port regenerates tests/goldens/publish_mini byte for byte through its
  own generator (below; tests/golden_util.py drives the JAX package's).
- Port and JAX ``convert_to_binary.main`` write equal ``bin/`` and ``fused/``
  trees (bytes; JSON structurally) for every output format, with and
  without foreground masks, at half depth and color scale, with 1 and 4
  threads. The depth resize matches ``cv2.resize(fx=...)``.
- ``view_fused``: the decoded colors and disparities are equal; the
  equirects agree within test_torch_dibr.py's tolerance (alpha on >= 99.5%
  of pixels, color to 1e-4 where both cover), and the written 8-bit PNGs
  to one level on >= 99% of pixels.
"""

import json
import os

import cv2
import numpy as np
import pytest
import torch

import golden_util
from facebook360_dep_tpu.cli import convert_to_binary as jctb
from facebook360_dep_tpu.cli import view_fused as jvf
from facebook360_dep_tpu.core import camera as jcam
from facebook360_dep_tpu.render import dibr as jdibr
from facebook360_dep_tpu_torch.cli import convert_to_binary as tctb
from facebook360_dep_tpu_torch.cli import view_fused as tvf
from facebook360_dep_tpu_torch.core import camera as tcam
from facebook360_dep_tpu_torch.core import io
from facebook360_dep_tpu_torch.render import dibr as tdibr
from facebook360_dep_tpu_torch.render import synthetic as tsyn
from facebook360_dep_tpu_torch.stream import fusion, mesh, native

import torch_parity  # noqa: F401  (thread count)

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens/publish_mini")
SIZE = (96, 72)
FRAMES = ("000000", "000001")
FORMATS = "vtx,idx,bc7,rgba,obj"


def generate_publish_tree(dest: str) -> None:
    """golden_util.generate_publish_tree's run through the port: the same
    fixed disparity and color -> mesh (QEM to 800 triangles) -> BC7 ->
    striped fusion + catalog + rig JSON."""
    w, h = 64, 48
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    disparity = (0.15 + 0.05 * np.sin(xx / 7.0) * np.cos(yy / 5.0)).astype(np.float32)
    color = np.stack([0.5 + 0.4 * np.sin(xx / 3.0), 0.5 + 0.4 * np.cos(yy / 4.0),
                      0.5 + 0.3 * np.sin((xx + yy) / 6.0)], axis=-1).astype(np.float32)
    camera = tcam.make_camera(type_code=tcam.RECTILINEAR, position=[0.1, 0.0, 0.0], rotation=np.eye(3),
                              resolution=[w, h], focal=[0.45 * w, -0.45 * w])
    rig = tcam.Rig(cameras=tcam.stack_cameras([camera]), ids=("cam0",), groups=("",))
    os.makedirs(os.path.join(dest, "rigs"), exist_ok=True)
    tcam.save_rig(os.path.join(dest, "rigs/rig.json"), rig)
    bin_dir = os.path.join(dest, "bin")
    vertexes, faces = tctb.convert_depth(camera, "cam0", disparity, bin_dir, triangles=800, device="cpu")
    out_dir = os.path.join(bin_dir, "cam0")
    mesh.write_vtx_idx(os.path.join(out_dir, "000000.vtx"), os.path.join(out_dir, "000000.idx"), vertexes, faces)
    native.compress_bc7(tctb.gamma_correct_to_rgba8(color, 1.0 / 2.2)).tofile(os.path.join(out_dir, "000000.bc7"))
    fusion.fuse_frames(bin_dir, os.path.join(dest, "fused"), ["cam0"], ["000000"])


def test_port_regenerates_the_golden_tree(tmp_path):
    out = str(tmp_path / "publish_mini")
    generate_publish_tree(out)
    assert golden_util.dir_trees_equal(GOLDEN, out) == []


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    """Three sphere-scene cameras at 96x72, two frames: PNG16 colors, PFM
    disparities with a nearer disk (depth tears) and a NaN patch, and the
    disk's foreground masks."""
    root = str(tmp_path_factory.mktemp("torch_publish"))
    rig = tsyn.make_test_rig(3, SIZE, ring_radius=0.2)
    rig_path = os.path.join(root, "rig.json")
    tcam.save_rig(rig_path, rig)
    colors, gt = tsyn.render_sphere_scene(rig, SIZE, radius=5.0)
    colors, gt = colors.numpy(), gt.numpy()
    yy, xx = np.mgrid[0:SIZE[1], 0:SIZE[0]]
    for f, frame in enumerate(FRAMES):
        disk = (xx - 40 - 4 * f) ** 2 + (yy - 30) ** 2 < 15 ** 2
        rng = np.random.RandomState(f)
        for i, cam_id in enumerate(rig.ids):
            disp = (gt[i] * (1 + 0.002 * rng.rand(*gt[i].shape))).astype(np.float32)
            disp[disk] *= 2.5
            if i == 1:
                disp[5:9, 60:70] = np.nan
            for kind, write, value in (("color", io.write_color, colors[i]), ("disp", io.write_disparity, disp),
                                       ("masks", io.write_mask, disk)):
                os.makedirs(os.path.join(root, kind, cam_id), exist_ok=True)
                ext = {"color": "png", "disp": "pfm", "masks": "png"}[kind]
                args = (value, 16) if kind == "color" else (value,)
                write(os.path.join(root, kind, cam_id, f"{frame}.{ext}"), *args)
    return dict(root=root, rig=rig_path, jax={})


def _argv(project, out, masks, threads):
    root = project["root"]
    argv = ["--rig", project["rig"], "--bin", os.path.join(out, "bin"), "--fused", os.path.join(out, "fused"),
            "--color", os.path.join(root, "color"), "--disparity", os.path.join(root, "disp"),
            "--output_formats", FORMATS, "--depth_scale", "0.5", "--color_scale", "0.5", "--triangles", "400",
            "--first", FRAMES[0], "--last", FRAMES[-1], "--threads", str(threads)]
    return argv + (["--foreground_masks", os.path.join(root, "masks")] if masks else [])


def _jax_tree(project, masks):
    """The JAX CLI's tree (one thread: its process pool would fork this
    test process), made once for each mask setting."""
    if masks not in project["jax"]:
        out = os.path.join(project["root"], f"jax_masks{int(masks)}")
        jctb.main(_argv(project, out, masks, 1))
        project["jax"][masks] = out
    return project["jax"][masks]


@pytest.mark.parametrize("masks", [False, True])
@pytest.mark.parametrize("threads", [1, 4])
def test_convert_to_binary_trees_equal_jax(project, tmp_path, masks, threads):
    want = _jax_tree(project, masks)
    out = str(tmp_path / "port")
    result = tctb.main(_argv(project, out, masks, threads), device="cpu")
    for sub in ("bin", "fused"):
        assert golden_util.dir_trees_equal(os.path.join(want, sub), os.path.join(out, sub)) == []
    assert len(result["tasks"]) == 3 * len(FRAMES)
    assert all(0 < r["faces"] <= 400 for r in result["tasks"])
    with open(os.path.join(out, "fused", "fused.json")) as f:
        catalog = json.load(f)
    for rec in result["tasks"]:
        for ext in (".vtx", ".idx", ".bc7", ".rgba"):
            data = fusion.read_fused_entry(os.path.join(out, "fused"), catalog, rec["frame"], rec["cam_id"], ext)
            assert data == open(os.path.join(out, "bin", rec["cam_id"], rec["frame"] + ext), "rb").read()


@pytest.mark.parametrize("src", [5, 7, 72, 96, 101])
@pytest.mark.parametrize("scale", [0.5, 0.25, 0.3, 0.75])
def test_depth_scale_resize_matches_cv2_fx(src, scale):
    """cv2.resize(img, None, fx=s, fy=s, INTER_NEAREST): round(src * s)
    outputs (half to even), sampled at 1 / s."""
    img = np.arange(src * 3, dtype=np.float32).reshape(src, 3)
    want = cv2.resize(img, None, fx=1.0, fy=scale, interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(img[tctb.nearest_index_scaled(src, scale)], want)
    img = img.T.copy()
    want = cv2.resize(img, None, fx=scale, fy=1.0, interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(img[:, tctb.nearest_index_scaled(src, scale)], want)


@pytest.fixture(scope="module")
def fused(project, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("torch_publish_fused"))
    tctb.main(_argv(project, out, False, 2), device="cpu")
    catalog_path = os.path.join(out, "fused", "fused.json")
    with open(catalog_path) as f:
        return dict(dir=os.path.join(out, "fused"), catalog_path=catalog_path, catalog=json.load(f))


def test_view_fused_decode_and_render_match_jax(project, fused):
    jrig, trig = jcam.load_rig(project["rig"]), tcam.load_rig(project["rig"])
    entry = fused["catalog"]["frames"][FRAMES[0]][trig.ids[0]]
    wh = tvf.color_size(trig, entry)
    assert wh == (48, 36)
    colors, disps = [], []
    for i, cam_id in enumerate(trig.ids):
        tc, td = tvf.decode_camera(fused["dir"], fused["catalog"], FRAMES[0], cam_id, trig.camera(i), 1, wh)
        jc, jd = jvf.decode_camera(fused["dir"], fused["catalog"], FRAMES[0], cam_id, jrig.camera(i), 1, wh)
        assert tc.tobytes() == np.asarray(jc).tobytes() and td.tobytes() == np.asarray(jd).tobytes()
        assert np.isfinite(td).mean() > 0.5
        colors.append(tc)
        disps.append(td)
    colors, disps = np.stack(colors), np.stack(disps)
    tcol, _, ta = tdibr.render_equirect(trig, torch.from_numpy(colors), torch.from_numpy(disps), [0, 0, 0], 64, 32)
    jcol, _, ja = jdibr.render_equirect(jrig, colors, disps, [0.0, 0.0, 0.0], 64, 32)
    tcol, ta, jcol, ja = tcol.numpy(), ta.numpy(), np.asarray(jcol), np.asarray(ja)
    assert ja.mean() > 0.1 and (ta == ja).mean() >= 0.995
    both = ta & ja
    np.testing.assert_allclose(tcol[both], jcol[both], atol=1e-4)


def test_view_fused_main_matches_jax(project, fused, tmp_path):
    argv = ["--rig", project["rig"], "--catalog", fused["catalog_path"], "--width", "64", "--height", "32",
            "--position", "0.02,0,0"]
    records = tvf.main(argv + ["--output", str(tmp_path / "t")], device="cpu")
    jvf.main(argv + ["--output", str(tmp_path / "j")])
    assert [r["frame"] for r in records] == list(FRAMES)
    for rec in records:
        assert rec["finite"] and rec["coverage"] > 0.1 and rec["alpha"].shape == (32, 64)
        got = io.read_png(rec["path"]).astype(np.int64)
        want = io.read_png(str(tmp_path / "j" / (rec["frame"] + ".png"))).astype(np.int64)
        assert got.shape == want.shape == (32, 64, 3)
        assert (np.abs(got - want).max(-1) <= 1).mean() >= 0.99
