"""The port's publish-format modules (facebook360_dep_tpu_torch/stream/mesh.py,
adaptive.py, fusion.py, async_loader.py) against the JAX package's on the
same numpy inputs made from a seed. Tolerance: exact everywhere (bit-equal
vertex grids, byte-equal faces and files), the adaptive face sets of the
executable spec and the native builder compared as sets."""

import json
import os

import numpy as np
import pytest
import torch

import golden_util
from facebook360_dep_tpu.core import camera as jcam
from facebook360_dep_tpu.stream import adaptive as jadaptive
from facebook360_dep_tpu.stream import fusion as jfusion
from facebook360_dep_tpu.stream import mesh as jmesh
from facebook360_dep_tpu_torch.core import camera as tcam
from facebook360_dep_tpu_torch.stream import adaptive as tadaptive
from facebook360_dep_tpu_torch.stream import async_loader, native
from facebook360_dep_tpu_torch.stream import fusion as tfusion
from facebook360_dep_tpu_torch.stream import mesh as tmesh
from test_adaptive_mesh import assert_watertight, smooth_z

import torch_parity  # noqa: F401  (thread count)


def _cameras(res, focal):
    kw = dict(position=[0.1, 0.0, 0.0], rotation=np.eye(3), resolution=res, focal=focal)
    return jcam.make_camera(type_code=jcam.RECTILINEAR, **kw), tcam.make_camera(type_code=tcam.RECTILINEAR, **kw)


def _disparity(h, w, seed):
    """Smooth positive disparity with a NaN patch, zeros (infinite depth),
    a negative value and a tear."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    d = (0.15 + 0.05 * np.sin(xx / 7.0) * np.cos(yy / 5.0) + rng.rand(h, w) * 1e-3).astype(np.float32)
    d[: h // 3] *= 3.0
    d[2:5, 3:7] = np.nan
    d[-1, :4] = 0.0
    d[0, -1] = -0.1
    return d


@pytest.mark.parametrize("hw,res,focal", [((48, 64), [64, 48], [28.8, -28.8]),
                                          ((37, 51), [2048, 1536], [921.6, -921.6]),
                                          ((20, 30), [1000.5, 333.25], [0.3, 0.3])])
def test_equi_error_grid_bit_equal(hw, res, focal):
    """The port's depth = 1 / disparity and its grid equal the JAX
    package's numpy bit for bit (NaN, inf and negative depths included)."""
    disp = _disparity(*hw, seed=hw[0])
    jc, tc = _cameras(res, focal)
    with np.errstate(divide="ignore"):
        depth_np = 1.0 / disp
    depth_t = torch.reciprocal(torch.from_numpy(disp))
    assert depth_t.numpy().tobytes() == depth_np.tobytes()
    want = jmesh.get_vertexes_equi_error(depth_np, jc)
    got = tmesh.get_vertexes_equi_error(depth_t, tc)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("tear_ratio", [0.0, 0.95])
def test_plain_twin_faces_equal_native(seed, tear_ratio):
    rng = np.random.default_rng(seed)
    if seed == 0:  # smooth with a tear
        z = smooth_z(33, 47)
        z[:15] *= 2.0
    elif seed == 1:  # noise with NaN holes
        z = (100 + 30 * rng.random((33, 47))).astype(np.float32)
        z[rng.random(z.shape) < 0.05] = np.nan
    else:  # exact ties
        z = rng.integers(1, 4, (33, 47)).astype(np.float32)
    z = z.astype(np.float32)
    assert tmesh.build_faces_plain(z, tear_ratio).tobytes() == native.build_faces(z, tear_ratio).tobytes()


@pytest.mark.parametrize("wrap,rig_coords", [(False, False), (True, True)])
def test_get_faces_equals_jax(wrap, rig_coords):
    h, w = 21, 33
    disp = np.abs(_disparity(h, w, 5)) + 0.01
    v = jmesh.get_vertexes_equirect(disp, 50.0)
    np.testing.assert_array_equal(tmesh.get_vertexes_equirect(disp, 50.0), v)
    got = tmesh.get_faces(v, w, h, wrap_horizontally=wrap, is_rig_coordinates=rig_coords, tear_ratio=0.9)
    want = jmesh.get_faces(v, w, h, wrap_horizontally=wrap, is_rig_coordinates=rig_coords, tear_ratio=0.9)
    assert got.dtype == np.uint32 and got.tobytes() == want.tobytes()


def test_apply_mask_and_files_equal_jax(tmp_path):
    h, w = 24, 31
    disp = _disparity(h, w, 7)
    jc, tc = _cameras([w, h], [14.0, -14.0])
    with np.errstate(divide="ignore"):
        depth = 1.0 / disp
    v = jmesh.get_vertexes_equi_error(depth, jc)
    faces = jmesh.get_faces(v, w, h, tear_ratio=0.95)
    mask = np.isfinite(depth)
    mask[10:14, 5:9] = False
    (vt, ft), (vj, fj) = tmesh.apply_mask(v, faces, mask), jmesh.apply_mask(v, faces, mask)
    assert vt.tobytes() == vj.tobytes() and ft.dtype == np.uint32 and ft.tobytes() == fj.tobytes()
    assert len(vt) < len(v)
    full = np.ones(h * w, bool)
    assert tmesh.apply_mask(v, faces[:0], full)[1].dtype == np.uint32
    for mod, d in ((tmesh, tmp_path / "t"), (jmesh, tmp_path / "j")):
        os.makedirs(d)
        mod.write_vtx_idx(d / "a.vtx", d / "a.idx", vt, ft)
        mod.write_obj(d / "a.obj", vt[:50], ft[:40], mtl_path="a.mtl")
    assert golden_util.dir_trees_equal(str(tmp_path / "t"), str(tmp_path / "j")) == []
    np.testing.assert_array_equal(tmesh.read_vtx(tmp_path / "t/a.vtx"), vt)
    np.testing.assert_array_equal(tmesh.read_idx(tmp_path / "t/a.idx"), ft)


def _fixture(name):
    """tests/test_adaptive_mesh.py's fixtures: (z, valid, tear_ratio, tol_rel)."""
    if name == "smooth":
        z = smooth_z(129, 193)
        return z, np.ones(z.shape, bool), 0.95, 2e-4
    if name == "tear":
        z = smooth_z(65, 65)
        z[: 65 // 2] *= 3.0
        return z, np.ones(z.shape, bool), 0.95, 1e-3
    if name == "nan":
        z = smooth_z(65, 97)
        valid = np.ones(z.shape, bool)
        z[20, 30] = np.nan
        valid[40:44, 60:70] = False
        return z, valid, 0.95, 1e-3
    if name == "border":
        z = smooth_z(50, 75)
        return z, np.ones(z.shape, bool), 0.95, 1e-3
    if name == "noise":
        z = (100 + 30 * np.random.default_rng(1).random((33, 33))).astype(np.float32)
        return z, np.ones(z.shape, bool), 0.95, 1e-3
    yy, xx = np.mgrid[0:161, 0:161].astype(np.float32)  # mixed LOD steps
    z = 100.0 + np.geomspace(1e-4, 3.0, 161)[None, :] * np.sin(xx / 5.0) * np.cos(yy / 5.0)
    return z, np.ones(z.shape, bool), 0.95, 2e-4


def _sorted(f):
    return f[np.lexsort(f.T[::-1])]


@pytest.mark.parametrize("name", ["smooth", "tear", "nan", "border", "noise", "mixed"])
def test_adaptive_faces_equal_jax_and_spec(name):
    """The port's native builder gives the JAX package's faces byte for byte;
    its numpy spec gives the same face set and step map; the mesh stays
    watertight."""
    z, valid, tear, tol = _fixture(name)
    got = tadaptive.build_adaptive_faces(z, valid, tear_ratio=tear, tol_rel=tol)
    want = jadaptive.build_adaptive_faces(z, valid, tear_ratio=tear, tol_rel=tol)
    assert got.tobytes() == want.tobytes()
    spec = tadaptive.build_adaptive_faces_numpy(z, valid, tear_ratio=tear, tol_rel=tol)
    assert np.array_equal(_sorted(spec), _sorted(got))
    np.testing.assert_array_equal(tadaptive.compute_step_map(z, valid, tear, tol),
                                  jadaptive.compute_step_map(z, valid, tear, tol))
    assert_watertight(got, z, z.shape[1])


def _bin_tree(root, frames, cams, seed=0):
    """Per-(frame, camera) files of the publish tree, some larger than a
    stripe, with color sidecars on one camera."""
    rng = np.random.default_rng(seed)
    sizes = {".vtx": 300_000, ".idx": 250_000, ".bc7": 40_000, ".rgba": 700_000}
    for cam_id in cams:
        os.makedirs(os.path.join(root, cam_id), exist_ok=True)
        for frame in frames:
            for ext, n in sizes.items():
                rng.integers(0, 256, n + int(rng.integers(0, 999)), dtype=np.uint8).tofile(
                    os.path.join(root, cam_id, frame + ext))
            if cam_id == cams[0]:
                with open(os.path.join(root, cam_id, frame + ".meta.json"), "w") as f:
                    json.dump({"color_wh": [64, 48]}, f)


@pytest.mark.parametrize("num_disks", [1, 3])
def test_fusion_trees_equal_jax(tmp_path, num_disks):
    frames, cams = ["000000", "000001"], ["cam0", "cam1", "cam2"]
    exts = (".vtx", ".idx", ".bc7", ".rgba")
    bin_dir = str(tmp_path / "bin")
    _bin_tree(bin_dir, frames, cams, seed=num_disks)
    cat_t = tfusion.fuse_frames(bin_dir, str(tmp_path / "t"), cams, frames, exts, num_disks)
    cat_j = jfusion.fuse_frames(bin_dir, str(tmp_path / "j"), cams, frames, exts, num_disks)
    assert cat_t == cat_j
    assert golden_util.dir_trees_equal(str(tmp_path / "t"), str(tmp_path / "j")) == []
    for g in (0, 123, tfusion.STRIPE_SIZE - 1, tfusion.STRIPE_SIZE * 7 + 5):
        assert tfusion.calc_stripe(g, num_disks) == jfusion.calc_stripe(g, num_disks)
    for frame in frames:
        for cam_id in cams:
            assert cat_t["frames"][frame][cam_id]["offset"] % tfusion.STRIPE_SIZE == 0
            for ext in exts:
                got = tfusion.read_fused_entry(str(tmp_path / "t"), cat_t, frame, cam_id, ext, num_disks)
                assert got == open(os.path.join(bin_dir, cam_id, frame + ext), "rb").read()


@pytest.mark.parametrize("num_disks", [1, 3])
def test_async_reads_equal_sync_reads(tmp_path, num_disks):
    frames, cams = ["000000", "000001", "000002"], ["cam0", "cam1"]
    bin_dir, fused = str(tmp_path / "bin"), str(tmp_path / "fused")
    _bin_tree(bin_dir, frames, cams, seed=10 + num_disks)
    catalog = tfusion.fuse_frames(bin_dir, fused, cams, frames, (".vtx", ".idx", ".bc7"), num_disks)
    paths = [os.path.join(fused, f"fused_{i}.bin") for i in range(num_disks)]
    sync = tfusion.StripedReader(paths)
    asyn = async_loader.AsyncStripedFile(paths)
    try:
        rng = np.random.default_rng(num_disks)
        total = sum(os.path.getsize(p) for p in paths)
        for _ in range(20):
            off = int(rng.integers(0, total - 1))
            n = int(rng.integers(1, min(3 * tfusion.STRIPE_SIZE, total - off)))
            assert asyn.read(off, n) == sync.read(off, n)
    finally:
        asyn.close()
        sync.close()
    loader = async_loader.AsyncFrameLoader(fused, catalog, num_disks=num_disks, readahead=2)
    try:
        for frame in frames:
            got = loader.get(frame)
            assert sorted(got) == sorted((c, e) for c in cams for e in (".vtx", ".idx", ".bc7"))
            for (cam_id, ext), data in got.items():
                assert data == tfusion.read_fused_entry(fused, catalog, frame, cam_id, ext, num_disks)
    finally:
        loader.close()
